"""CPU tests of chip_smoke.py's own logic and of the GPU-facing helpers it
relies on (the compile-cache directory, the peaks table), plus one `gpu`
test that runs its GPU-vs-CPU numerics comparison on a card."""

import json
import os
import subprocess
import sys
import types

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from kd_cheap_conv import runtime  # noqa: E402
from kd_cheap_conv.utils.flops import PEAKS, device_peaks  # noqa: E402


def test_refuses_a_cpu_platform():
    with pytest.raises(SystemExit, match="not a GPU"):
        chip_smoke.require_gpu(jax.devices())


def test_refuses_no_devices():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu([])


def test_accepts_a_gpu():
    gpu = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
    chip_smoke.require_gpu([gpu])


@pytest.mark.parametrize("argv,count", [([], 1), (["--devices", "4"], 4)])
def test_last_line_format(argv, count):
    gpu = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([gpu] * count, count)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}
    assert "\n" not in line


def test_four_cards_runs_only_phase_e():
    opts = chip_smoke.parse_args(["--devices", "4"])
    assert chip_smoke.phases(opts) == ("four_cards",)


def test_default_runs_phases_b_to_d_on_one_card():
    opts = chip_smoke.parse_args([])
    assert opts.devices == 1
    assert chip_smoke.phases(opts) == ("main_path", "numerics", "timing")


@pytest.mark.parametrize("visible,want", [(None, "0"), ("3,1", "3")])
def test_one_card_run_restricts_visible_cards(visible, want):
    env = {} if visible is None else {"CUDA_VISIBLE_DEVICES": visible}
    chip_smoke.configure_env(1, env)
    assert env["CUDA_VISIBLE_DEVICES"] == want
    assert env["JAX_PLATFORMS"] == "cuda,cpu"


def test_four_card_run_keeps_visible_cards():
    env = {"CUDA_VISIBLE_DEVICES": "0,1,2,3"}
    chip_smoke.configure_env(4, env)
    assert env["CUDA_VISIBLE_DEVICES"] == "0,1,2,3"


def test_four_cards_phase_on_virtual_cpu_devices(capsys):
    """Phase e's own code on four of the virtual CPU devices at a small
    size: batch split over the mesh, loss and update against one device."""
    chip_smoke.phase_four_cards(jax.devices(), "cpu", hw=33, batch=8,
                                platform="cpu")
    out = capsys.readouterr().out
    assert "4-card loss" in out and "parameter update" in out


def test_check_reports_and_fails_outside_tolerance(capsys):
    chip_smoke.check("x", 1.0005, 1.0, 1e-3)
    assert "limit" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        chip_smoke.check("x", 1.1, 1.0, 1e-3)
    with pytest.raises(AssertionError):
        chip_smoke.check("x", float("nan"), 1.0, 1e-3)


def test_loss_lines_parse():
    out = ("Itrs 1/3: grad_norm=2.0000, hint=0.0000, kd=1.0000, "
           "loss=12.3456, task=3.0000 (3.1 img/s)\nItrs 2/3: grad_norm=nan, "
           "hint=0.0000, kd=nan, loss=nan, task=nan (3.2 img/s)\n")
    losses = chip_smoke._losses(out)
    assert losses[1] == 12.3456 and losses[2] != losses[2]


@pytest.mark.parametrize("env,want", [
    ({}, runtime.CACHE_DIR),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, "/elsewhere/cache"),
])
def test_compile_cache_dir_choice(monkeypatch, env, want):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert runtime.compile_cache_dir() == want


def test_compile_cache_fallback_is_inside_the_checkout():
    assert runtime.CACHE_DIR == os.path.join(REPO, ".jax_cache")


def test_enable_compile_cache_leaves_a_set_directory_alone(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/set/by/env")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == "/set/by/env"
    assert jax.config.jax_compilation_cache_dir == before


def test_peaks_refuse_an_unknown_device_kind():
    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks("cpu")


def test_peaks_h100_row():
    assert device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert all(f > 0 and b > 0 for f, b in PEAKS.values())


def test_package_import_loads_no_pallas_module():
    # no Pallas kernel is left, so no Pallas module may load with the
    # package, nor flax/orbax, which the GPU machine does not have
    code = ("import sys, kd_cheap_conv, kd_cheap_conv.models, "
            "kd_cheap_conv.train, kd_cheap_conv.kd, main; "
            "bad = [m for m in sys.modules if 'pallas' in m "
            "or m.startswith('flax') or m.startswith('orbax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.gpu
def test_kd_step_gpu_matches_cpu(gpu_device):
    """Phase c of chip_smoke.py at a small size: float32 KD step on the GPU
    against the CPU backend, then bf16 against that reference."""
    chip_smoke.phase_numerics(gpu_device, hw=129, batch=2)
