#!/usr/bin/env python
"""Smoke test of the KD training path on NVIDIA GPUs, in one process.

Default (one card; the run is restricted to the first visible card before
JAX starts):
  a. probe     — JAX version, devices, device kind, the card's name and
                 power limit (nvidia-smi), which optional packages import.
                 Exits non-zero unless JAX's first device is a GPU.
  b. main path — main.main() trains the config #2 KD workload (ResNet-101
                 DeepLabV3+ teacher -> MobileNetV2 student with its head
                 cheap-conv-replaced, synthetic data, 513² crops, batch 16,
                 bf16) for 3 steps, validates (eval step + on-device
                 confusion matrix), writes a checkpoint, then resumes from
                 it (--continue_training) for 2 more steps. Checks that every
                 loss is finite and that the step counter continues.
  c. numerics  — one KD step (teacher forward, student forward+backward,
                 optimizer) at 513², batch 2, float32 under matmul precision
                 "highest", on the GPU and on this process's CPU backend,
                 from the same weights and inputs; then the default bf16 step
                 on the GPU against that float32 reference. Compares the
                 loss and the global gradient norm with the tolerances below.
  d. timing    — informational, not a claim: steady-state ms/step and img/s
                 of the phase-b workload with fixed device inputs, the first
                 call's seconds (compile + one step) and peak device memory.

--devices 4 runs the probe and only:
  e. 4 cards   — the data-parallel KD step of main.py's multi-device path
                 (parallel.mesh data mesh, batches placed by
                 data.prefetch_to_device, train.steps KD step) at 513² with
                 global batch 16, in float32 under precision "highest",
                 compared after one step with a one-card run of the same
                 global batch: loss and parameter update. Prints each
                 card's shard shapes. (The exact, float64 form of this
                 comparison is a CPU test: tests/test_parallel.py.)

The last line of stdout is {"ok": true, "device": {"platform": "gpu",
"kind": ..., "count": 1 or 4}}; any failure exits non-zero before it.

Usage: python chip_smoke.py [--devices 4] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time

# Tolerances. The weights are random, and at random initialization this
# step is badly conditioned: the untrained teacher's logits reach O(1e4),
# so float32 rounding moves the softened targets, and the student's
# gradient is dominated by the early depthwise convs behind a chain of
# train-mode BatchNorms. Measured on the CPU at 129², batch 2 (the same
# workload): two float32 evaluations that differ only in summation order
# disagree by 2.8e-2 in the gradient norm, float32 and float64 by 7e-4 in
# the loss; bf16 and float64 by 4.5e-3 in the loss and 0.2-0.44 in the
# gradient norm.
# float32 on both sides under matmul precision "highest" (no TF32): what
# is left is summation order.
F32_LOSS_RTOL = 1e-2
F32_GRAD_RTOL = 1e-1
# bf16 activations and weights (8 significant bits) against float32: the
# loss within 5%. The bf16 gradient norm at random init is not a stable
# quantity (it doubled at 65² on the CPU), so it is held only to finite
# and within a factor of 4.
BF16_LOSS_RTOL = 5e-2
BF16_GRAD_RTOL = 3.0
# Four cards vs one, both float32 under "highest": summation order only.
# On 2-8 virtual CPU devices the same step agrees to 2e-6 in the loss and
# 1.5e-2 in the parameter update at 33² crops.
MESH_LOSS_RTOL = 1e-3
MESH_UPDATE_RTOL = 5e-2

PHASES = ("main_path", "numerics", "timing")
FOUR_CARD_PHASES = ("four_cards",)

MAIN_ARGS = [
    "--dataset", "synthetic", "--kd",
    "--teacher_model", "deeplabv3plus_resnet101",
    "--model", "deeplabv3plus_mobilenet", "--replace_scope", "classifier",
    "--crop_size", "513", "--batch_size", "16", "--bf16",
    "--val_batch_size", "8", "--print_interval", "1", "--num_workers", "8",
]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card data-parallel check")
    ap.add_argument("--out", default=None,
                    help="directory for checkpoints (default: a temporary "
                         "directory, removed at the end)")
    return ap.parse_args(argv)


def phases(opts) -> tuple[str, ...]:
    """The phases after the probe, in order."""
    return FOUR_CARD_PHASES if opts.devices == 4 else PHASES


def configure_env(devices: int, environ=os.environ) -> None:
    """Before JAX starts: the CUDA backend beside the CPU one (phase c
    computes its reference on the CPU backend), and for the one-card run
    exactly one visible card."""
    environ["JAX_PLATFORMS"] = "cuda,cpu"
    if devices == 1:
        visible = environ.get("CUDA_VISIBLE_DEVICES", "")
        environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] or "0"


def require_gpu(devices) -> None:
    if not devices or devices[0].platform != "gpu":
        platform = devices[0].platform if devices else "none"
        raise SystemExit(f"chip_smoke: JAX's first device is {platform!r}, "
                         f"not a GPU; refusing to run")


def result_line(devices, count: int) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": count}})


def _importable(name: str) -> bool:
    parts = name.split(".")
    return all(importlib.util.find_spec(".".join(parts[:i + 1])) is not None
               for i in range(len(parts)))


def rel_diff(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def check(name: str, got: float, want: float, rtol: float) -> None:
    d = rel_diff(got, want)
    ok = math.isfinite(got) and math.isfinite(want) and d <= rtol
    print(f"  {name}: {got!r} vs reference {want!r}: relative difference "
          f"{d:.3e} (limit {rtol:.1e}) {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name} outside tolerance")


def phase_probe(card: str):
    import jax

    print(f"jax {jax.__version__}")
    devices = jax.devices()
    print(f"devices: {devices}")
    require_gpu(devices)
    print(f"device_kind: {devices[0].device_kind}")
    print(f"card (name, power limit): {card}")
    print("imports: " + " ".join(
        f"{m}={'ok' if _importable(m) else 'missing'}"
        for m in ("flax", "optax", "orbax.checkpoint", "PIL")))
    return devices


class _Tee:
    """stdout that is also recorded."""

    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, s):
        self.parts.append(s)
        return self.stream.write(s)

    def flush(self):
        self.stream.flush()


def _run_main(args) -> str:
    import main

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = main.main(args)
    if rc != 0:
        raise RuntimeError(f"main.main returned {rc}")
    return "".join(tee.parts)


def _losses(out: str) -> dict[int, float]:
    return {int(i): float(v)
            for i, v in re.findall(r"Itrs (\d+)/\d+:.*? loss=([^,\s]+)",
                                   out)}


def phase_main_path(out_dir: str) -> None:
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    args = MAIN_ARGS + ["--ckpt_dir", ckpt_dir]
    out = _run_main(args + ["--total_itrs", "3", "--val_interval", "3"])
    losses = _losses(out)
    if sorted(losses) != [1, 2, 3]:
        raise AssertionError(f"expected steps 1-3, got {sorted(losses)}")
    if "Mean IoU" not in out:
        raise AssertionError("validation did not run")
    ckpt = os.path.join(ckpt_dir,
                        "latest_deeplabv3plus_mobilenet_synthetic_os16")
    if not os.path.isdir(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    out2 = _run_main(args + ["--total_itrs", "5", "--val_interval", "5",
                             "--ckpt", ckpt, "--continue_training"])
    if "Continue training from itrs=3" not in out2:
        raise AssertionError("resume did not start from step 3")
    resumed = _losses(out2)
    if sorted(resumed) != [4, 5]:
        raise AssertionError(f"expected steps 4-5, got {sorted(resumed)}")
    losses.update(resumed)
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if bad:
        raise AssertionError(f"non-finite losses {bad}")
    print(f"main path: losses by step {losses}; resumed at step 4")


def kd_steps(devices, *, hw: int, batch: int, dtype, precision):
    """Build the bench workload on devices[0], then run one KD step on each
    of `devices` from copies of the same weights and inputs. Returns
    [(loss, grad_norm)] per device."""
    import jax
    import numpy as np

    from bench import build_workload

    out = []
    with jax.default_matmul_precision(precision):
        with jax.default_device(devices[0]):
            w = build_workload(batch=batch, hw=hw, dtype=dtype)
        host = jax.tree.map(np.asarray, (w["state"], w["batch"],
                                         w["t_state"]))
        for d in devices:           # fresh buffers: the step donates state
            _, m = w["step_fn"](*jax.device_put(host, d))
            out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def phase_numerics(gpu, *, hw: int = 513, batch: int = 2) -> None:
    import jax

    cpu = jax.devices("cpu")[0]
    print(f"numerics: one KD step at {hw}², batch {batch}, reference on "
          f"{cpu.platform}")
    ref, f32 = kd_steps([cpu, gpu], hw=hw, batch=batch, dtype=None,
                        precision="highest")
    check("f32 GPU loss", f32[0], ref[0], F32_LOSS_RTOL)
    check("f32 GPU grad norm", f32[1], ref[1], F32_GRAD_RTOL)
    (bf16,) = kd_steps([gpu], hw=hw, batch=batch, dtype="bfloat16",
                       precision="default")
    check("bf16 GPU loss", bf16[0], ref[0], BF16_LOSS_RTOL)
    check("bf16 GPU grad norm", bf16[1], ref[1], BF16_GRAD_RTOL)


def phase_timing(gpu, card: str, *, hw: int = 513, batch: int = 16) -> None:
    from bench import build_workload, time_steps

    w = build_workload(batch=batch, hw=hw)
    t = time_steps(w, iters=20)
    peak = (gpu.memory_stats() or {}).get("peak_bytes_in_use")
    print(f"timing ({gpu.device_kind}; card {card}): KD step "
          f"b{batch}/{hw}² bf16 "
          f"{t['ms_per_step']!r} ms/step, {t['img_per_s']!r} img/s over "
          f"{t['iters']} steps; first call (compile + 1 step) "
          f"{t['first_call_s']!r} s; process peak_bytes_in_use {peak}")


def phase_four_cards(devices, card: str, *, hw: int = 513,
                     batch: int = 16, platform: str = "gpu") -> None:
    import jax
    import numpy as np

    from bench import build_workload
    from kd_cheap_conv.data import prefetch_to_device
    from kd_cheap_conv.parallel import make_mesh

    devs = devices[:4]
    if len(devs) < 4 or any(d.platform != platform for d in devs):
        raise SystemExit(f"--devices 4 needs four GPUs, JAX has {devices}")
    mesh = make_mesh(devs)
    print(f"four cards ({card.splitlines()[0]} ...): mesh {mesh.shape}")
    with jax.default_matmul_precision("highest"):
        w = build_workload(batch=batch, hw=hw, dtype=None)
        p0 = jax.tree.map(np.asarray, w["state"].params)
        host_batch = jax.tree.map(np.asarray, w["batch"])
        one_state, m1 = w["step_fn"](w["state"], w["batch"], w["t_state"])
        batch4 = next(prefetch_to_device(iter([host_batch]), mesh=mesh))
        four_state, m4 = w["step_fn"](w["init_state"](), batch4,
                                      w["t_state"])
        jax.block_until_ready((one_state, four_state))
    for name, arr in (("images", batch4[0]), ("labels", batch4[1])):
        shards = {str(s.device): s.data.shape for s in arr.addressable_shards}
        print(f"  {name} {arr.shape}: {shards}")
        if len(shards) != 4 or any(v[0] != arr.shape[0] // 4
                                   for v in shards.values()):
            raise AssertionError(f"{name} is not split over 4 cards")
    leaf = jax.tree.leaves(four_state.params)[0]
    print(f"  first param {leaf.shape}: "
          f"{ {str(s.device): s.data.shape for s in leaf.addressable_shards} }")
    check("4-card loss", float(m4["loss"]), float(m1["loss"]),
          MESH_LOSS_RTOL)

    def delta(state):
        return np.concatenate([
            (np.asarray(a, np.float64) - b).ravel() for a, b in zip(
                jax.tree.leaves(state.params), jax.tree.leaves(p0))])

    d1, d4 = delta(one_state), delta(four_state)
    upd = float(np.linalg.norm(d4 - d1) / np.linalg.norm(d1))
    print(f"  parameter update: |d4 - d1| / |d1| = {upd:.3e} "
          f"(limit {MESH_UPDATE_RTOL:.1e})")
    if not upd <= MESH_UPDATE_RTOL:
        raise AssertionError("4-card parameter update differs")


def main(argv=None) -> int:
    opts = parse_args(argv)
    configure_env(opts.devices)
    from kd_cheap_conv.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)

    card = gpu_name_and_power_limit()
    print(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    devices = phase_probe(card)
    out_dir = opts.out or tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        for name in phases(opts):
            t0 = time.perf_counter()
            print(f"== phase {name}", flush=True)
            if name == "main_path":
                phase_main_path(out_dir)
            elif name == "numerics":
                phase_numerics(devices[0])
            elif name == "timing":
                phase_timing(devices[0], card)
            else:
                phase_four_cards(devices, card)
            print(f"== phase {name} done in {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        if opts.out is None:
            shutil.rmtree(out_dir, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(f"card: {card}")
    print(result_line(devices, 4 if opts.devices == 4 else 1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
