"""The trace reduction of tools/profile_kd.py, checked on hand-made kernel
events (device busy time, idle share, scope groups) and on compiled HLO
(fusion kernel -> named scope)."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))

from profile_kd import busy_ns, hlo_op_names, reduce_trace  # noqa: E402

G = "/device:GPU:0"


def _ev(start, dur, scope, name="k"):
    return (G, "Stream #1", name, start, dur, scope)


def test_busy_is_the_union_of_intervals():
    evs = [_ev(0, 10, "a"), _ev(5, 10, "b"), _ev(30, 5, "c")]
    assert busy_ns(evs) == 20


def test_reduce_trace_groups_and_idle_share():
    evs = [_ev(0, 40, "jit(step_fn)/teacher/conv"),
           _ev(40, 30, "jit(step_fn)/transpose(jvp(student))/mnv2_f0_f6/c"),
           _ev(70, 10, "jit(step_fn)/jvp(kd_loss)/exp"),
           _ev(80, 10, "jit(step_fn)/jvp(student)/logits_upsample/dot"),
           _ev(100, 10, "fusion_without_scope")]
    red = reduce_trace(evs, steps=1, top=3)
    assert red["window_ms_per_step"] == pytest.approx(110e-6)
    assert red["idle_share"] == pytest.approx(10 / 110)
    assert red["group_share_of_kernel_time"]["teacher"] == pytest.approx(0.4)
    assert red["mnv2_f0_f6_share"] == pytest.approx(0.3)
    assert red["loss_plus_upsample_share"] == pytest.approx(0.2)
    assert red["scoped_share"] == pytest.approx(0.9)


def test_reduce_trace_refuses_an_empty_trace():
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        reduce_trace([], steps=1, top=1)


def test_hlo_names_map_fusions_to_scopes():
    def f(x):
        with jax.named_scope("kd_loss"):
            return jnp.sum(jnp.exp(x) * 2.0)

    text = jax.jit(f).lower(jnp.ones((8, 8))).compile().as_text()
    names = hlo_op_names(text)
    assert any("fusion" in k and "kd_loss" in v for k, v in names.items())
