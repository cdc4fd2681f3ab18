"""Roofline-bound integrity.

  1. the walker REJECTS any trace containing a pallas_call (a hand-written
     kernel hides its convs/dots from the walker);
  2. (slow) at the bench shape, v2 bound img/s <= v1 conv-only img/s — a
     bound that only adds traffic terms can never be faster.
"""

import jax
import jax.numpy as jnp
import pytest

from kd_cheap_conv.utils.flops import (device_peaks,
                                       full_step_roofline_seconds,
                                       kd_step_bound)

H100 = "NVIDIA H100 80GB HBM3"


def test_walker_rejects_pallas_call():
    import jax.experimental.pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    def fn(x):
        return pl.pallas_call(
            kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True)(x)

    x = jnp.ones((8, 128), jnp.float32)
    peak, bw = device_peaks(H100)
    with pytest.raises(RuntimeError, match="cannot see inside"):
        full_step_roofline_seconds(fn, x, peak_flops=peak, hbm_bw=bw)


@pytest.mark.slow
def test_v2_le_v1_at_bench_shape():
    """At the contract workload (b16/513²) the traffic-complete bound can
    never exceed the conv-only bound."""
    peak, bw = device_peaks(H100)
    v1_img_s, bound_s, acc, _ = kd_step_bound(16, 513, peak_flops=peak,
                                              hbm_bw=bw)
    v2_img_s = 16.0 / bound_s
    assert v2_img_s <= v1_img_s + 1e-6
    assert acc["pallas_n"] == 0
    # the conv term is the dominant stream and must agree with v1's within
    # the heuristic's slack (v1 models the student bwd as 3x fwd)
    assert acc["conv_s"] > 0.5 * bound_s
