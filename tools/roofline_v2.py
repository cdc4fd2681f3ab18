"""Traffic-complete roofline for the FULL KD train step, against the peaks
of one device kind (utils.flops.PEAKS).

What it counts, beside the v1 bound (conv-only, forward graphs, student
backward modelled as 3x forward): it traces the REAL jitted train step
(teacher fwd + student fwd/bwd + loss + SGD) and walks the whole jaxpr:

  - conv_general_dilated  max(FLOPs/peak, bytes/bw) — this counts the
    actual dgrad/wgrad convs of the backward (they appear as convs in the
    grad jaxpr), not a heuristic multiple;
  - dot_general           same model (loss matmuls, bilinear-resize
    matmuls, hint adapters);
  - large-large `add`     one extra read of the smaller operand: a
    residual add y = conv_out + skip can fuse into the producer's epilogue,
    but the skip stream still must be read;
  - reduce_window / select_and_scatter_add (maxpool fwd/bwd) at bytes
    in+out;
  - everything else       0 — the ideal-fusion assumption. BN moments and
    normalize-applies fuse into producer epilogues / consumer prologues;
    elementwise chains are free. This keeps v2 a LOWER bound, not a model
    of XLA's achieved fusion.

Run (trace only, no device work):
  JAX_PLATFORMS=cpu python tools/roofline_v2.py [--device_kind KIND]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def full_step_bound(batch: int, hw: int, device_kind: str,
                    student_name: str = "deeplabv3plus_mobilenet",
                    scope="classifier", verbose: bool = True):
    """Bound for the bench.py workload (utils.flops.kd_step_bound)."""
    from kd_cheap_conv.utils.flops import device_peaks, kd_step_bound

    peak_flops, hbm_bw = device_peaks(device_kind)
    v1_img_s, bound, acc, _ = kd_step_bound(
        batch, hw, peak_flops=peak_flops, hbm_bw=hbm_bw,
        student_name=student_name, scope=scope)
    if verbose:
        print(f"== roofline v2: full-step traffic-complete bound "
              f"(b{batch}/{hw}², {device_kind}) ==")
        print(f"  convs      {acc['conv_s']*1e3:7.2f} ms   "
              f"n={acc['conv_n']} ({acc['conv_bw_bound_n']} bw-bound)  "
              f"{acc['conv_flops']/1e12:.2f} TFLOP  "
              f"{acc['conv_bytes']/1e9:.1f} GB")
        print(f"  dots       {acc['dot_s']*1e3:7.2f} ms   n={acc['dot_n']}  "
              f"{acc['dot_flops']/1e12:.2f} TFLOP")
        print(f"  residuals  {acc['resid_s']*1e3:7.2f} ms   "
              f"n={acc['resid_n']}  {acc['resid_bytes']/1e9:.1f} GB")
        print(f"  pool       {acc['pool_s']*1e3:7.2f} ms   n={acc['pool_n']}")
        print(f"  TOTAL      {bound*1e3:7.2f} ms  -> "
              f"{batch/bound:.1f} img/s  [v1 conv-only {v1_img_s:.1f}]")
    return bound, acc


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hw", type=int, default=513)
    ap.add_argument("--device_kind", default="NVIDIA H100 80GB HBM3")
    opts = ap.parse_args()
    bound, acc = full_step_bound(opts.batch, opts.hw, opts.device_kind)
    print(json.dumps({
        "device_kind": opts.device_kind,
        "bound_ms": bound * 1e3,
        "roofline_img_s": opts.batch / bound,
    }))
