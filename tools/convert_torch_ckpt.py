#!/usr/bin/env python
"""Convert a reference-format torch checkpoint (.pth) into this framework's
Orbax layout (SURVEY.md §5.4: '.pth import path for teacher weights and
parity tests').

Usage:
  python tools/convert_torch_ckpt.py --pth best_deeplabv3plus_mobilenet_voc_os16.pth \
      --model deeplabv3plus_mobilenet --num_classes 21 --output_stride 16 \
      --out checkpoints/imported_teacher

Reads {model_state, cur_itrs?, best_score?} (or a bare state dict), maps
OIHW->HWIO etc. onto the NNX model, and saves the five-key Orbax checkpoint.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--pth", required=True)
    p.add_argument("--model", default="deeplabv3plus_mobilenet")
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--output_stride", type=int, default=16)
    p.add_argument("--out", required=True)
    p.add_argument("--strict", action="store_true")
    p.add_argument("--unsafe", action="store_true",
                   help="allow full-pickle torch.load for non-state-dict "
                        "blobs (executes arbitrary pickle code)")
    opts = p.parse_args(argv)

    import torch
    from kd_cheap_conv import nnx

    from kd_cheap_conv.models import build_model
    from kd_cheap_conv.train.checkpoint import (
        import_torch_state_dict, save_checkpoint)

    try:
        blob = torch.load(opts.pth, map_location="cpu", weights_only=True)
    except Exception as e:
        if not opts.unsafe:
            raise SystemExit(
                f"weights-only load failed ({e}); rerun with --unsafe to "
                "allow full pickle execution on a TRUSTED file")
        blob = torch.load(opts.pth, map_location="cpu", weights_only=False)
    sd = blob.get("model_state", blob) if isinstance(blob, dict) else blob
    # DataParallel checkpoints prefix keys with 'module.'
    sd = {k.removeprefix("module."): v for k, v in sd.items()}

    model = build_model(opts.model, opts.num_classes, opts.output_stride)
    n, missing = import_torch_state_dict(model, sd, strict=opts.strict)
    print(f"mapped {n} tensors; {len(missing)} unmapped")
    for m in missing[:10]:
        print("  unmapped:", m)

    _, params, rest = nnx.split(model, nnx.Param, ...)
    cur = int(blob.get("cur_itrs", 0)) if isinstance(blob, dict) else 0
    best = float(blob.get("best_score", 0.0)) if isinstance(blob, dict) else 0.0
    save_checkpoint(opts.out, cur_itrs=cur, params=params, rest=rest,
                    opt_state={}, best_score=best)
    print(f"wrote Orbax checkpoint to {opts.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
