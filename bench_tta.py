#!/usr/bin/env python
"""Config #5 bench (BASELINE.json:12): batched multi-scale+flip TTA student
inference at 513², one XLA program per TTA sweep. Prints the device, then
one JSON line.
"""

from __future__ import annotations

import json
import time


def main() -> None:
    import os

    import jax
    import jax.numpy as jnp
    import numpy as np
    from kd_cheap_conv import nnx
    from kd_cheap_conv.inference import make_tta_predict_fn
    from kd_cheap_conv.kd import replace_cheap_convs
    from kd_cheap_conv.kd.replace import CheapConvSpec
    from kd_cheap_conv.models import build_model
    from kd_cheap_conv.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)

    enable_compile_cache()
    dev = jax.devices()[0]
    card = gpu_name_and_power_limit()
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}; "
          f"card: {card}")
    batch = int(os.environ.get("KDCC_BENCH_BATCH", "8"))
    hw = int(os.environ.get("KDCC_BENCH_HW", "513"))
    dtype = jnp.bfloat16

    student = build_model("deeplabv3plus_mobilenet", num_classes=21,
                          output_stride=16, dtype=dtype, rngs=nnx.Rngs(1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"),
                        scope="classifier")
    student.eval()
    predict = make_tta_predict_fn(student)   # closes over the split state

    rng = np.random.RandomState(0)
    images = jnp.asarray(rng.randn(batch, hw, hw, 3), jnp.float32)

    preds, _ = predict(images)                 # warmup / compile
    jax.block_until_ready(preds)
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        preds, _ = predict(images)
    jax.block_until_ready(preds)
    dt = time.perf_counter() - t0
    img_per_s = batch * iters / dt

    print(json.dumps({
        "metric": "tta_inference_images_per_sec_513",
        "value": img_per_s,
        "unit": "img/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count(), "card": card},
        "extra": {
            "batch": batch,
            "ms_per_image": 1e3 * dt / (iters * batch),
            "scales": 6, "flip": True,
        },
    }))


if __name__ == "__main__":
    main()
