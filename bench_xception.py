#!/usr/bin/env python
"""Config #3 bench (BASELINE.json:9): Xception-65 teacher -> Xception-65
student with its head cheap-conv-replaced, Cityscapes-shaped 769² crops,
19 classes, batch 4, bf16. Prints the device, then one JSON line; the
roofline is taken against the device's published peaks (utils.flops.PEAKS,
an unknown device is an error).

769 is prime: exercises the class-major resize and the loss on
non-divisible shapes.
"""

from __future__ import annotations

import json


def main() -> None:
    import jax

    from bench import build_workload, time_steps
    from kd_cheap_conv.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)
    from kd_cheap_conv.utils.flops import device_peaks, kd_step_bound

    enable_compile_cache()
    dev = jax.devices()[0]
    peak_flops, hbm_bw = device_peaks(dev.device_kind)
    card = gpu_name_and_power_limit()
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}; "
          f"card: {card}")

    batch, hw, ncls = 4, 769, 19
    name = "deeplabv3plus_xception"
    w = build_workload(batch=batch, hw=hw, num_classes=ncls,
                       teacher_name=name, student_name=name)
    t = time_steps(w, iters=10)
    v1_img_s, bound_s, _, _ = kd_step_bound(
        batch, hw, peak_flops=peak_flops, hbm_bw=hbm_bw, teacher_name=name,
        student_name=name, num_classes=ncls)
    roofline = batch / bound_s
    print(json.dumps({
        "metric": "kd_train_images_per_sec_769_xception",
        "value": t["img_per_s"],
        "unit": "img/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count(), "card": card},
        "extra": {
            "batch": batch,
            "step_ms": t["ms_per_step"],
            "first_call_s": t["first_call_s"],
            "peak_bytes_in_use": dev.memory_stats().get("peak_bytes_in_use"),
            "roofline_img_s_memaware": roofline,
            "roofline_share": t["img_per_s"] / roofline,
            "roofline_img_s_v1_convonly": v1_img_s,
            "loss": t["loss"],
        },
    }))


if __name__ == "__main__":
    main()
