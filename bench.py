#!/usr/bin/env python
"""KD train-step benchmark — prints the device, then ONE JSON line.

Workload (BASELINE.json config #2 shape): ResNet-101 DeepLabV3+ teacher →
MobileNetV2 DeepLabV3+ student with its head cheap-conv-replaced, bf16
compute, 513² crops, batch 16, fixed device-resident inputs (the input
pipeline is not timed). Reports steady-state ms/step and img/s, the first
call's seconds (compile included), peak device memory, and the analytic
roofline bounds of utils.flops against the device's published peaks
(utils.flops.PEAKS: a device that is not in that table is an error, so this
never reports a rate against an assumed peak).

Usage: python bench.py   (env KDCC_BENCH_BATCH, KDCC_BENCH_STUDENT and
KDCC_BENCH_SCOPE select variants, e.g. KDCC_BENCH_STUDENT=
deeplabv3plus_resnet50 KDCC_BENCH_SCOPE=backbone.layer3,backbone.layer4,
classifier for a student whose backbone blocks are replaced).
"""

from __future__ import annotations

import json
import os
import time


def build_workload(*, batch: int, hw: int, num_classes: int = 21,
                   teacher_name: str = "deeplabv3plus_resnet101",
                   student_name: str = "deeplabv3plus_mobilenet",
                   scope="classifier", dtype="bfloat16", seed: int = 0):
    """Teacher, cheap-conv student, optimizer, jitted KD step and one
    random batch (host-S2D packed when both stems accept it, as the data
    pipeline does). Returns a dict with step_fn, init_state, state,
    t_state, batch."""
    import jax.numpy as jnp
    import numpy as np

    from kd_cheap_conv import config, nnx
    from kd_cheap_conv.kd import KDConfig, replace_cheap_convs
    from kd_cheap_conv.kd.replace import CheapConvSpec
    from kd_cheap_conv.models import build_model
    from kd_cheap_conv.ops.conv import s2d_pack, supports_host_s2d
    from kd_cheap_conv.train import make_kd_train_step, make_optimizer

    dt = None if dtype is None else jnp.dtype(dtype)
    teacher = build_model(teacher_name, num_classes=num_classes,
                          output_stride=16, dtype=dt, rngs=nnx.Rngs(seed))
    student = build_model(student_name, num_classes=num_classes,
                          output_stride=16, dtype=dt,
                          rngs=nnx.Rngs(seed + 1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"), scope=scope)
    cfg = KDConfig(temperature=4.0, alpha=0.5, beta=0.5)
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer({"student": params}, lr=1e-3, max_iters=10_000,
                        label_fn=lambda d: (
                            "backbone" if d.startswith("student.backbone")
                            else "head"))
    init_state, step_fn, t_state = make_kd_train_step(student, teacher, tx,
                                                      cfg)
    rng = np.random.RandomState(seed)
    # per-image colour offsets: images that differ in their means, as real
    # ones do (iid noise images all pool to the same ASPP image feature,
    # which leaves the pooling branch's train-mode BN ill-conditioned)
    images = (rng.randn(batch, hw, hw, 3)
              + rng.randn(batch, 1, 1, 3)).astype(np.float32)
    if (config.host_s2d_enabled() and supports_host_s2d(student)
            and supports_host_s2d(teacher)):
        images = s2d_pack(images)
    labels = rng.randint(0, num_classes, (batch, hw, hw)).astype(np.int32)
    return {"teacher": teacher, "student": student, "step_fn": step_fn,
            "init_state": init_state, "state": init_state(),
            "t_state": t_state,
            "batch": (jnp.asarray(images), jnp.asarray(labels))}


def time_steps(w: dict, *, iters: int = 20, warmup: int = 2) -> dict:
    """Compile, warm up, then time `iters` chained steps ending in
    block_until_ready. Updates w["state"]; returns the timings."""
    import jax

    t0 = time.perf_counter()
    state, metrics = w["step_fn"](w["state"], w["batch"], w["t_state"])
    jax.block_until_ready(metrics["loss"])
    first_call_s = time.perf_counter() - t0
    for _ in range(warmup):
        state, metrics = w["step_fn"](state, w["batch"], w["t_state"])
    jax.block_until_ready(metrics["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = w["step_fn"](state, w["batch"], w["t_state"])
    jax.block_until_ready(metrics["loss"])
    dt = time.perf_counter() - t0
    w["state"] = state
    n = w["batch"][0].shape[0]
    return {"first_call_s": first_call_s, "ms_per_step": 1e3 * dt / iters,
            "img_per_s": n * iters / dt, "iters": iters,
            "loss": float(metrics["loss"])}


def main() -> None:
    import jax

    from kd_cheap_conv.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)
    from kd_cheap_conv.utils.flops import device_peaks, kd_step_bound

    enable_compile_cache()
    dev = jax.devices()[0]
    peak_flops, hbm_bw = device_peaks(dev.device_kind)
    card = gpu_name_and_power_limit()
    print(f"device: {dev.platform} {dev.device_kind} x{jax.device_count()}; "
          f"card: {card}")

    batch = int(os.environ.get("KDCC_BENCH_BATCH", "16"))
    student_name = os.environ.get("KDCC_BENCH_STUDENT",
                                  "deeplabv3plus_mobilenet")
    scope = tuple(os.environ.get("KDCC_BENCH_SCOPE", "classifier").split(","))
    hw = 513
    w = build_workload(batch=batch, hw=hw, student_name=student_name,
                       scope=scope)
    t = time_steps(w)
    peak_mem = dev.memory_stats().get("peak_bytes_in_use")

    v1_img_s, bound_s, _, tflops_per_img = kd_step_bound(
        batch, hw, peak_flops=peak_flops, hbm_bw=hbm_bw,
        student_name=student_name, scope=scope)
    roofline_img_s = batch / bound_s
    print(json.dumps({
        "metric": "kd_train_images_per_sec_513",
        "value": t["img_per_s"],
        "unit": "img/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": jax.device_count(), "card": card},
        "extra": {
            "batch": batch,
            "step_ms": t["ms_per_step"],
            "first_call_s": t["first_call_s"],
            "peak_bytes_in_use": peak_mem,
            "tflops_per_img": tflops_per_img,
            "roofline_img_s_memaware": roofline_img_s,
            "roofline_share": t["img_per_s"] / roofline_img_s,
            "roofline_img_s_v1_convonly": v1_img_s,
            "loss": t["loss"],
        },
    }))


if __name__ == "__main__":
    main()
