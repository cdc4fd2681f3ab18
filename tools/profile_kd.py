#!/usr/bin/env python
"""Profile the KD train step on the GPU and reduce the trace to device-op
times.

Runs the bench.py workload (ResNet-101 teacher -> MobileNetV2 student,
bf16), warms it up, traces a few steps with jax.profiler, and reads the
GPU device planes ("/device:GPU:N") of the trace with
jax.profiler.ProfileData; the step's compiled HLO (written beside the
trace as step.hlo.txt) names the scope of each XLA fusion kernel. Per step it reports device busy time (union of
kernel intervals), the idle share of the traced window, the top device
ops, and the device time of the named-scope groups the models set:
`teacher`, `student`, `kd_loss`, `logits_upsample` (the full-resolution
16x upsample of both models' logits), `mnv2_f0_f6` (MobileNetV2
features[0..6], forward and backward) and `optimizer`.

Usage:
  python tools/profile_kd.py [--batch 16] [--hw 513] [--steps 3]
      [--top 30] [--dir TRACE_DIR] [--json OUT.json]
  python tools/profile_kd.py --trace FILE.xplane.pb [--hlo step.hlo.txt]
      [--steps 3]   (reduce a recorded trace; needs no GPU)
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GROUPS = ("teacher", "student", "kd_loss", "logits_upsample", "mnv2_f0_f6",
          "optimizer")


def _stats(ev) -> dict:
    return {k: v for k, v in ev.stats}


_HLO_OP = re.compile(r'^\s*(?:ROOT )?%?([\w.\-]+) = [^\n]*?'
                     r'metadata=\{[^}\n]*?op_name="([^"]+)"', re.M)


def hlo_op_names(hlo_text: str) -> dict:
    """{HLO instruction name: op_name metadata} from compiled HLO text. The
    op_name is the JAX name stack ("jit(f)/jvp(student)/..."), which names
    XLA's generated fusion kernels, whose trace events carry only their
    HLO name."""
    names = {}
    for m in _HLO_OP.finditer(hlo_text):
        names[m.group(1)] = m.group(2)
        # kernels launched from a command buffer (CUDA graph) carry the
        # instruction name with "." spelled "_" as their event name
        names[m.group(1).replace(".", "_")] = m.group(2)
    return names


def device_events(xplane_path: str, op_names: dict | None = None):
    """[(plane, line, name, start_ns, dur_ns, scope)] for every kernel event
    on the GPU device planes. `scope` is the op's name-stack path: the
    event's `name` stat (library calls such as cuDNN convolutions carry
    it, e.g. "jit(step_fn)/jvp(student)/mnv2_f0_f6/conv"), else the
    op_name in `op_names` of its `hlo_op` stat or of its own name (XLA's
    fusion kernels), else the event name."""
    import jax

    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            # derived timelines duplicate the stream kernels
            if line.name in ("XLA Modules", "XLA Ops", "Steps",
                             "XLA TraceMe", "Source"):
                continue
            for ev in line.events:
                st = _stats(ev)
                names = op_names or {}
                scope = str(st.get("name")
                            or names.get(str(st.get("hlo_op")))
                            or names.get(ev.name) or ev.name)
                out.append((plane.name, line.name, ev.name, ev.start_ns,
                            ev.duration_ns, scope))
    return out


def busy_ns(events) -> float:
    """Union of the events' intervals per device plane, summed."""
    total = 0.0
    by_plane = collections.defaultdict(list)
    for plane, _, _, start, dur, _ in events:
        by_plane[plane].append((start, start + dur))
    for ivs in by_plane.values():
        ivs.sort()
        cur_s, cur_e = ivs[0]
        for s, e in ivs[1:]:
            if s > cur_e:
                total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        total += cur_e - cur_s
    return total


def reduce_trace(events, steps: int, top: int) -> dict:
    """Per-step device numbers from the kernel events of `steps` steps."""
    if not events:
        raise RuntimeError("the trace holds no GPU kernel events")
    starts = [e[3] for e in events]
    ends = [e[3] + e[4] for e in events]
    window = max(ends) - min(starts)
    busy = busy_ns(events)
    kernel_sum = sum(e[4] for e in events)
    per_op = collections.Counter()
    for e in events:
        per_op[e[2]] += e[4]
    groups = {g: sum(e[4] for e in events if g in e[5]) for g in GROUPS}
    loss_up = sum(e[4] for e in events
                  if "kd_loss" in e[5] or "logits_upsample" in e[5])
    return {
        "steps": steps,
        "device_busy_ms_per_step": busy / steps / 1e6,
        "kernel_sum_ms_per_step": kernel_sum / steps / 1e6,
        "window_ms_per_step": window / steps / 1e6,
        "idle_share": 1.0 - busy / window,
        "group_ms_per_step": {g: v / steps / 1e6 for g, v in groups.items()},
        "group_share_of_kernel_time": {
            g: v / kernel_sum for g, v in groups.items()},
        "loss_plus_upsample_share": loss_up / kernel_sum,
        "mnv2_f0_f6_share": groups["mnv2_f0_f6"] / kernel_sum,
        "scoped_share": sum(e[4] for e in events
                            if any(g in e[5] for g in GROUPS)) / kernel_sum,
        "top_ops_ms_per_step": [(n, v / steps / 1e6)
                                for n, v in per_op.most_common(top)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--hw", type=int, default=513)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--dir", default=None, help="keep the trace here")
    ap.add_argument("--json", default=None, help="write the reduction here")
    ap.add_argument("--trace", default=None,
                    help="reduce this recorded .xplane.pb instead of running")
    ap.add_argument("--hlo", default=None,
                    help="with --trace: the step's compiled HLO text")
    opts = ap.parse_args(argv)
    if opts.trace:
        names = None
        if opts.hlo:
            with open(opts.hlo) as f:
                names = hlo_op_names(f.read())
        red = reduce_trace(device_events(opts.trace, names), opts.steps,
                           opts.top)
        _report(red, f"recorded trace {opts.trace}", opts.json)
        return 0

    import jax

    from bench import build_workload, time_steps
    from kd_cheap_conv.runtime import (enable_compile_cache,
                                       gpu_name_and_power_limit)

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {dev.platform}")
    card = gpu_name_and_power_limit()
    w = build_workload(batch=opts.batch, hw=opts.hw)
    time_steps(w, iters=2, warmup=1)

    prof_dir = opts.dir or tempfile.mkdtemp(prefix="kdprof_")
    state = w["state"]
    jax.profiler.start_trace(prof_dir)
    for i in range(opts.steps):
        with jax.profiler.StepTraceAnnotation("kd_step", step_num=i):
            state, metrics = w["step_fn"](state, w["batch"], w["t_state"])
        jax.block_until_ready(metrics["loss"])
    jax.profiler.stop_trace()

    paths = sorted(glob.glob(os.path.join(prof_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    hlo = w["step_fn"].lower(state, w["batch"], w["t_state"]).compile()
    hlo_path = os.path.join(prof_dir, "step.hlo.txt")
    with open(hlo_path, "w") as f:
        f.write(hlo.as_text())
    red = reduce_trace(device_events(paths[-1], hlo_op_names(hlo.as_text())),
                       opts.steps, opts.top)
    red.update({"device_kind": dev.device_kind, "card": card,
                "batch": opts.batch, "hw": opts.hw, "trace": paths[-1]})
    _report(red, f"KD step b{opts.batch}/{opts.hw}², {dev.device_kind} "
                 f"({card})", opts.json)
    return 0


def _report(red: dict, title: str, json_path) -> None:
    print(f"=== {title}: {red['steps']} traced steps ===")
    print(f"device busy {red['device_busy_ms_per_step']:.3f} ms/step, "
          f"window {red['window_ms_per_step']:.3f} ms/step, idle share "
          f"{red['idle_share']:.4f}")
    for g, v in red["group_ms_per_step"].items():
        print(f"  {g:>16}: {v:9.3f} ms/step "
              f"({100 * red['group_share_of_kernel_time'][g]:.1f}% of "
              f"kernel time)")
    print(f"  loss+upsample share {red['loss_plus_upsample_share']:.4f}, "
          f"mnv2 f0-f6 share {red['mnv2_f0_f6_share']:.4f}, scoped share "
          f"{red['scoped_share']:.4f}")
    print(f"top {len(red['top_ops_ms_per_step'])} device ops (ms/step):")
    for name, ms in red["top_ops_ms_per_step"]:
        print(f"  {ms:9.3f}  {name[:110]}")
    if json_path:
        with open(json_path, "w") as f:
            json.dump(red, f, indent=1)


if __name__ == "__main__":
    raise SystemExit(main())
