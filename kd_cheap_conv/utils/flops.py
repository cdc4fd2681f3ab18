"""Analytic conv-FLOP counting and roofline bounds.

Counts 2*MAC FLOPs for every `conv_general_dilated` in the jaxpr of a
model's forward (and scales fwd+bwd by the standard 3x for the student).
Traced with jax.make_jaxpr — counts the traced graph, not a hand model.
The walkers are hardware-neutral; the peak rates they divide by come from
`PEAKS`, keyed by the device's `device_kind`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import nnx

# Published dense peaks, keyed by jax `Device.device_kind`:
# (bf16 tensor-core FLOP/s, device-memory bytes/s). H100 SXM: NVIDIA's data
# sheet, 989 TFLOP/s dense bf16 and 80 GB HBM3 at 3.35 TB/s, at the full
# 700 W power limit.
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def device_peaks(device_kind: str) -> tuple[float, float]:
    """(peak FLOP/s, peak bytes/s) of `device_kind`. A device that is not
    in `PEAKS` is an error: there is no default peak."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add a "
            f"row with its source to utils.flops.PEAKS") from None


def conv_fwd_flops(model: nnx.Module, hw: int, *, batch: int = 1) -> float:
    """Total conv FLOPs (2*MACs) of one forward at (batch, hw, hw, 3)."""
    model_was = _set_eval(model)
    graphdef, state = nnx.split(model)

    def fwd(state, x):
        return nnx.merge(graphdef, state)(x)

    x = jnp.zeros((batch, hw, hw, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(fwd)(state, x)
    total = _count(jaxpr.jaxpr)
    _restore(model, model_was)
    return total


def _count(jaxpr) -> float:
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            rhs = eqn.invars[1].aval
            out = eqn.outvars[0].aval
            dn = eqn.params["dimension_numbers"]
            rs = dn.rhs_spec
            cin_per_group = rhs.shape[rs[1]]
            kernel_spatial = float(np.prod([rhs.shape[i] for i in rs[2:]]))
            out_elems = float(np.prod(out.shape))  # N*H*W*Cout
            total += 2.0 * out_elems * kernel_spatial * cin_per_group
        # recurse into sub-jaxprs (pjit/custom_vjp/scan bodies)
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                total += _count(sub)
            if isinstance(v, (list, tuple)):
                for vv in v:
                    sub = getattr(vv, "jaxpr", None)
                    if sub is not None:
                        total += _count(sub)
    return total


def _set_eval(model) -> bool:
    training = any(not m.use_running_average
                   for _, m in nnx.iter_modules(model)
                   if isinstance(m, nnx.BatchNorm))
    model.eval()
    return training


def _restore(model, training: bool) -> None:
    if training:
        model.train()


def kd_step_flops_per_image(teacher: nnx.Module, student: nnx.Module,
                            hw: int) -> float:
    """Teacher fwd + student fwd/bwd (≈3x fwd) conv FLOPs per image
    (BASELINE.md worksheet)."""
    t = conv_fwd_flops(teacher, hw)
    s = conv_fwd_flops(student, hw)
    return t + 3.0 * s


# ---------------------------------------------------------------------------
# memory-aware roofline computed from the real conv shapes
# ---------------------------------------------------------------------------

def _conv_roofline_seconds(jaxpr, *, peak_flops: float, hbm_bw: float,
                           itemsize: int) -> float:
    """Sum over convs of max(compute-time, memory-time): each conv reads its
    input + kernel and writes its output at least once; depthwise/grouped
    convs have low arithmetic intensity and are bandwidth-bound."""
    total = 0.0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
            out = eqn.outvars[0].aval
            dn = eqn.params["dimension_numbers"]
            rs = dn.rhs_spec
            cin_per_group = rhs.shape[rs[1]]
            k_spatial = float(np.prod([rhs.shape[i] for i in rs[2:]]))
            flops = 2.0 * float(np.prod(out.shape)) * k_spatial * cin_per_group
            bytes_ = (float(np.prod(lhs.shape)) + float(np.prod(out.shape))
                      ) * itemsize + float(np.prod(rhs.shape)) * 4
            total += max(flops / peak_flops, bytes_ / hbm_bw)
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                total += _conv_roofline_seconds(
                    sub, peak_flops=peak_flops, hbm_bw=hbm_bw,
                    itemsize=itemsize)
            if isinstance(v, (list, tuple)):
                for vv in v:
                    sub = getattr(vv, "jaxpr", None)
                    if sub is not None:
                        total += _conv_roofline_seconds(
                            sub, peak_flops=peak_flops, hbm_bw=hbm_bw,
                            itemsize=itemsize)
    return total


def conv_roofline_seconds(model: nnx.Module, hw: int, *, batch: int = 1,
                          peak_flops: float, hbm_bw: float,
                          itemsize: int = 2) -> float:
    """Lower-bound wall time of one forward at (batch, hw, hw, 3):
    per-conv max(FLOPs/peak, bytes/bandwidth)."""
    model_was = _set_eval(model)
    graphdef, state = nnx.split(model)

    def fwd(state, x):
        return nnx.merge(graphdef, state)(x)

    x = jnp.zeros((batch, hw, hw, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(fwd)(state, x)
    secs = _conv_roofline_seconds(jaxpr.jaxpr, peak_flops=peak_flops,
                                  hbm_bw=hbm_bw, itemsize=itemsize)
    _restore(model, model_was)
    return secs


def kd_step_roofline_img_per_s(teacher: nnx.Module, student: nnx.Module,
                               hw: int, *, batch: int = 8, peak_flops: float,
                               hbm_bw: float) -> float:
    """Analytic images/sec upper bound for the KD step on one device:
    teacher fwd + 3x student fwd (bwd ~ 2x fwd in both FLOPs and bytes),
    memory-aware per conv. Ignores BN/loss/optimizer — a true upper bound."""
    t = conv_roofline_seconds(teacher, hw, batch=batch,
                              peak_flops=peak_flops, hbm_bw=hbm_bw)
    s = conv_roofline_seconds(student, hw, batch=batch,
                              peak_flops=peak_flops, hbm_bw=hbm_bw)
    return batch / (t + 3.0 * s)


# ---------------------------------------------------------------------------
# roofline v2: traffic-complete bound over the REAL train-step jaxpr
# (breakdown CLI in tools/roofline_v2.py)
# ---------------------------------------------------------------------------

_LARGE_ADD_BYTES = 4 * 1024 * 1024


def _aval_bytes(aval) -> float:
    return float(np.prod(aval.shape)) * aval.dtype.itemsize


def _walk_v2(jaxpr, acc, *, peak_flops: float, hbm_bw: float):
    """Accumulate per-category lower-bound seconds over a jaxpr (recursing
    into pjit/custom_vjp/scan bodies). Cost model — see tools/roofline_v2.py
    docstring: convs/dots at max(FLOPs/peak, bytes/bw); residual-style
    large+large adds at one extra read of the smaller operand; maxpool
    fwd/bwd at bytes in+out; everything else free (ideal fusion), keeping
    this a LOWER bound rather than a model of XLA's achieved fusion."""
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "pallas_call":
            # A hand-written kernel hides convs/dots inside its body, and
            # counting the body once at block shapes (no grid multiplier)
            # would be silently wrong. Count it so
            # full_step_roofline_seconds can reject the trace; never recurse.
            acc["pallas_n"] = acc.get("pallas_n", 0) + 1
            continue
        if name in ("scan", "while"):
            # Cost the body ONCE per trip: scan scales by its static length;
            # while has no static trip count, so count one iteration and
            # flag the undercount.
            body = eqn.params.get("jaxpr") or eqn.params.get("body_jaxpr")
            if body is not None:
                sub_acc = {k: (0.0 if isinstance(v, float) else 0)
                           for k, v in acc.items()}
                _walk_v2(body.jaxpr, sub_acc, peak_flops=peak_flops,
                         hbm_bw=hbm_bw)
                trips = eqn.params.get("length", 1) if name == "scan" else 1
                for k, v in sub_acc.items():
                    acc[k] = acc.get(k, type(v)(0)) + v * trips
                if name == "while":
                    acc["while_n"] = acc.get("while_n", 0) + 1
            continue
        if name == "conv_general_dilated":
            lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
            out = eqn.outvars[0].aval
            rs = eqn.params["dimension_numbers"].rhs_spec
            cin_per_group = rhs.shape[rs[1]]
            k_spatial = float(np.prod([rhs.shape[i] for i in rs[2:]]))
            flops = (2.0 * float(np.prod(out.shape)) * k_spatial
                     * cin_per_group)
            byt = _aval_bytes(lhs) + _aval_bytes(out) + _aval_bytes(rhs)
            acc["conv_s"] += max(flops / peak_flops, byt / hbm_bw)
            acc["conv_flops"] += flops
            acc["conv_bytes"] += byt
            acc["conv_n"] += 1
            acc["conv_bw_bound_n"] += int(byt / hbm_bw > flops / peak_flops)
        elif name == "dot_general":
            lhs, rhs = eqn.invars[0].aval, eqn.invars[1].aval
            out = eqn.outvars[0].aval
            ((lc, _), __) = eqn.params["dimension_numbers"]
            k = float(np.prod([lhs.shape[i] for i in lc]))
            flops = 2.0 * float(np.prod(out.shape)) * k
            byt = _aval_bytes(lhs) + _aval_bytes(rhs) + _aval_bytes(out)
            acc["dot_s"] += max(flops / peak_flops, byt / hbm_bw)
            acc["dot_flops"] += flops
            acc["dot_n"] += 1
        elif name in ("add", "sub"):
            avals = [v.aval for v in eqn.invars if hasattr(v, "aval")]
            if (len(avals) == 2
                    and all(_aval_bytes(a) >= _LARGE_ADD_BYTES
                            for a in avals)):
                byt = min(_aval_bytes(a) for a in avals)
                acc["resid_s"] += byt / hbm_bw
                acc["resid_bytes"] += byt
                acc["resid_n"] += 1
        elif name in ("reduce_window_max", "reduce_window",
                      "select_and_scatter_add"):
            byt = sum(_aval_bytes(v.aval) for v in eqn.invars
                      if hasattr(v, "aval"))
            byt += sum(_aval_bytes(v.aval) for v in eqn.outvars)
            acc["pool_s"] += byt / hbm_bw
            acc["pool_n"] += 1
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", None)
            if sub is not None:
                _walk_v2(sub, acc, peak_flops=peak_flops, hbm_bw=hbm_bw)
            if isinstance(v, (list, tuple)):
                for vv in v:
                    sub = getattr(vv, "jaxpr", None)
                    if sub is not None:
                        _walk_v2(sub, acc, peak_flops=peak_flops,
                                 hbm_bw=hbm_bw)
    return acc


def full_step_roofline_seconds(step_fn, *args, peak_flops: float,
                               hbm_bw: float):
    """Traffic-complete lower-bound seconds for ONE call of the real train
    step. Returns (bound_seconds, breakdown_dict). The backward is counted
    EXACTLY (its dgrad/wgrad convs appear in the grad jaxpr) — no
    3x-forward heuristic."""
    jaxpr = jax.make_jaxpr(step_fn)(*args)
    acc = {k: 0.0 for k in ("conv_s", "conv_flops", "conv_bytes", "dot_s",
                            "dot_flops", "resid_s", "resid_bytes", "pool_s")}
    acc.update({k: 0 for k in ("conv_n", "conv_bw_bound_n", "dot_n",
                               "resid_n", "pool_n", "pallas_n")})
    _walk_v2(jaxpr.jaxpr, acc, peak_flops=peak_flops, hbm_bw=hbm_bw)
    if acc["pallas_n"]:
        raise RuntimeError(
            f"roofline walker cannot see inside {acc['pallas_n']} "
            "pallas_call eqn(s): their convs/dots would be missing from the "
            "bound")
    bound = acc["conv_s"] + acc["dot_s"] + acc["resid_s"] + acc["pool_s"]
    return bound, acc


def kd_step_bound(batch: int, hw: int, *, peak_flops: float, hbm_bw: float,
                  teacher_name: str = "deeplabv3plus_resnet101",
                  student_name: str = "deeplabv3plus_mobilenet",
                  scope="classifier", num_classes: int = 21):
    """Traffic-complete v2 bound for a bf16 KD workload built from model
    names (teacher, cheap-conv student replaced at `scope`), traced with
    abstract arguments — nothing is allocated on the device.

    Returns (v1_img_s, v2_bound_seconds, v2_breakdown, tflops_per_img).
    """
    from ..kd import KDConfig, replace_cheap_convs
    from ..kd.replace import CheapConvSpec
    from ..models import build_model
    from ..train import make_kd_train_step, make_optimizer

    teacher = build_model(teacher_name, num_classes=num_classes,
                          output_stride=16, dtype=jnp.bfloat16,
                          rngs=nnx.Rngs(0))
    student = build_model(student_name, num_classes=num_classes,
                          output_stride=16, dtype=jnp.bfloat16,
                          rngs=nnx.Rngs(1))
    replace_cheap_convs(student, CheapConvSpec(kind="separable"), scope=scope)
    cfg = KDConfig(temperature=4.0, alpha=0.5, beta=0.5)
    _, params, _ = nnx.split(student, nnx.Param, ...)
    tx = make_optimizer({"student": params}, lr=1e-3, max_iters=10_000,
                        label_fn=lambda d: (
                            "backbone" if d.startswith("student.backbone")
                            else "head"))
    init_state, step_fn, t_state = make_kd_train_step(student, teacher, tx,
                                                      cfg)
    state = jax.eval_shape(init_state)
    t_state_abs = jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), t_state)
    images = jax.ShapeDtypeStruct((batch, hw, hw, 3), jnp.float32)
    labels = jax.ShapeDtypeStruct((batch, hw, hw), jnp.int32)
    bound_s, acc = full_step_roofline_seconds(
        step_fn, state, (images, labels), t_state_abs,
        peak_flops=peak_flops, hbm_bw=hbm_bw)
    v1_img_s = kd_step_roofline_img_per_s(teacher, student, hw, batch=batch,
                                          peak_flops=peak_flops,
                                          hbm_bw=hbm_bw)
    tflops_per_img = kd_step_flops_per_image(teacher, student, hw) / 1e12
    return v1_img_s, bound_s, acc, tflops_per_img
