"""Plain-JAX ops vs independent float64 references (torch functional or
numpy), forward and gradients: depthwise and separable convs over the
dilation x stride grid, the 4x/16x odd-size bilinear logit upsample in its
three forms, and the KD losses (CE/focal/KL/hint with ignore-index,
temperature, the teacher-logit clip and kl_mask_ignored), including
gradients taken through the upsample."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from kd_cheap_conv import nnx
from kd_cheap_conv.kd.distill import KDConfig, kd_total_loss
from kd_cheap_conv.models.layers import Conv2d, SeparableConv2d
from kd_cheap_conv.ops.losses import (cross_entropy, focal_loss,
                                      hint_l2_loss, kd_kl_loss)
from kd_cheap_conv.ops.resize import (resize_bilinear, resize_bilinear_matmul,
                                      resize_bilinear_nchw)

RNG = np.random.RandomState(11)


def _close(got, want, tol=2e-4):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1e-6))


def _t(a):
    return torch.tensor(np.asarray(a, np.float64), requires_grad=True)


# --- depthwise / separable convs over dilation x stride ---------------------

@pytest.mark.parametrize("kind", ["depthwise", "separable"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("dilation", [1, 2, 6])
def test_depthwise_separable_conv_grid(kind, stride, dilation):
    c, co, h = 24, 32, 19
    rngs = nnx.Rngs(1)
    pad = dilation
    if kind == "depthwise":
        m = Conv2d(c, c, 3, stride=stride, padding=pad, dilation=dilation,
                   groups=c, rngs=rngs)
    else:
        m = SeparableConv2d(c, co, 3, stride=stride, padding=pad,
                            dilation=dilation, rngs=rngs)
    x = RNG.randn(2, h, h, c).astype(np.float32)

    def ref(p, xt):
        if kind == "depthwise":
            return F.conv2d(xt, p[("kernel",)].permute(3, 2, 0, 1),
                            p[("bias",)], stride=stride, padding=pad,
                            dilation=dilation, groups=c)
        y = F.conv2d(xt, p[("depthwise", "kernel")].permute(3, 2, 0, 1),
                     stride=stride, padding=pad, dilation=dilation, groups=c)
        return F.conv2d(y, p[("pointwise", "kernel")].permute(3, 2, 0, 1))

    params = nnx.state(m, nnx.Param)
    flat = {}

    def walk(d, path=()):
        for k, v in d.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                flat[path + (k,)] = _t(v)

    walk(params)
    xt = _t(x.transpose(0, 3, 1, 2))
    want = ref(flat, xt)
    cot = RNG.randn(*want.shape)
    (want * torch.tensor(cot)).sum().backward()

    with jax.default_matmul_precision("highest"):
        got = m(jnp.asarray(x))
        _close(np.asarray(got).transpose(0, 3, 1, 2), want.detach().numpy())
        cot_nhwc = jnp.asarray(cot.transpose(0, 2, 3, 1), jnp.float32)
        _, g = nnx.value_and_grad(
            lambda mm, x: jnp.sum(mm(x) * cot_nhwc))(m, jnp.asarray(x))
    gx = jax.grad(lambda x: jnp.sum(m(x) * cot_nhwc))(jnp.asarray(x))
    _close(np.asarray(gx).transpose(0, 3, 1, 2), xt.grad.numpy())
    for path, t in flat.items():
        node = g
        for k in path:
            node = node[k]
        _close(node, t.grad.numpy())


# --- bilinear logit upsample (torch align_corners=False semantics) ----------

# (head size, output size): 513 crop (33 -> 129 decoder 4x, 129 -> 513 and
# 33 -> 513 logits), 769 crop (49 -> 193, 49 -> 769)
_SIZES = [(33, 129), (129, 513), (33, 513), (49, 193), (49, 769)]


def _torch_up(x_nchw, out):
    return F.interpolate(x_nchw, size=(out, out), mode="bilinear",
                         align_corners=False)


@pytest.mark.parametrize("impl", ["nhwc", "nchw", "matmul"])
@pytest.mark.parametrize("src,out", _SIZES)
def test_bilinear_upsample_matches_torch(src, out, impl):
    x = RNG.randn(1, src, src, 3).astype(np.float32)
    want = _torch_up(_t(x.transpose(0, 3, 1, 2)), out).detach().numpy()
    with jax.default_matmul_precision("highest"):
        if impl == "nchw":
            got = resize_bilinear_nchw(jnp.asarray(x.transpose(0, 3, 1, 2)),
                                       (out, out))
        else:
            fn = resize_bilinear if impl == "nhwc" else resize_bilinear_matmul
            got = jnp.transpose(fn(jnp.asarray(x), (out, out)), (0, 3, 1, 2))
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("src,out", _SIZES)
def test_bilinear_upsample_grad_matches_torch(src, out):
    x = RNG.randn(1, 2, src, src).astype(np.float32)
    cot = RNG.randn(1, 2, out, out)
    xt = _t(x)
    (_torch_up(xt, out) * torch.tensor(cot)).sum().backward()
    g = jax.grad(lambda v: jnp.sum(resize_bilinear_nchw(v, (out, out))
                                   * jnp.asarray(cot, jnp.float32)))(
        jnp.asarray(x))
    _close(g, xt.grad.numpy(), tol=1e-4)


# --- losses vs float64 numpy -------------------------------------------------

def _np_log_softmax(z, axis):
    z = z - z.max(axis=axis, keepdims=True)
    return z - np.log(np.exp(z).sum(axis=axis, keepdims=True))


def _np_losses(s, t, labels, *, temperature, ignore=255, mask_kl=False,
               clip=None, gamma=2.0):
    """float64 numpy CE / focal / KL(t||s)*T² / all NCHW, labels NHW."""
    s = s.astype(np.float64)
    t = t.astype(np.float64)
    if clip is not None:
        t = np.clip(t, -clip, clip)
    valid = labels != ignore
    safe = np.where(valid, labels, 0)
    logp = _np_log_softmax(s, 1)
    lp_y = np.take_along_axis(logp, safe[:, None], 1)[:, 0]
    n = max(valid.sum(), 1)
    ce = -(lp_y * valid).sum() / n
    focal = (-(1 - np.exp(lp_y)) ** gamma * lp_y * valid).sum() / n
    ls = _np_log_softmax(s / temperature, 1)
    lt = _np_log_softmax(t / temperature, 1)
    kl_px = (np.exp(lt) * (lt - ls)).sum(1)
    kl = (kl_px * valid).sum() / n if mask_kl else kl_px.mean()
    return ce, focal, temperature ** 2 * kl


def _logits(n=2, c=6, h=7, w=9, scale=3.0):
    s = (RNG.randn(n, c, h, w) * scale).astype(np.float32)
    t = (RNG.randn(n, c, h, w) * scale).astype(np.float32)
    labels = RNG.randint(0, c, (n, h, w)).astype(np.int32)
    labels[:, :2, :3] = 255
    return s, t, labels


@pytest.mark.parametrize("axis", [1, -1])
@pytest.mark.parametrize("loss", ["ce", "focal", "kl", "kl_masked", "hint"])
def test_loss_matches_numpy(loss, axis):
    s, t, labels = _logits()
    temp = 2.5
    ce, focal, kl = _np_losses(s, t, labels, temperature=temp,
                               mask_kl=loss == "kl_masked")
    conv = (lambda a: a) if axis == 1 else (
        lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1)))
    sj, tj, lj = jnp.asarray(conv(s)), jnp.asarray(conv(t)), jnp.asarray(
        labels)
    if loss == "ce":
        got, want = cross_entropy(sj, lj, channel_axis=axis), ce
    elif loss == "focal":
        got, want = focal_loss(sj, lj, channel_axis=axis), focal
    elif loss == "hint":
        got = hint_l2_loss(sj, tj)
        want = np.mean((s.astype(np.float64) - t) ** 2)
    else:
        got = kd_kl_loss(sj, tj, temperature=temp,
                         labels=lj if loss == "kl_masked" else None,
                         channel_axis=axis)
        want = kl
    _close(got, want, tol=1e-5)


@pytest.mark.parametrize("mask_kl", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_kd_total_loss_with_clip_matches_numpy(temperature, mask_kl):
    s, t, labels = _logits()
    t[0, 0] = 5e4          # beyond the clip: an untrained teacher's logits
    cfg = KDConfig(temperature=temperature, alpha=0.3, beta=0.7,
                   kl_mask_ignored=mask_kl, teacher_logit_clip=3.0e4)
    total, aux = kd_total_loss(jnp.asarray(s), jnp.asarray(t),
                               jnp.asarray(labels), cfg, channel_axis=1)
    ce, _, kl = _np_losses(s, t, labels, temperature=temperature,
                           mask_kl=mask_kl, clip=3.0e4)
    _close(aux["task"], ce, tol=1e-5)
    _close(aux["kd"], kl, tol=1e-4)
    _close(total, 0.3 * ce + 0.7 * kl, tol=1e-4)


@pytest.mark.parametrize("mask_kl", [False, True])
@pytest.mark.parametrize("temperature", [1.0, 4.0])
def test_kd_loss_grad_through_upsample_matches_torch(temperature, mask_kl):
    """d loss / d head-resolution student logits, through the 16x bilinear
    upsample, vs torch autograd in float64."""
    n, c, h, out = 2, 5, 5, 65
    s = (RNG.randn(n, c, h, h) * 2).astype(np.float32)
    t = (RNG.randn(n, c, h, h) * 2).astype(np.float32)
    labels = RNG.randint(0, c, (n, out, out)).astype(np.int64)
    labels[:, :9, :] = 255
    cfg = KDConfig(temperature=temperature, alpha=0.5, beta=0.5,
                   kl_mask_ignored=mask_kl)

    def jloss(sv):
        up_s = resize_bilinear_nchw(sv, (out, out))
        up_t = resize_bilinear_nchw(jnp.asarray(t), (out, out))
        return kd_total_loss(up_s, up_t, jnp.asarray(labels, jnp.int32), cfg,
                             channel_axis=1)[0]

    g = jax.grad(jloss)(jnp.asarray(s))

    st = _t(s)
    up_s = _torch_up(st, out)
    up_t = _torch_up(torch.tensor(t, dtype=torch.float64), out)
    ce = F.cross_entropy(up_s, torch.tensor(labels), ignore_index=255)
    kl_px = F.kl_div(F.log_softmax(up_s / temperature, 1),
                     F.log_softmax(up_t / temperature, 1), log_target=True,
                     reduction="none").sum(1)
    valid = torch.tensor(labels != 255, dtype=torch.float64)
    kl = ((kl_px * valid).sum() / valid.sum() if mask_kl else kl_px.mean())
    (0.5 * ce + 0.5 * temperature ** 2 * kl).backward()
    _close(g, st.grad.numpy(), tol=1e-4)
