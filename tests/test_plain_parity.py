"""Model blocks on the plain JAX path vs an independent float64 reference.

The reference is a torch-functional interpreter of our module trees
(`_Ref` below): it reads each module's configuration and weights and
recomputes it with torch.nn.functional in float64, NCHW. JAX runs the
forward in float32 under matmul precision "highest" and the gradients in
float64. Covered: MobileNetV2 features
f0-f6 (forward and train-mode parameter gradients), the Xception-65 entry,
middle and exit blocks (same), the DeepLabV3+ ASPP and decoder head (dense
and separable fuse conv, concat-split on and off; same), and eval-mode
ResNet bottlenecks (forward).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from kd_cheap_conv import config, nnx
from kd_cheap_conv.kd.replace import (AtrousSeparableConvolution,
                                      replace_cheap_convs)
from kd_cheap_conv.kd.replace import CheapConvSpec
from kd_cheap_conv.models import build_model
from kd_cheap_conv.models.aspp import ASPP, ASPPPooling
from kd_cheap_conv.models.deeplab import DeepLabHeadV3Plus
from kd_cheap_conv.models.layers import (BatchNorm, Conv2d, ConvBNReLU,
                                         SeparableConv2d)
from kd_cheap_conv.models.mobilenetv2 import ConvBNReLU6, InvertedResidual
from kd_cheap_conv.models.resnet import Bottleneck, _Downsample
from kd_cheap_conv.models.xception import SepConvBN, XceptionBlock

RNG = np.random.RandomState(7)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


class _Ref:
    """Float64 torch evaluation of a module tree; parameters are leaf
    tensors keyed by their state path, so autograd yields their grads."""

    def __init__(self, module):
        self.p = {k: torch.tensor(np.asarray(v, np.float64),
                                  requires_grad=True)
                  for k, v in _flat(nnx.state(module, nnx.Param))}
        self.s = {k: torch.tensor(np.asarray(v, np.float64))
                  for k, v in _flat(nnx.state(module, nnx.BatchStat))}

    def __call__(self, m, x, path=()):
        r = lambda sub, name: self(getattr(m, name), sub, path + (name,))
        if isinstance(m, AtrousSeparableConvolution):
            return r(r(x, "depthwise"), "pointwise")
        if isinstance(m, Conv2d):
            w = self.p[path + ("kernel",)].permute(3, 2, 0, 1)
            return F.conv2d(x, w, self.p.get(path + ("bias",)),
                            stride=m.stride, padding=m.padding,
                            dilation=m.dilation, groups=m.groups)
        if isinstance(m, BatchNorm):
            return F.batch_norm(
                x, self.s[path + ("mean",)], self.s[path + ("var",)],
                self.p[path + ("scale",)], self.p[path + ("bias",)],
                training=not m.use_running_average, eps=m.epsilon)
        if isinstance(m, ConvBNReLU6):
            return F.hardtanh(r(r(x, "conv"), "bn"), 0.0, 6.0)
        if isinstance(m, ConvBNReLU):
            y = r(r(x, "conv"), "bn")
            return F.relu(y) if m.relu else y
        if isinstance(m, InvertedResidual):
            y = x
            for i, b in enumerate(m.body):
                y = self(b, y, path + ("body", i))
            y = r(r(y, "pw_linear"), "pw_bn")
            return x + y if m.use_res_connect else y
        if isinstance(m, SeparableConv2d):
            if m.fixed_pad:
                eff = m._dilation[0] * (m._k[0] - 1)
                lo, hi = eff // 2, eff - eff // 2
                x = F.pad(x, (lo, hi, lo, hi))
            y = r(x, "depthwise")
            if m.bn_dw is not None:
                y = r(y, "bn_dw")
            return r(y, "pointwise")
        if isinstance(m, SepConvBN):
            y = F.relu(x) if m.pre_relu else x
            y = r(r(y, "sep"), "bn")
            return F.relu(y) if m.post_relu else y
        if isinstance(m, XceptionBlock):
            y = r(r(r(x, "sep1"), "sep2"), "sep3")
            skip = x if m.skip_conv is None else r(r(x, "skip_conv"),
                                                   "skip_bn")
            return y + skip
        if isinstance(m, Bottleneck):
            y = F.relu(r(r(x, "conv1"), "bn1"))
            y = F.relu(r(r(y, "conv2"), "bn2"))
            y = r(r(y, "conv3"), "bn3")
            idt = x if m.downsample is None else r(x, "downsample")
            return F.relu(y + idt)
        if isinstance(m, _Downsample):
            return r(r(x, "conv"), "bn")
        if isinstance(m, ASPPPooling):
            y = r(x.mean(dim=(2, 3), keepdim=True), "conv")
            return y.expand(-1, -1, x.shape[2], x.shape[3])
        if isinstance(m, ASPP):
            y = torch.cat([r(x, n) for n in ("branch1", "branch2", "branch3",
                                             "branch4", "pool")], dim=1)
            return r(y, "project")        # dropout is off in these tests
        if isinstance(m, DeepLabHeadV3Plus):
            low, out = x
            low = r(low, "project")
            y = F.interpolate(r(out, "aspp"), size=low.shape[2:],
                              mode="bilinear", align_corners=False)
            return r(r(torch.cat([low, y], dim=1), "fuse"), "classifier")
        raise TypeError(f"no reference for {type(m).__name__}")

    def grads(self) -> dict:
        return {k: v.grad.numpy() for k, v in self.p.items()}


def _nchw(x):
    return torch.tensor(np.asarray(x, np.float64).transpose(0, 3, 1, 2))


def _call(module, x):
    return module(x[0] if len(x) == 1 else {"low_level": x[0], "out": x[1]})


def _check(module, inputs, *, what: str, tol: float = 2e-4):
    """Compare the module on `inputs` (NHWC; two arrays feed a head) with
    the reference. what='forward': the float32 output under matmul
    precision "highest", within `tol` of the output's scale. what=
    'gradient': the parameter gradients of sum(output * cotangent),
    computed in float64 (train-mode BatchNorm turns some of them into
    cancellation sums that float32 cannot resolve), within 1e-6 of the
    largest gradient."""
    ref = _Ref(module)
    t_in = tuple(_nchw(a) for a in inputs)
    want = ref(module, t_in if len(t_in) > 1 else t_in[0])
    if what == "forward":
        with jax.default_matmul_precision("highest"):
            y = _call(module, tuple(jnp.asarray(a) for a in inputs))
        w = want.detach().numpy()
        np.testing.assert_allclose(
            np.asarray(y, np.float64).transpose(0, 3, 1, 2), w, rtol=tol,
            atol=tol * float(np.abs(w).max()))
        return
    cot = RNG.randn(*want.shape)
    (want * torch.tensor(cot)).sum().backward()
    rg = ref.grads()
    jax.config.update("jax_enable_x64", True)
    try:
        x = tuple(jnp.asarray(a, jnp.float64) for a in inputs)
        cot_nhwc = jnp.asarray(cot.transpose(0, 2, 3, 1))
        _, g = nnx.value_and_grad(
            lambda m: jnp.sum(_call(m, x) * cot_nhwc))(module)
        got = {k: np.asarray(v, np.float64) for k, v in _flat(g)}
    finally:
        jax.config.update("jax_enable_x64", False)
    assert set(got) == set(rg)
    scale = max(float(np.abs(w).max()) for w in rg.values())
    for k, v in got.items():
        np.testing.assert_allclose(v, rg[k], rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=str(k))


# --- MobileNetV2 features[0..6] (train mode) --------------------------------

_MNV2 = None


def _mnv2_features():
    global _MNV2
    if _MNV2 is None:
        m = build_model("deeplabv3plus_mobilenet", num_classes=5,
                        output_stride=16, rngs=nnx.Rngs(3))
        m.train()
        _MNV2 = m.backbone.features
    return _MNV2


# input (H, C) of each block for a 65² image
_MNV2_IN = [(65, 3), (33, 32), (33, 16), (17, 24), (17, 24), (9, 32),
            (9, 32)]


@pytest.mark.parametrize("what", ["forward", "gradient"])
@pytest.mark.parametrize("idx", range(7))
def test_mobilenetv2_block_matches_reference(idx, what):
    block = _mnv2_features()[idx]
    h, c = _MNV2_IN[idx]
    x = RNG.randn(2, h, h, c).astype(np.float32)
    _check(block, (x,), what=what)


# --- Xception-65 entry / middle / exit blocks (train mode) ------------------

_XC = None


def _xception():
    global _XC
    if _XC is None:
        m = build_model("deeplabv3plus_xception", num_classes=5,
                        output_stride=16, rngs=nnx.Rngs(4))
        m.train()
        _XC = m.backbone
    return _XC


_XC_BLOCKS = {  # name -> (module getter, input H, C)
    "block1": (lambda b: b.block1, 17, 64),
    "block2": (lambda b: b.block2, 9, 128),
    "block3": (lambda b: b.block3, 9, 256),
    "middle0": (lambda b: b.middle[0], 5, 728),
    "exit_block": (lambda b: b.exit_block, 5, 728),
    "exit_sep1": (lambda b: b.exit_sep1, 5, 1024),
}


@pytest.mark.parametrize("what", ["forward", "gradient"])
@pytest.mark.parametrize("name", sorted(_XC_BLOCKS))
def test_xception_block_matches_reference(name, what):
    get, h, c = _XC_BLOCKS[name]
    x = RNG.randn(2, h, h, c).astype(np.float32)
    _check(get(_xception()), (x,), what=what, tol=5e-4)


# --- DeepLabV3+ ASPP and decoder head (train mode) --------------------------

@pytest.fixture
def split_concat(request):
    old = (config.split_aspp_concat, config.split_decoder_concat)
    config.split_aspp_concat = config.split_decoder_concat = request.param
    yield request.param
    config.split_aspp_concat, config.split_decoder_concat = old


def _train_no_dropout(m):
    m.train()
    m.set_attributes(deterministic=True)
    return m


@pytest.mark.parametrize("what", ["forward", "gradient"])
@pytest.mark.parametrize("split_concat", [False, True], indirect=True)
def test_aspp_matches_reference(split_concat, what):
    # batch 8: the pooling branch's BN sees one value per image and channel
    aspp = _train_no_dropout(ASPP(64, (6, 12, 18), out_channels=32,
                                  rngs=nnx.Rngs(5)))
    x = RNG.randn(8, 9, 9, 64).astype(np.float32)
    _check(aspp, (x,), what=what)


@pytest.mark.parametrize("what", ["forward", "gradient"])
@pytest.mark.parametrize("split_concat", [False, True], indirect=True)
@pytest.mark.parametrize("fuse", ["dense", "separable"])
def test_decoder_head_matches_reference(fuse, split_concat, what):
    head = DeepLabHeadV3Plus(320, 24, 21, rngs=nnx.Rngs(6))
    if fuse == "separable":
        replace_cheap_convs(head, CheapConvSpec(kind="separable"))
    _train_no_dropout(head)
    low = RNG.randn(8, 33, 33, 24).astype(np.float32)
    out = RNG.randn(8, 9, 9, 320).astype(np.float32)
    _check(head, (low, out), what=what, tol=5e-4)


# --- ResNet bottlenecks (eval mode, as the frozen teacher runs them) --------

@pytest.mark.parametrize("inplanes,planes,stride,dilation,downsample,h", [
    (64, 64, 1, 1, True, 17),      # layer1 block 0
    (256, 64, 1, 1, False, 17),    # layer1 block 1+
    (256, 128, 2, 1, True, 17),    # layer2 block 0
    (2048, 512, 1, 2, False, 5),   # layer4 (OS16) dilated block
])
def test_resnet_eval_bottleneck_matches_reference(inplanes, planes, stride,
                                                  dilation, downsample, h):
    rngs = nnx.Rngs(8)
    ds = (_Downsample(inplanes, planes * 4, stride, rngs=rngs)
          if downsample else None)
    b = Bottleneck(inplanes, planes, stride=stride, dilation=dilation,
                   downsample=ds, rngs=rngs)
    for _, bn in nnx.iter_modules(b):      # non-trivial running statistics
        if isinstance(bn, BatchNorm):
            n = bn.num_features
            bn.mean[...] = jnp.asarray(RNG.randn(n) * 0.1, jnp.float32)
            bn.var[...] = jnp.asarray(RNG.uniform(0.5, 2.0, n), jnp.float32)
    b.eval()
    x = RNG.randn(2, h, h, inplanes).astype(np.float32)
    _check(b, (x,), what="forward")
