"""Full-model per-pixel logit parity vs a reference-shaped PyTorch graph
(BASELINE.json:5 "per-pixel logit fidelity vs the PyTorch reference within
float tolerance"). The torch mirror reproduces the reference
deeplabv3plus_mobilenet structure (SURVEY.md §2.1/§3.1) with the same module
paths as the NNX model, so its state_dict imports losslessly via
import_torch_state_dict — any structural divergence (misplaced ReLU,
BN ordering, padding/dilation arithmetic, resize semantics) breaks the
assert, which op-level parity tests cannot catch.
"""

import numpy as np
import jax.numpy as jnp
import torch
import torch.nn as nn
import torch.nn.functional as F
from kd_cheap_conv import nnx

from kd_cheap_conv.models import build_model
from kd_cheap_conv.train.checkpoint import import_torch_state_dict


def _make_divisible(v, divisor=8):
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class TConvBNReLU6(nn.Module):
    def __init__(self, i, o, k=3, s=1, d=1, g=1):
        super().__init__()
        p = (k - 1) // 2 * d
        self.conv = nn.Conv2d(i, o, k, stride=s, padding=p, dilation=d,
                              groups=g, bias=False)
        self.bn = nn.BatchNorm2d(o)

    def forward(self, x):
        return F.relu6(self.bn(self.conv(x)))


class TInvertedResidual(nn.Module):
    def __init__(self, inp, oup, s=1, d=1, t=6):
        super().__init__()
        hidden = int(round(inp * t))
        self.use_res = s == 1 and inp == oup
        body = []
        if t != 1:
            body.append(TConvBNReLU6(inp, hidden, 1))
        body.append(TConvBNReLU6(hidden, hidden, 3, s=s, d=d, g=hidden))
        self.body = nn.ModuleList(body)
        self.pw_linear = nn.Conv2d(hidden, oup, 1, bias=False)
        self.pw_bn = nn.BatchNorm2d(oup)

    def forward(self, x):
        out = x
        for m in self.body:
            out = m(out)
        out = self.pw_bn(self.pw_linear(out))
        return x + out if self.use_res else out


_SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


class TMobileNetV2(nn.Module):
    def __init__(self, output_stride=16):
        super().__init__()
        input_channel = _make_divisible(32)
        features = [TConvBNReLU6(3, input_channel, 3, s=2)]
        current_stride, dilation = 2, 1
        for t, c, n, s in _SETTING:
            prev_d = dilation
            if current_stride == output_stride:
                stride = 1
                dilation *= s
            else:
                stride = s
                current_stride *= s
            oc = _make_divisible(c)
            for i in range(n):
                features.append(TInvertedResidual(
                    input_channel, oc, s=stride if i == 0 else 1,
                    d=prev_d if i == 0 else dilation, t=t))
                input_channel = oc
        self.features = nn.ModuleList(features)

    def forward(self, x):
        low = None
        for i, m in enumerate(self.features):
            x = m(x)
            if i == 3:
                low = x
        return {"low_level": low, "out": x}


class TConvBNReLU(nn.Module):
    def __init__(self, i, o, k, p=0, d=1):
        super().__init__()
        self.conv = nn.Conv2d(i, o, k, padding=p, dilation=d, bias=False)
        self.bn = nn.BatchNorm2d(o)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class TASPPPooling(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.conv = TConvBNReLU(i, o, 1)

    def forward(self, x):
        h, w = x.shape[-2:]
        p = self.conv(x.mean(dim=(2, 3), keepdim=True))
        return p.expand(-1, -1, h, w)


class TASPP(nn.Module):
    def __init__(self, i, rates, o=256):
        super().__init__()
        r1, r2, r3 = rates
        self.branch1 = TConvBNReLU(i, o, 1)
        self.branch2 = TConvBNReLU(i, o, 3, p=r1, d=r1)
        self.branch3 = TConvBNReLU(i, o, 3, p=r2, d=r2)
        self.branch4 = TConvBNReLU(i, o, 3, p=r3, d=r3)
        self.pool = TASPPPooling(i, o)
        self.project = TConvBNReLU(5 * o, o, 1)
        self.dropout = nn.Dropout(0.1)

    def forward(self, x):
        feats = torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                           self.branch4(x), self.pool(x)], dim=1)
        return self.dropout(self.project(feats))


class THeadV3Plus(nn.Module):
    def __init__(self, in_ch, low_ch, num_classes, rates=(6, 12, 18)):
        super().__init__()
        self.project = TConvBNReLU(low_ch, 48, 1)
        self.aspp = TASPP(in_ch, rates)
        self.fuse = TConvBNReLU(304, 256, 3, p=1)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, feats):
        low = self.project(feats["low_level"])
        x = self.aspp(feats["out"])
        x = F.interpolate(x, size=low.shape[-2:], mode="bilinear",
                          align_corners=False)
        x = self.fuse(torch.cat([low, x], dim=1))
        return self.classifier(x)


class TDeepLabV3PlusMobileNet(nn.Module):
    def __init__(self, num_classes=21, output_stride=16):
        super().__init__()
        self.backbone = TMobileNetV2(output_stride)
        rates = (6, 12, 18) if output_stride == 16 else (12, 24, 36)
        self.classifier = THeadV3Plus(320, 24, num_classes, rates)

    def forward(self, x):
        size = x.shape[-2:]
        logits = self.classifier(self.backbone(x))
        return F.interpolate(logits, size=size, mode="bilinear",
                             align_corners=False)


def _randomize_bn(model, rng):
    """Non-trivial BN affine + running stats so eval-mode parity is a real
    test of the normalization path, not of identity stats."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            n = m.num_features
            m.weight.data = torch.from_numpy(
                rng.uniform(0.5, 1.5, n).astype(np.float32))
            m.bias.data = torch.from_numpy(
                rng.randn(n).astype(np.float32) * 0.1)
            m.running_mean = torch.from_numpy(
                rng.randn(n).astype(np.float32) * 0.1)
            m.running_var = torch.from_numpy(
                rng.uniform(0.5, 1.5, n).astype(np.float32))


def test_full_model_logit_parity_vs_torch():
    torch.manual_seed(0)
    rng = np.random.RandomState(0)
    tnet = TDeepLabV3PlusMobileNet(num_classes=21, output_stride=16).eval()
    _randomize_bn(tnet, rng)

    model = build_model("deeplabv3plus_mobilenet", num_classes=21,
                        output_stride=16, rngs=nnx.Rngs(0))
    n, missing = import_torch_state_dict(model, tnet.state_dict(), strict=True)
    assert not missing
    assert n > 150  # every conv + BN tensor mapped
    model.eval()

    x = rng.randn(2, 65, 65, 3).astype(np.float32)
    got = np.asarray(model(jnp.asarray(x)))                 # NHWC
    with torch.no_grad():
        want = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want,
                               rtol=1e-4, atol=1e-4)


def test_full_model_parity_class_major_path():
    """The class-major hot path (transpose at head res + NCHW upsample) must
    be numerically identical to the reference NHWC path."""
    torch.manual_seed(1)
    rng = np.random.RandomState(1)
    tnet = TDeepLabV3PlusMobileNet(num_classes=6, output_stride=16).eval()
    _randomize_bn(tnet, rng)
    model = build_model("deeplabv3plus_mobilenet", num_classes=6,
                        output_stride=16, rngs=nnx.Rngs(0))
    _, missing = import_torch_state_dict(model, tnet.state_dict(), strict=True)
    assert not missing
    model.eval()
    x = rng.randn(1, 33, 33, 3).astype(np.float32)
    cm = np.asarray(model(jnp.asarray(x), class_major=True))  # NCHW
    with torch.no_grad():
        want = tnet(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    np.testing.assert_allclose(cm, want, rtol=1e-4, atol=1e-4)
