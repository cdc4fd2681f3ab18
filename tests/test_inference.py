"""TTA inference tests (config #5): flip/scale equivariance sanity and
batched flip equivalence to the per-augmentation loop.
"""

import numpy as np
import jax.numpy as jnp
from kd_cheap_conv import nnx

from kd_cheap_conv.inference import make_predict_fn, make_tta_predict_fn
from kd_cheap_conv.models import build_model
from kd_cheap_conv.ops.resize import resize_bilinear

RNG = np.random.RandomState(0)


def _model():
    m = build_model("deeplabv3plus_mobilenet", num_classes=21, rngs=nnx.Rngs(0))
    m.eval()
    return m


def test_predict_shapes():
    m = _model()
    pred = make_predict_fn(m)(jnp.asarray(RNG.randn(2, 33, 33, 3), jnp.float32))
    assert pred.shape == (2, 33, 33) and pred.dtype == jnp.int32


def test_tta_matches_manual_loop():
    m = _model()
    x = jnp.asarray(RNG.randn(1, 33, 33, 3), jnp.float32)
    scales = (0.75, 1.0)
    tta = make_tta_predict_fn(m, scales=scales, flip=True)
    pred, probs = tta(x)
    assert pred.shape == (1, 33, 33)
    np.testing.assert_allclose(float(probs.sum(-1).mean()), 1.0, rtol=1e-5)

    # manual reference loop (SURVEY.md §3.5)
    import jax

    graphdef, state = nnx.split(m)
    model = nnx.merge(graphdef, state)
    h = w = 33
    acc = 0
    for s in scales:
        sh = sw = max(1, int(round(33 * s)))
        xs = resize_bilinear(x, (sh, sw))
        for f in (False, True):
            xi = xs[:, :, ::-1, :] if f else xs
            logits = model(xi)
            logits = logits[:, :, ::-1, :] if f else logits
            logits = resize_bilinear(logits, (h, w))
            acc = acc + jax.nn.softmax(logits.astype(jnp.float32), -1)
    want = acc / (2 * len(scales))
    np.testing.assert_allclose(np.asarray(probs), np.asarray(want),
                               rtol=5e-3, atol=2e-5)


def test_tta_flip_consistency_on_symmetric_input():
    # a horizontally symmetric input must give a symmetric prob map when
    # flip-TTA is on
    m = _model()
    x = jnp.asarray(RNG.randn(1, 17, 17, 3), jnp.float32)
    x = (x + x[:, :, ::-1, :]) / 2
    _, probs = make_tta_predict_fn(m, scales=(1.0,), flip=True)(x)
    np.testing.assert_allclose(np.asarray(probs),
                               np.asarray(probs[:, :, ::-1, :]),
                               rtol=1e-4, atol=1e-5)
