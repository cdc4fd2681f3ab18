"""The in-repo module system (kd_cheap_conv.nnx): split/merge/state/update,
filters, containers, value_and_grad with BatchNorm statistics, train/eval
modes, dropout RNG state, pure-dict restore, and BatchNorm numerics vs
torch."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from kd_cheap_conv import nnx
from kd_cheap_conv.models.layers import BatchNorm, Conv2d


class Block(nnx.Module):
    def __init__(self, rngs):
        self.conv = Conv2d(3, 4, 3, padding=1, use_bias=False, rngs=rngs)
        self.bn = BatchNorm(4, rngs=rngs)
        self.drop = nnx.Dropout(0.5, rngs=rngs)
        self.extra = nnx.List([Conv2d(4, 4, 1, rngs=rngs), None])
        self.scale = 2.0

    def __call__(self, x):
        return self.drop(self.extra[0](self.bn(self.conv(x)))) * self.scale


def _block():
    m = Block(nnx.Rngs(0))
    m.train()
    return m


def test_split_merge_roundtrip_is_a_new_equal_tree():
    m = _block()
    m.eval()
    graphdef, params, rest = nnx.split(m, nnx.Param, ...)
    m2 = nnx.merge(graphdef, params, rest)
    assert m2 is not m and m2.conv is not m.conv
    x = jnp.asarray(np.random.RandomState(0).randn(2, 5, 5, 3), jnp.float32)
    np.testing.assert_array_equal(np.asarray(m2(x)), np.asarray(m(x)))
    assert m2.scale == 2.0 and m2.extra[1] is None


def test_filters_partition_variables():
    m = _block()
    _, params, stats, rngs = nnx.split(m, nnx.Param, nnx.BatchStat, ...)
    assert set(params) == {"bn", "conv", "extra"}
    assert set(params["extra"]) == {0}
    assert set(stats["bn"]) == {"mean", "var"}
    assert set(rngs["drop"]) == {"count", "key"}
    not_params = nnx.state(m, nnx.Not(nnx.Param))
    assert set(not_params) == {"bn", "drop"}


def test_split_requires_every_variable_to_match():
    with pytest.raises(ValueError, match="matched no filter"):
        nnx.split(_block(), nnx.Param)


def test_merge_rejects_missing_and_extra_entries():
    graphdef, params, rest = nnx.split(_block(), nnx.Param, ...)
    with pytest.raises(ValueError, match="no value"):
        nnx.merge(graphdef, params)
    with pytest.raises(ValueError, match="match no variable"):
        nnx.merge(graphdef, params, rest, {"bogus": jnp.zeros(())})


def test_plain_list_of_modules_is_rejected():
    class Bad(nnx.Module):
        def __init__(self):
            self.layers = [Conv2d(1, 1, 1, rngs=nnx.Rngs(0))]

    with pytest.raises(TypeError, match="nnx.List"):
        nnx.split(Bad())


def test_iter_modules_order_children_first():
    paths = [p for p, _ in nnx.iter_modules(_block())]
    assert paths == [("bn",), ("conv",), ("drop",), ("extra", 0), ("extra",),
                     ()]


def test_train_eval_toggle_bn_and_dropout():
    m = _block()
    assert not m.bn.use_running_average and not m.drop.deterministic
    m.eval()
    assert m.bn.use_running_average and m.drop.deterministic


def test_value_and_grad_writes_back_batch_stats():
    m = _block()
    m.drop.deterministic = True
    x = jnp.asarray(np.random.RandomState(1).randn(4, 5, 5, 3) + 3.0,
                    jnp.float32)
    mean0 = np.asarray(m.bn.mean[...])

    def loss(mod, x):
        return jnp.mean(mod(x) ** 2)

    val, grads = nnx.value_and_grad(loss)(m, x)
    assert np.isfinite(float(val))
    assert not np.allclose(np.asarray(m.bn.mean[...]), mean0)
    _, params, _ = nnx.split(m, nnx.Param, ...)
    assert jax.tree.structure(grads) == jax.tree.structure(params)
    # the gradient matches jax.grad over the pure params
    graphdef, params, rest = nnx.split(m, nnx.Param, ...)
    want = jax.grad(lambda p: loss(nnx.merge(graphdef, p, rest), x))(params)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_value_and_grad_two_modules_with_aux():
    a, b = _block(), _block()
    a.drop.deterministic = b.drop.deterministic = True
    x = jnp.ones((2, 5, 5, 3), jnp.float32)
    (val, aux), (ga, gb) = nnx.value_and_grad(
        lambda m1, m2: (jnp.sum(m1(x) * m2(x)), {"n": 1}), argnums=(0, 1),
        has_aux=True)(a, b)
    assert aux == {"n": 1} and set(ga) == set(gb) == {"bn", "conv", "extra"}


def test_dropout_draws_a_new_mask_each_training_call():
    m = _block()
    x = jnp.ones((1, 5, 5, 3), jnp.float32)
    y1, y2 = np.asarray(m(x)), np.asarray(m(x))
    assert int(m.drop.count[...]) == 2
    assert not np.array_equal(y1, y2)
    m.eval()
    np.testing.assert_array_equal(np.asarray(m(x)), np.asarray(m(x)))


def test_clone_is_independent():
    m = _block()
    c = nnx.clone(m)
    c.bn.mean[...] = jnp.full((4,), 5.0)
    assert float(m.bn.mean[...][0]) == 0.0


def test_replace_by_pure_dict_matches_string_keys():
    m = _block()
    _, params, rest = nnx.split(m, nnx.Param, ...)
    pure = {"bn": {"bias": np.ones(4), "scale": np.ones(4)},
            "conv": {"kernel": np.zeros((3, 3, 3, 4))},
            "extra": {"0": {"bias": np.zeros(4),
                            "kernel": np.ones((1, 1, 4, 4))}}}
    nnx.replace_by_pure_dict(params, pure)
    nnx.update(m, params, rest)
    np.testing.assert_array_equal(np.asarray(m.extra[0].kernel[...]),
                                  np.ones((1, 1, 4, 4)))


def test_rngs_streams_give_fresh_keys():
    r = nnx.Rngs(3)
    k1, k2 = r.params(), r.dropout()
    assert not np.array_equal(np.asarray(k1), np.asarray(k2))
    assert np.array_equal(np.asarray(nnx.Rngs(3)()), np.asarray(k1))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_torch(train):
    rs = np.random.RandomState(2)
    bn = BatchNorm(6, rngs=nnx.Rngs(0))
    bn.scale[...] = jnp.asarray(rs.rand(6) + 0.5, jnp.float32)
    bn.bias[...] = jnp.asarray(rs.randn(6), jnp.float32)
    bn.mean[...] = jnp.asarray(rs.randn(6) * 0.1, jnp.float32)
    bn.var[...] = jnp.asarray(rs.rand(6) + 0.5, jnp.float32)
    if not train:
        bn.eval()
    x = rs.randn(3, 4, 5, 6).astype(np.float32) * 2 + 1
    rm = torch.tensor(np.asarray(bn.mean[...], np.float64))
    rv = torch.tensor(np.asarray(bn.var[...], np.float64))
    want = F.batch_norm(torch.tensor(x.transpose(0, 3, 1, 2), dtype=torch.float64),
                        rm.clone(), rv.clone(),
                        torch.tensor(np.asarray(bn.scale[...], np.float64)),
                        torch.tensor(np.asarray(bn.bias[...], np.float64)),
                        training=train, eps=1e-5).numpy().transpose(0, 2, 3, 1)
    got = np.asarray(bn(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if train:   # running stats: momentum 0.9 toward the biased batch moments
        mean = x.reshape(-1, 6).mean(0)
        np.testing.assert_allclose(np.asarray(bn.mean[...]),
                                   0.9 * rm.numpy() + 0.1 * mean, rtol=1e-5,
                                   atol=1e-6)


def test_batchnorm_bf16_keeps_f32_statistics():
    bn = BatchNorm(4, dtype=jnp.bfloat16, rngs=nnx.Rngs(0))
    y = bn(jnp.ones((2, 3, 3, 4), jnp.bfloat16))
    assert y.dtype == jnp.bfloat16
    assert bn.mean[...].dtype == jnp.float32
