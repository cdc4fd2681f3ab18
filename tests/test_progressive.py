"""Progressive replacement schedule (config #4) smoke test — tiny
resnet-teacher clone, 2 stages + fine-tune, a couple of iterations each.
"""

import pytest
import numpy as np
import jax.numpy as jnp
from kd_cheap_conv import nnx

from kd_cheap_conv.kd.distill import KDConfig
from kd_cheap_conv.kd.progressive import ProgressiveConfig, run_progressive
from kd_cheap_conv.kd.replace import AtrousSeparableConvolution, CheapConvSpec
from kd_cheap_conv.models import build_model

RNG = np.random.RandomState(0)


def _batches():
    while True:
        yield (jnp.asarray(RNG.randn(2, 33, 33, 3), jnp.float32),
               jnp.asarray(RNG.randint(0, 6, (2, 33, 33)), jnp.int32))


@pytest.mark.slow
def test_run_progressive_two_stages():
    teacher = build_model("deeplabv3plus_resnet50", num_classes=6,
                          rngs=nnx.Rngs(0))
    teacher.eval()
    student = nnx.clone(teacher)
    student.train()
    cfg = ProgressiveConfig(
        stage_iters=2, finetune_iters=2,
        spec=CheapConvSpec(kind="separable", init="factorize"),
        kd=KDConfig(temperature=2.0, alpha=0.5, beta=0.5),
    )
    stages = [("backbone.layer4",), ("backbone.layer3",)]
    student, history = run_progressive(
        teacher, student, _batches, cfg, stages=stages, input_hw=(33, 33),
        log_fn=lambda s: None)
    # both stages replaced + finetune ran
    assert len(history) == 3
    assert all(np.isfinite(h["final_loss"]) for h in history)
    n_sep = sum(1 for _, m in nnx.iter_modules(student)
                if isinstance(m, AtrousSeparableConvolution))
    assert n_sep > 0
    # layer3 and layer4 both now contain separable convs
    reps = {p for h in history for p in h["replaced"]}
    assert any(p.startswith("backbone.layer4") for p in reps)
    assert any(p.startswith("backbone.layer3") for p in reps)
    # student still runs end-to-end after surgery + updates
    student.eval()
    out = student(jnp.zeros((1, 33, 33, 3)))
    assert out.shape == (1, 33, 33, 6)
    assert bool(jnp.isfinite(out).all())
