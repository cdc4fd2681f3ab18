"""Knowledge-distillation-by-cheap-conv-replacement framework in JAX.

Rebuilds the capabilities of lehduong/Knowledge-Distillation-by-Replacing-Cheap-Conv
(a DeepLabV3+ semantic-segmentation KD fork; see SURVEY.md — the reference
mount was empty, so capability citations point at BASELINE.json) as an
idiomatic JAX/XLA framework:

- ``ops``      — conv/resize/loss primitives (NHWC, plain lax/jnp)
- ``nnx``      — the small module system the models are built on
- ``models``   — backbones (ResNet, MobileNetV2, Xception-65),
                 ASPP, DeepLabV3/V3+ heads, model factory
- ``kd``       — cheap-conv replacement surgery, KD losses, progressive schedule
- ``data``     — VOC/Cityscapes datasets, joint transforms, device prefetch
- ``train``    — jitted train/eval steps, optimizer groups, checkpointing
- ``parallel`` — mesh/sharding helpers (SPMD data parallelism)
- ``utils``    — streaming segmentation metrics, visualization
"""

__version__ = "0.1.0"
