"""PyTorch + CUDA port of the adversarial-patch creation-attack framework,
for one NVIDIA H100.

It mirrors the JAX package's layout (``models/ ops/ evals/ data/ cli/``)
and keeps its public layouts: NHWC images in, raw heads
``[B, S, S, 3*(5+C)]`` float32 out in the order stride 32/16/8, and the
planar ``[B, H, C, Wl]`` rows of ``ops.planar_conv.to_planar``.

- ``data``   class names, anchor groups, printable colors; image loading,
             label files, the training dataset and loader.
- ``models`` darknet cfg parsing, the ``Darknet`` module (BN-folded,
             channels_last), darknet ``.weights`` I/O.
- ``ops``    the hand-written Hopper kernels (``csrc/``) behind their
             wrappers, each beside its plain PyTorch version; box decode
             and NMS.
- ``evals``  the ``Detector`` and the micro-batching ``DetectionService``.
- ``attack`` the EOT patch pipeline (draws apart from transforms) and the
             creation losses.
- ``train``  experiment configs, the amsgrad patch optimizer and the
             ``PatchTrainer``.
- ``parallel`` data parallelism on ``torch.distributed``, one process a
             card.
- ``utils``  patch PNGs, training checkpoints, tracing and step timing.
- ``cli``    ``python -m <package>.cli.serve``, ``...cli.train_patch``.

Every entry point takes ``device=`` (default ``"cuda"``) and raises when
that device is missing; it never falls back to the CPU. A kernel wrapper
runs its plain version only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"

from . import (attack, data, evals, models, ops, parallel, train,  # noqa: E402,F401
               utils)
