"""Measured dead ends of the JAX package, kept so the comparison can be
re-run on this hardware; NOT wired into any default path.

Each module is the JAX package's ``experimental/`` module of the same name,
exact against it on the CPU and against its own plain version on the card:

- ``median_pallas``: the median filter (K7, ``csrc/median_pool.cu``: a
  selection network for k <= 8, rank counting above, both exact against
  the rank-counting plain version), beside the shipped
  ``ops/median_pool.py`` forward.
- ``stem_batched``: the batch-on-lanes stem megakernels (K8a forward, K8b
  input backward, ``csrc/stem_batched.cu``) and their NHWC <-> lanes glue,
  beside the shipped ``ops/stem_fused.py`` (K3a -> K1 -> K3b, K3a -> K2).
- ``packed_stem``: the space-to-depth rewrite of the first two convs (plain
  convs), reachable through ``Darknet(...)(x, packed_stem=True)``.

``chip_smoke.py`` phase 9 times each against what ships (``PERF.md``).
Nothing imports this package on a default path: the packed stem is
imported only behind its explicit flag, for BN-folded params.
"""
