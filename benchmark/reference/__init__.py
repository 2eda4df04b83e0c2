"""The benchmark's plain reference: float32 PyTorch and NumPy only.

It imports neither JAX nor the package under test. It rebuilds from the
configuration file and the benchmark's own inputs everything it
compares: the victim from its darknet cfg (``cfg``, ``darknet``), the
EOT composite from replayed draws and the creation losses (``attack``),
the amsgrad update, and decode, threshold and greedy NMS (``detect``). ``quant`` rounds every value the
program stores (victim and EOT warp) to a lower format: "fp8" (float8
e4m3 under per-tensor scales) is the control that has to fail the
comparison; "bf16", the configuration's own precision, is the witness
that a sound program reads like.
"""
