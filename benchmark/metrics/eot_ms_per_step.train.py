"""The card's milliseconds a training step in the EOT (``attack/eot.py``,
``ops/affine_mxu.py``): the program's spans ``train.eot`` (median,
jitter, warp, composite) and ``train.eot_bwd`` (their backward into the
patch); it moves ``train_img_per_s``."""

from benchmark.spans import eot_ms as read  # noqa: F401
