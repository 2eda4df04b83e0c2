"""The card's milliseconds a training step in the victim's input
backward (K2, cuDNN's dgrad, and the patch-only terms' few kernels): the
program's span ``train.victim_bwd``, from the backward's start to the
gradient at the victim's input; it moves ``train_img_per_s``."""

from benchmark.spans import victim_bwd_ms as read  # noqa: F401
