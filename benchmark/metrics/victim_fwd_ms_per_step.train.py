"""The card's milliseconds a training step in the victim's forward
(``models/darknet.py``: K1 ``save_acts``, cuDNN, the elementwise
layers): the program's span ``train.victim_fwd``; it moves
``train_img_per_s``."""

from benchmark.spans import victim_fwd_ms as read  # noqa: F401
