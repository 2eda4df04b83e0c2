"""The host's milliseconds a training step issuing the rest of the step:
the program's spans ``train.inputs``, ``train.loss`` and
``train.update`` by the host clock; it moves
``train_img_per_s.coco416``."""

from benchmark.spans import loss_update_host_ms as read  # noqa: F401
