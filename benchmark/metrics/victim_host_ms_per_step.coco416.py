"""The host's milliseconds a training step issuing the victim's forward
and input backward: the program's spans ``train.victim_fwd`` and
``train.victim_bwd`` by the host clock; it moves
``train_img_per_s.coco416``."""

from benchmark.spans import victim_host_ms as read  # noqa: F401
