"""The host's milliseconds a training step issuing the EOT: the program's
spans ``train.eot`` and ``train.eot_bwd`` by the host clock. In a cell
the host paces, a layer whose host time reaches its device time keeps
the card idle; it moves ``train_img_per_s.coco416``."""

from benchmark.spans import eot_host_ms as read  # noqa: F401
