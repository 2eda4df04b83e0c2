"""Share of the traced window of training in which no kernel, copy or
set ran on the card; it moves ``train_img_per_s.coco416``."""

from benchmark.readers import device_idle as read  # noqa: F401
