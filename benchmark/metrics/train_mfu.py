"""Model FLOP utilisation of patch training (``readers.train_mfu``); it
moves ``train_img_per_s``."""

from benchmark.readers import train_mfu as read  # noqa: F401
