"""The card's milliseconds a training step in the rest of the step: the
program's spans ``train.inputs`` (the batch gathered from the store,
the EOT draws), ``train.loss`` (the losses) and ``train.update``
(amsgrad, the clip); it moves ``train_img_per_s``."""

from benchmark.spans import loss_update_ms as read  # noqa: F401
