"""Host milliseconds to issue one training step: the host clock around
each untraced ``epoch_fn`` call, before any synchronize, over its steps.
Near the step's wall time the host sets the pace (or waits on a full
launch queue); it moves ``train_img_per_s.coco416``."""

from benchmark.readers import host_issue_ms_per_step as read  # noqa: F401
