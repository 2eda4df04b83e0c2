from .checkpoint import (save_patch_png, load_patch_png, patch_png_mse,
    save_checkpoint, load_checkpoint)
from .profiling import StepTimer, trace, annotate
