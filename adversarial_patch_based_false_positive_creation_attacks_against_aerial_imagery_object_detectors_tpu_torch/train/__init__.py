from .config import (
    ExperimentConfig, EXPERIMENTS, LOSS_RECIPES, get_experiment,
    combine_loss_target,
)
from .optim import make_optimizer, amsgrad_step
from .trainer import (
    PatchTrainer, ReduceLROnPlateau, make_loss_fn, make_train_step,
    make_epoch_scan_fn, local_draws,
    init_patch, build_victim, eot_config, compute_dtype, LOSS_KEYS,
)
