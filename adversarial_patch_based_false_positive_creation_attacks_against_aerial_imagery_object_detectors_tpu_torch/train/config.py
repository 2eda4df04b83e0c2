"""Experiment configuration.

Replaces the reference's three-tier config sprawl (class hierarchy in
patch_config.py + module constants train_patch.py:25-28 / load_data.py:32
+ comment-toggled loss blocks train_patch.py:252-314) with one frozen
dataclass and named loss recipes.

The registry mirrors the reference's experiment modes
(patch_config.py:166-174) value-for-value: lr 0.03 Adam(amsgrad), patch
224, plateau patience 50, TV factor 2.5, NPS factor 0.01, target class 14
(helicopter), 401 epochs, max 252 labels/image.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

# The five loss recipes documented in the reference trainer
# (train_patch.py:291-314). "creation_colorful" is the active default.
LOSS_RECIPES = (
    "det_creation",        # (1) det + nps + tv' + no_obj + no_cls
    "creation_ce",         # (2) nps + tv' + no_obj + no_cls(CE)
    "clsconf_creation",    # (3) cls_conf + nps + tv' + no_obj + no_cls
    "untargeted_obj",      # (4) nps + tv' + no_obj
    "creation_colorful",   # (5) nps + tv' + no_obj + colorful + no_cls
)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "base"
    # data
    img_dir: str = "data/trainset/images"
    lab_dir: str = "data/trainset/yolo-labels"
    img_dir_test: str = "data/testset/images"
    lab_dir_test: str = "data/testset/yolo-labels"
    img_size: int = 608
    max_labels: int = 252
    # victim detector
    cfgfile: Optional[str] = None        # None -> built-in yolov3-dota spec
    weightfile: Optional[str] = None     # darknet .weights path
    num_classes: int = 15
    # patch / optimization
    patch_size: int = 224
    batch_size: int = 16
    learning_rate: float = 0.03
    max_epochs: int = 401
    plateau_patience: int = 50
    plateau_factor: float = 0.1
    # carried value-for-value from the reference (patch_config.py:47-158
    # assigns per-experiment max_tv) but READ NOWHERE — true of the
    # reference too: nothing consumes it there either. Config parity
    # only, not a wiring bug.
    max_tv: float = 0.0
    # loss recipe + weights
    loss_recipe: str = "creation_colorful"
    tv_factor: float = 2.5
    nps_factor: float = 0.01
    tv_floor: float = 0.1                # torch.max(tv_loss, 0.1)
    target_id: int = 14                  # helicopter
    # reference quirk: cell index x/y-swapped (train_patch.py:461-467);
    # False = geometrically faithful cell
    cell_swap_xy: bool = True
    # loss_target combiner for the legacy max-prob recipes:
    # "obj", "cls", "obj*cls", or "0.2*obj+0.8*cls"
    loss_target: str = "obj*cls"
    # EOT
    scale_factor: float = 2.0
    do_rotate: bool = True
    photometric: bool = True
    warp_method: str = "mxu"             # "mxu" | "gather" (exact)
    # dtype of the EOT's geometric half (warp + composite):
    # "compute" follows compute_dtype (the detector consumes it anyway;
    # halves the 608^2-canvas HBM traffic), "float32" keeps the exact
    # widths of the reference
    warp_dtype: str = "compute"
    # runtime
    compute_dtype: str = "bfloat16"      # detector conv dtype on TPU
    checkpoint_every: int = 20           # epochs (reference: patch PNG)
    debug_nans: bool = False             # detect_anomaly equivalent


def combine_loss_target(name: str) -> Callable:
    """The reference's ``loss_target`` lambdas (patch_config.py:51,123,
    141,161) by name."""
    return {
        "obj": lambda obj, cls: obj,
        "cls": lambda obj, cls: cls,
        "obj*cls": lambda obj, cls: obj * cls,
        "0.2*obj+0.8*cls": lambda obj, cls: 0.2 * obj + 0.8 * cls,
    }[name]


def _cfg(**kw) -> ExperimentConfig:
    return ExperimentConfig(**kw)


EXPERIMENTS: Dict[str, ExperimentConfig] = {
    "base": _cfg(name="base"),
    "exp1": _cfg(name="exp1", max_tv=0.165),
    "exp2_high_res": _cfg(name="exp2_high_res", max_tv=0.165,
                          patch_size=400),
    "exp3_low_res": _cfg(name="exp3_low_res", max_tv=0.165, patch_size=100),
    "exp4_class_only": _cfg(name="exp4_class_only", max_tv=0.165,
                            batch_size=8, loss_target="cls"),
    "obj_cls": _cfg(name="obj_cls", max_tv=0.165, batch_size=12,
                    loss_target="0.2*obj+0.8*cls"),
    "paper_obj": _cfg(name="paper_obj", max_tv=0.165, batch_size=24,
                      loss_target="obj"),
}


def get_experiment(name: str, **overrides) -> ExperimentConfig:
    cfg = EXPERIMENTS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
