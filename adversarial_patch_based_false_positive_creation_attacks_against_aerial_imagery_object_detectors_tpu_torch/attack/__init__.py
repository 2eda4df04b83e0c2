from .eot import (
    EOTConfig, EOTDraws, draw_eot, transform_patch, warp_patch, paste_patch,
    apply_eot_patch, select_reference_box, patch_scale_and_center,
    photometric_jitter, max_zoom_window,
)
from .losses import (
    nps_loss, total_variation, colorfulness, extract_cell_scores,
    weighted_mean, creation_obj_loss, creation_cls_ce_loss,
    creation_cls_margin_loss, max_prob_extract, max_combined_prob,
)
from .eot_eval import (
    EvalEOTConfig, transform_patch_eval, interference_map,
    select_reference_box_7col, mask_semi_edge,
)
from .vanishing import (
    VanishingConfig, VanishingDraws, draw_vanishing,
    transform_patch_vanishing, paste_vanishing,
)
from .pgd import (PGDConfig, make_pgd_fabrication, fabrication_loss,
                  fabrication_grad)
