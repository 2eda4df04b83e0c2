from .median_pool import (median_pool_2d, median_pool_nhwc,
    median_pool_2d_fast, median_pool_nhwc_fast, median_select)
from .decode import decode_head, decode_all_heads, head_cell_scores
from .nms import (iou_xywh_matrix, greedy_nms_host, greedy_nms_device,
    greedy_nms_device_batch)
from .planar_conv import (to_planar, from_planar, to_planar_plain,
    from_planar_plain)
from .stem_fused import (split_phases, merge_phases, fused_applicable,
    fused_stem_fwd, fused_stem_fwd_plain, fused_stem, FusedStem,
    fused_stem_bwd_saved, fused_stem_bwd_saved_plain, stem_bwd_params)

# the kernels' launch counters (the experimental package's aside) by
# kernel entry name: (module of this package, wrapper, attribute); each
# wrapper adds one to its attribute where it launches that kernel, and
# nowhere else
LAUNCH_COUNTERS = {
    "to_planar": ("planar_conv", "to_planar", "launches"),
    "to_planar_phases": ("planar_conv", "to_planar", "phases_launches"),
    "to_planar_g5": ("planar_conv", "to_planar", "tiled_launches"),
    "fused_stem_fwd": ("stem_fused", "fused_stem_fwd", "launches"),
    "fused_stem_fwd_save_acts": ("stem_fused", "fused_stem_fwd",
                                 "save_acts_launches"),
    "from_planar": ("planar_conv", "from_planar", "launches"),
    "from_planar_narrow": ("planar_conv", "from_planar", "narrow_launches"),
    "fused_stem_bwd_saved": ("stem_fused", "fused_stem_bwd_saved",
                             "launches"),
    "planar_conv_k1": ("planar_conv", "planar_conv", "launches_k1"),
    "planar_conv_k3": ("planar_conv", "planar_conv", "launches_k3"),
    "planar_conv_k3s2": ("planar_conv", "planar_conv", "launches_k3s2"),
    "planar_conv_k3t2": ("planar_conv", "planar_conv", "launches_k3t2"),
    "res152_fused": ("res_fused", "res152_fused", "launches"),
    "res152_fused_save": ("res_fused", "res152_fused", "save_launches"),
    "res152_fused_grad": ("res_fused", "res152_fused_grad", "launches"),
    "fused_stem_bwd": ("stem_fused", "fused_stem_bwd", "launches"),
    "res152_fused_grad12": ("res_fused", "res152_fused_grad12", "launches"),
    "affine_warp_mxu": ("affine_mxu", "affine_warp_mxu", "launches"),
    "affine_warp_mxu_bwd": ("affine_mxu", "affine_warp_mxu", "bwd_launches"),
}


def kernel_launches(reset: bool = False) -> dict:
    """Each counter of ``LAUNCH_COUNTERS``; with ``reset`` each is set to
    0 first."""
    import importlib
    out = {}
    for name, (mod, fn, attr) in LAUNCH_COUNTERS.items():
        wrapper = getattr(importlib.import_module(f"{__name__}.{mod}"), fn)
        if reset:
            setattr(wrapper, attr, 0)
        out[name] = getattr(wrapper, attr)
    return out
