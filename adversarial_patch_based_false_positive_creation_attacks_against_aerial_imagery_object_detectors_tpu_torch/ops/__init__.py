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
