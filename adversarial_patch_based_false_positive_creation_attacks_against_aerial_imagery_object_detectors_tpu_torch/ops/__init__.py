from .decode import decode_head, decode_all_heads, head_cell_scores
from .nms import (iou_xywh_matrix, greedy_nms_host, greedy_nms_device,
    greedy_nms_device_batch)
from .planar_conv import (to_planar, from_planar, to_planar_plain,
    from_planar_plain)
from .stem_fused import (split_phases, merge_phases, fused_applicable,
    fused_stem_fwd, fused_stem_fwd_plain, fused_stem)
