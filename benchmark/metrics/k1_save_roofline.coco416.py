"""K1 with ``save_acts`` (``csrc/stem_fused.cu``:
``fused_stem_fwd_wg_kernel<true>``) against its roofline at the cell's
batch and size: the larger of its bytes over the HBM rate and its
operations over the bfloat16 rate, per launch, over its traced time."""

from benchmark.kernels import (masks_written, stem_flops, x_phases_read,
                               y5_written)
from benchmark.readers import roofline_share

PATTERN = r"fused_stem_fwd_wg_kernel<true>"


def read(r):
    b, h = r.env.traffic["batch"], r.env.config["img_size"]
    return roofline_share(r, PATTERN, x_phases_read(b, h) + y5_written(b, h)
                          + masks_written(b, h), stem_flops(b, h))
