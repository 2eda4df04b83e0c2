"""K2, the stem's input backward from saved masks (``csrc/stem_bwd.cu``:
``fused_stem_bwd_wg_kernel``), against its roofline at the cell's batch
and size, per launch, over its traced time."""

from benchmark.kernels import k2_bytes, stem_flops
from benchmark.readers import roofline_share

PATTERN = r"fused_stem_bwd_wg_kernel"


def read(r):
    b, h = r.env.traffic["batch"], r.env.config["img_size"]
    return roofline_share(r, PATTERN, k2_bytes(b, h), stem_flops(b, h))
