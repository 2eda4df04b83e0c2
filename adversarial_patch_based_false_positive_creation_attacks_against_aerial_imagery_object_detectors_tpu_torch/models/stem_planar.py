"""Geometry test and parameters of the YOLOv3 stem (layers 0-5), shared by
the fused stem kernel (``ops/stem_fused.py``). The per-layer planar stem
of the JAX package (``planar_stem``) waits for the generic planar conv
kernel (K4)."""

from __future__ import annotations

import torch

# layer indices of the stem's convs in the yolov3 block list
STEM_CONVS = (0, 1, 2, 3, 5)


def stem_applicable(net, params, x_shape) -> bool:
    """Layers 0..5 must match conv(3,s1)+conv(3,s2)+conv(1)+conv(3)+
    shortcut(1)+conv(3,s2), leaky, BN-folded, square input divisible by
    32, and nothing outside the stem may consume outputs 0..4."""
    return stem_net_applicable(net, params) and stem_shape_ok(x_shape)


def stem_net_applicable(net, params) -> bool:
    """The network and params half of ``stem_applicable``."""
    if len(net.layers) < 6:
        return False
    kinds = [l.kind for l in net.layers[:6]]
    if kinds != ["convolutional"] * 4 + ["shortcut", "convolutional"]:
        return False
    convs = [net.layers[i].conv for i in (0, 1, 2, 3, 5)]
    geom = [(c.size, c.stride) for c in convs]
    if geom != [(3, 1), (3, 2), (1, 1), (3, 1), (3, 2)]:
        return False
    if any(c.activation != "leaky" for c in convs):
        return False
    if net.layers[4].shortcut_from != 1:
        return False
    # nothing OUTSIDE the stem may consume the stem's internals
    for l in net.layers[6:]:
        if any(s < 5 for s in l.route_from) or -1 < l.shortcut_from < 5:
            return False
    return not any("gamma" in params.get(f"conv_{i}", {})
                   for i in STEM_CONVS)


def stem_shape_ok(x_shape) -> bool:
    """The input half of ``stem_applicable``: NHWC, 3 channels, square,
    divisible by 32."""
    b, h, w, c = x_shape
    return (c == 3 and h == w and h % 32 == 0 and h >= 64
            and (h // 4) % 8 == 0)


def _stem_params(params, compute_dtype):
    """[(HWIO weight in compute_dtype, float32 bias)] for convs 0,1,2,3,5,
    contiguous: the layout the fused stem kernel reads (and the JAX
    package's). ``params`` holds OIHW weights."""
    out = []
    for i in STEM_CONVS:
        p = params[f"conv_{i}"]
        out.append((p["w"].to(compute_dtype).permute(2, 3, 1, 0).contiguous(),
                    p["b"].to(torch.float32).contiguous()))
    return out
