"""The YOLOv3 stem (layers 0-5): its geometry test and parameters, shared
with the fused stem kernel (``ops/stem_fused.py``), and the per-layer
planar stem ``planar_stem`` on the generic planar conv (K4), the JAX
package's ``models/stem_planar.py``.

``planar_stem`` keeps the activations planar across the whole stem: one
layout conversion in at C = 3 (K3a, channels padded to 8), five K4 convs
with the block-1 shortcut as a planar add between them, one conversion out
(K3b). Its backward (``PlanarStem``) runs on K4 too, over the saved planar
activations (leaky's input sign is its output's, so no pre-activation is
kept): stride-1 and 1x1 input cotangents are flipped, channel-swapped
kernels; the two stride-2 ones are the JAX package's zero interleave
(``expand2_planar``) followed by the same stride-1 conv, the exact adjoint
of the forward's conv-then-decimate, run as K4's adjoint variant
(``planar_conv_t2``) on the unexpanded cotangent; the y2, y1 and y0 leaky
masks ride in the convs' epilogues (``gate``). Any width ladder of this geometry works
(the output width is conv5's). Only the input cotangent is returned: the
victim's weights are frozen.
"""

from __future__ import annotations

import torch

from ..ops.planar_conv import (flip_t, from_planar, leaky_bwd_planar,
                               pad_cin, pad_cout, planar_conv,
                               planar_conv_t2, to_planar)

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


def _stem_params(params, compute_dtype, convs=STEM_CONVS):
    """[(HWIO weight in compute_dtype, float32 bias)] for ``convs`` (the
    stem's 0,1,2,3,5 by default), contiguous: the layout the kernels read
    (and the JAX package's). ``params`` holds OIHW weights."""
    out = []
    for i in convs:
        p = params[f"conv_{i}"]
        out.append((p["w"].to(compute_dtype).permute(2, 3, 1, 0).contiguous(),
                    p["b"].to(torch.float32).contiguous()))
    return out


def planar_stem_params(sp):
    """K4's weights for ``planar_stem`` from ``_stem_params`` pairs, built
    once by the model: the forward's (HWIO weight, float32 bias) with
    conv0's input channels padded 3 -> 8 (the planar input's), and the
    backward's flipped, channel-swapped kernels (conv0's output channels
    thereby 8, the JAX package's ``_pad_cout``) with their zero biases."""
    fwd = [(pad_cin(w, 8).contiguous() if i == 0 else w, b)
           for i, (w, b) in enumerate(sp)]
    bwd = []
    for w, _ in fwd:
        wt = pad_cout(flip_t(w)).contiguous()
        bwd.append((wt, torch.zeros(wt.shape[-1], dtype=torch.float32,
                                    device=w.device)))
    return fwd, bwd


def _forward(x, fwd):
    """x: NHWC [B, H, W, 3] in the compute dtype. Returns the planar
    activations (y0, y1, y2, y3, y5)."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3), (w5, b5) = fwd
    xp = to_planar(x, c_pad=8)
    y0 = planar_conv(xp, w0, b0, k=3)
    y1 = planar_conv(y0, w1, b1, k=3, stride=2)
    y2 = planar_conv(y1, w2, b2, k=1)
    # the shortcut stays out of conv3's kernel: the backward reads leaky's
    # input sign from conv3's own (pre-residual) output
    y3 = planar_conv(y2, w3, b3, k=3)
    y5 = planar_conv(y3 + y1, w5, b5, k=3, stride=2)
    return y0, y1, y2, y3, y5


def _stem_bwd(acts, g5, bwd, h):
    """The JAX package's ``_stem_bwd``: the input cotangent NHWC
    [B, h, h, 3] from the planar activations and the output cotangent g5
    (NHWC, the compute dtype)."""
    y0, y1, y2, y3, y5 = acts
    (w0t, z0), (w1t, z1), (w2t, z2), (w3t, z3), (w5t, z5) = bwd
    gp5 = leaky_bwd_planar(to_planar(g5), y5)
    # the stride-2 adjoints: planar_conv(expand2_planar(g), wt, ...) as
    # K4's variant on the unexpanded g
    g_sc = planar_conv_t2(gp5, w5t, z5, w_img=h // 4)
    # the shortcut's output feeds conv3's branch and y1: g_sc is consumed
    # twice, so its mask cannot ride in an epilogue
    gp3 = leaky_bwd_planar(g_sc, y3)
    gp2 = planar_conv(gp3, w3t, z3, k=3, slope=None, gate=y2)
    gp1 = planar_conv(gp2, w2t, z2, res=g_sc, k=1, slope=None, gate=y1)
    gp0 = planar_conv_t2(gp1, w1t, z1, w_img=h // 2, gate=y0)
    gx0 = planar_conv(gp0, w0t, z0, k=3, slope=None)
    return from_planar(gx0, h, 3)


class PlanarStem(torch.autograd.Function):
    """``planar_stem`` with its hand backward (``_stem_bwd``), all on K4
    (and K3a / K3b at the boundaries). Returns the input cotangent only."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        acts = _forward(x, fwd)
        ctx.save_for_backward(*acts)
        ctx.bwd = bwd
        return from_planar(acts[4], x.shape[1] // 4, fwd[4][0].shape[-1])

    @staticmethod
    def backward(ctx, g5):
        acts = ctx.saved_tensors
        h = acts[0].shape[1]
        g5 = g5.to(acts[4].dtype).contiguous()
        return _stem_bwd(acts, g5, ctx.bwd, h), None, None


def planar_stem(x: torch.Tensor, fwd, bwd=None) -> torch.Tensor:
    """NHWC [B, H, W, 3] (compute dtype, contiguous) -> NHWC
    [B, H/4, W/4, cout] through the per-layer planar kernels. ``fwd`` and
    ``bwd`` are ``planar_stem_params``'s; where autograd records
    (``x.requires_grad``) the forward saves its planar activations for
    ``PlanarStem``'s backward, otherwise it keeps none."""
    if x.requires_grad and torch.is_grad_enabled():
        if bwd is None:
            raise ValueError("planar_stem: an input that requires grad "
                             "needs the backward weights (bwd)")
        return PlanarStem.apply(x, fwd, bwd)
    y5 = _forward(x, fwd)[4]
    return from_planar(y5, x.shape[1] // 4, fwd[4][0].shape[-1])
