"""The 152^2 residual stage (layers 6-11: conv 1x1 c->c/2, conv 3x3
c/2->c, shortcut, twice) off the conv walk, the JAX package's
``models/res_planar.py``. Two routes, each an autograd Function that
returns the input cotangent only (the victim's weights are frozen):

- ``res152_planar``: the per-layer planar kernels (K4). The forward keeps
  the pre-residual conv outputs a, post7, c, post10 (their signs are the
  leaky masks the backward needs); the backward is the flipped-kernel K4
  chain with each mask in the producing conv's epilogue (``gate``)
  wherever the cotangent is consumed once, and elementwise at the two
  shortcut branch points (g11, g8), which are consumed twice.
- ``res152_fused_stage``: the whole-stage kernels. Forward K3a -> K6a
  (with its int8 masks when grad is recorded) -> K3b; backward K3a -> K6b
  -> K3b. Width 128 only (the kernels' stage width).

Both take and give NHWC [B, H, W, C] in the compute dtype.

- ``res152_c12_fused``: the conv12-widened unit (layers 6-12). It takes
  the stem's planar y5 (``ops/stem_fused.fused_stem_planar``) and gives
  NHWC y12: K6a on the planar y5 (no K3a), K3b of y11, conv12 + bias +
  leaky on cuDNN (the JAX package leaves conv12's forward to XLA). Its
  backward gates g12 by conv12's leaky, K3a (256 channels) -> K6c, which
  computes conv12's dgrad itself, and returns a planar g5 (no K3b).
"""

from __future__ import annotations

import torch

from ..ops import res_fused as RF
from ..ops.planar_conv import (from_planar, leaky_bwd_planar, planar_conv,
                               to_planar)

# layer indices of the stage's convs in the yolov3 block list
RES152_CONVS = (6, 7, 9, 10)
_STAGE = range(6, 12)


def res152_applicable(net, params) -> bool:
    """Layers 6..11 must be two stride-1 leaky residual blocks
    (conv 1x1 c->c/2, conv 3x3 c/2->c, shortcut) over BN-folded params,
    with nothing outside the stage consuming its internals. (The JAX
    package's ``res152_applicable`` takes an input shape it does not
    read.)"""
    if len(net.layers) < 12 or net.layers[5].conv is None:
        return False
    kinds = [net.layers[i].kind for i in _STAGE]
    if kinds != ["convolutional", "convolutional", "shortcut"] * 2:
        return False
    c_in = net.layers[5].conv.filters
    convs = [net.layers[i].conv for i in RES152_CONVS]
    geom = [(c.size, c.stride, c.filters) for c in convs]
    half = c_in // 2
    if geom != [(1, 1, half), (3, 1, c_in)] * 2:
        return False
    if any(c.activation != "leaky" for c in convs):
        return False
    if (net.layers[8].shortcut_from != 5
            or net.layers[11].shortcut_from != 8):
        return False
    if any("gamma" in params.get(f"conv_{i}", {}) for i in RES152_CONVS):
        return False
    # nothing outside 6..11 may consume the stage's internals (5..10)
    for l in net.layers[12:]:
        if any(5 <= s < 11 for s in l.route_from) or 5 <= l.shortcut_from < 11:
            return False
    return True


def fused_res_net_applicable(net, params) -> bool:
    """The network half of ``fused_res_applicable``: ``res152_applicable``
    at the kernels' stage width (128)."""
    return (res152_applicable(net, params)
            and net.layers[5].conv.filters == RF.CIN)


def fused_res_shape_ok(x_shape) -> bool:
    """The input half: a square image whose stage height (H/4) is even."""
    return x_shape[1] == x_shape[2] and (x_shape[1] // 4) % 2 == 0


def _pick_s(h: int) -> int:
    """The JAX package's stripe height for a stage of height h."""
    for s in (8, 4, 2):
        if h % s == 0:
            return s
    raise ValueError(f"stage height {h} not even")


def fused_res_applicable(net, params, x_shape) -> bool:
    """``res152_applicable`` plus the whole-stage kernels' constraints: the
    yolov3 width of record (128) and an even stage height."""
    return fused_res_net_applicable(net, params) and fused_res_shape_ok(
        x_shape)


def _forward(xp, fwd):
    """xp: planar [B, H, C, Wl]. Returns (y11, a, post7, c, post10)."""
    (w6, b6), (w7, b7), (w9, b9), (w10, b10) = fwd
    a = planar_conv(xp, w6, b6, k=1)
    post7 = planar_conv(a, w7, b7, k=3)
    y8 = post7 + xp
    c = planar_conv(y8, w9, b9, k=1)
    post10 = planar_conv(c, w10, b10, k=3)
    return post10 + y8, a, post7, c, post10


class Res152Planar(torch.autograd.Function):
    """``res152_planar`` with the JAX package's ``_res_bwd``."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        y11, *acts = _forward(to_planar(x), fwd)
        ctx.save_for_backward(*acts)
        ctx.bwd = bwd
        return from_planar(y11, x.shape[2], x.shape[3])

    @staticmethod
    def backward(ctx, g):
        a, post7, c, post10 = ctx.saved_tensors
        (w6t, z6), (w7t, z7), (w9t, z9), (w10t, z10) = ctx.bwd
        g11 = to_planar(g.to(a.dtype).contiguous())
        g_pre10 = leaky_bwd_planar(g11, post10)
        g_pre9 = planar_conv(g_pre10, w10t, z10, k=3, slope=None, gate=c)
        g8 = planar_conv(g_pre9, w9t, z9, res=g11, k=1, slope=None)
        g_pre7 = leaky_bwd_planar(g8, post7)
        g_pre6 = planar_conv(g_pre7, w7t, z7, k=3, slope=None, gate=a)
        g_xp = planar_conv(g_pre6, w6t, z6, res=g8, k=1, slope=None)
        return from_planar(g_xp, g.shape[2], g.shape[3]), None, None


def res152_planar(x: torch.Tensor, fwd, bwd=None) -> torch.Tensor:
    """NHWC [B, H, W, C] -> NHWC, layers 6-11 on the per-layer planar
    kernels. ``fwd``: ``stem_planar._stem_params(params, dtype, RES152_CONVS)``'s pairs; ``bwd``: the flipped
    kernels with zero float32 biases, needed where autograd records."""
    if x.requires_grad and torch.is_grad_enabled():
        if bwd is None:
            raise ValueError("res152_planar: an input that requires grad "
                             "needs the backward weights (bwd)")
        return Res152Planar.apply(x, fwd, bwd)
    y11 = _forward(to_planar(x), fwd)[0]
    return from_planar(y11, x.shape[2], x.shape[3])


class Res152FusedStage(torch.autograd.Function):
    """The whole-stage kernels with the saved-mask backward."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        y11p, *masks = RF.res152_fused(to_planar(x), fwd, save=True,
                                       w_img=x.shape[2])
        ctx.save_for_backward(*masks)
        ctx.bwd = bwd
        return from_planar(y11p, x.shape[2], x.shape[3])

    @staticmethod
    def backward(ctx, g):
        masks = ctx.saved_tensors
        g11p = to_planar(g.to(ctx.bwd[0].dtype).contiguous())
        g5p = RF.res152_fused_grad(g11p, masks, ctx.bwd, w_img=g.shape[2])
        return from_planar(g5p, g.shape[2], g.shape[3]), None, None


def res152_fused_stage(x: torch.Tensor, fwd, bwd=None) -> torch.Tensor:
    """NHWC [B, H, W, 128] -> NHWC, layers 6-11 through K3a -> K6a -> K3b
    (``fwd``, ``bwd``: ``ops/res_fused.res_weights``'s halves); where
    autograd records, K6a saves its masks and the backward is K3a -> K6b
    -> K3b."""
    if x.requires_grad and torch.is_grad_enabled():
        if bwd is None:
            raise ValueError("res152_fused_stage: an input that requires "
                             "grad needs the backward weights (bwd)")
        return Res152FusedStage.apply(x, fwd, bwd)
    y11p = RF.res152_fused(to_planar(x), fwd, w_img=x.shape[2])
    return from_planar(y11p, x.shape[2], x.shape[3])


# ---------------------------------------------------------------------------
# The conv12-widened unit: planar y5 in, conv12 inside the backward kernel
# ---------------------------------------------------------------------------

C12 = 12   # conv12's layer index


def c12_net_applicable(net, params) -> bool:
    """The network half of ``c12_applicable``: ``fused_res_net_applicable``
    plus layer 12 the stride-2 3x3 leaky conv 128 -> 256 over BN-folded
    params, with nothing after it consuming the stage's internals or
    layer 11 (which the unit keeps inside)."""
    if not fused_res_net_applicable(net, params):
        return False
    if len(net.layers) <= C12 or net.layers[C12].kind != "convolutional":
        return False
    c12 = net.layers[C12].conv
    if ((c12.size, c12.stride, c12.filters) != (3, 2, 2 * RF.CIN)
            or c12.activation != "leaky"):
        return False
    if "gamma" in params.get(f"conv_{C12}", {}):
        return False
    for l in net.layers[C12 + 1:]:
        if any(5 <= s < C12 for s in l.route_from) or \
                5 <= l.shortcut_from < C12:
            return False
    return True


def c12_shape_ok(x_shape) -> bool:
    """The input half: ``fused_res_shape_ok`` and a JAX stripe height
    (``_pick_s`` of the stage height) that halves into a multi-row conv12
    stripe, as the JAX package requires, so that both take the route on
    the same inputs."""
    return (fused_res_shape_ok(x_shape)
            and _pick_s(x_shape[1] // 4) % 4 == 0)


def c12_applicable(net, params, x_shape) -> bool:
    """The JAX package's ``c12_applicable``."""
    return c12_net_applicable(net, params) and c12_shape_ok(x_shape)


def _conv12(y11: torch.Tensor, w12: torch.Tensor, b12: torch.Tensor):
    """conv12 + bias + leaky on NHWC y11 in the compute dtype, as the conv
    walk runs it (``w12`` OIHW channels_last, ``b12`` in the compute
    dtype): NHWC y12 and the int8 mask of z12 > 0, NHWC too."""
    from .darknet import _activate
    z = torch.nn.functional.conv2d(y11.permute(0, 3, 1, 2), w12, None, 2, 1)
    z = z + b12.view(1, -1, 1, 1)
    y12 = _activate(z, "leaky")
    return (y12.permute(0, 2, 3, 1),
            (z > 0).to(torch.int8).permute(0, 2, 3, 1))


class Res152C12(torch.autograd.Function):
    """The JAX package's ``res152_c12_fused`` custom VJP."""

    @staticmethod
    def forward(ctx, y5p, fwd, bwd, w12, b12, w12t):
        y11p, *masks = RF.res152_fused(y5p, fwd, save=True)
        y12, m12 = _conv12(from_planar(y11p, y5p.shape[1], RF.CIN), w12,
                           b12)
        ctx.save_for_backward(*masks, m12)
        ctx.bwd, ctx.w12t = bwd, w12t
        return y12

    @staticmethod
    def backward(ctx, g12):
        *masks, m12 = ctx.saved_tensors
        dt = ctx.w12t.dtype
        gp12 = g12.to(dt) * torch.where(m12 > 0, 1.0, 0.1).to(dt)
        g5p = RF.res152_fused_grad12(to_planar(gp12.contiguous()), masks,
                                     ctx.bwd, ctx.w12t)
        return g5p, None, None, None, None, None


def res152_c12_fused(y5p: torch.Tensor, fwd, bwd, w12: torch.Tensor,
                     b12: torch.Tensor, w12t: torch.Tensor = None
                     ) -> torch.Tensor:
    """Planar y5 [B, H, 128, Wl] -> NHWC y12 [B, H/2, W/2, 256] (layers
    6-12). ``fwd``, ``bwd``: ``ops/res_fused.res_weights``'s halves;
    ``w12`` OIHW channels_last and ``b12`` in the compute dtype (the
    walk's); ``w12t``: ``res12_weights``'s. Where autograd records,
    ``Res152C12`` (K6a with masks; the backward K3a -> K6c returns a
    planar g5); otherwise K6a -> K3b -> conv12."""
    if y5p.requires_grad and torch.is_grad_enabled():
        if bwd is None or w12t is None:
            raise ValueError("res152_c12_fused: an input that requires grad "
                             "needs the backward weights (bwd, w12t)")
        return Res152C12.apply(y5p, fwd, bwd, w12, b12, w12t)
    y11p = RF.res152_fused(y5p, fwd)
    return _conv12(from_planar(y11p, y5p.shape[1], RF.CIN), w12, b12)[0]
