"""Space-to-depth packed stem: an exact re-expression of the first two
convs, the JAX package's ``experimental/packed_stem.py``.

The input is packed 2x2 into channels ([B, H/2, W/2, 4C]) and both convs
are rewritten exactly on the packed grid:

- conv0 (3x3/1) becomes four 2x2 convs over 4C channels, one per output
  sub-position (dy, dx), with asymmetric zero padding (1 - dy, dy) rows and
  (1 - dx, dx) columns, concatenated into a 4*C0-channel activation;
- conv1 (3x3/2) becomes one 2x2 stride-1 conv over those channels, padded
  (1, 0) both ways, landing on the normal [H/2, W/2, C1] grid.

The packed kernels are scatters of the original weights (each weight lands
once, so they are exact in any dtype), built once from the params. Plain
PyTorch, as the JAX module has no Pallas. ``models/darknet.py`` takes it
with ``packed_stem=True`` when no kernel stem is taken and the params are
BN-folded.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from ..models.darknet import _activate


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, H/2, W/2, 4C], channel = (dy*2+dx)*C + c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _packed_kernel_conv0(w0: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Original HWIO [3, 3, C, O] kernel -> packed [2, 2, 4C, O] kernel for
    the output sub-position (dy, dx). Tap at original offset (u-1, v-1)
    maps to packed cell (pr, pc) sub (dy', dx')."""
    k, _, c, o = w0.shape
    assert k == 3
    out = torch.zeros((2, 2, 4 * c, o), dtype=w0.dtype, device=w0.device)
    for u in range(3):
        t = dy + u - 1
        pr, dyp = t // 2, t % 2
        ku = pr + (1 - dy)          # pad_lo = 1 - dy
        for v in range(3):
            s = dx + v - 1
            pc, dxp = s // 2, s % 2
            kv = pc + (1 - dx)
            cp = (dyp * 2 + dxp) * c
            out[ku, kv, cp:cp + c, :] += w0[u, v]
    return out


def _packed_kernel_conv1(w1: torch.Tensor) -> torch.Tensor:
    """Original stride-2 HWIO [3, 3, C, O] kernel -> packed stride-1
    [2, 2, 4C, O] kernel (output grid == packed grid). The packed input
    channel layout is (dy*2+dx)*C + c (the conv0 sub-position concat)."""
    k, _, c, o = w1.shape
    assert k == 3
    out = torch.zeros((2, 2, 4 * c, o), dtype=w1.dtype, device=w1.device)
    for u in range(3):
        t = u - 1
        pr, dyp = t // 2, t % 2
        ku = pr + 1                  # pad_lo = 1
        for v in range(3):
            s = v - 1
            pc, dxp = s // 2, s % 2
            kv = pc + 1
            cp = (dyp * 2 + dxp) * c
            out[ku, kv, cp:cp + c, :] += w1[u, v]
    return out


def packed_weights(w0: torch.Tensor, w1: torch.Tensor,
                   compute_dtype: torch.dtype) -> List[torch.Tensor]:
    """conv0's four sub-position kernels (dy, dx in row-major order) and
    conv1's packed kernel from OIHW ``w0``, ``w1``, each OIHW [O, 4C, 2, 2]
    in ``compute_dtype``, ``channels_last``: what ``packed_stem_conv``
    takes, built once."""
    h0, h1 = (w.permute(2, 3, 1, 0) for w in (w0, w1))
    ks = [_packed_kernel_conv0(h0, dy, dx) for dy in range(2)
          for dx in range(2)] + [_packed_kernel_conv1(h1)]
    return [k.permute(3, 2, 0, 1).to(compute_dtype).contiguous(
        memory_format=torch.channels_last) for k in ks]


def _conv2x2(x: torch.Tensor, w: torch.Tensor, pad_r, pad_c) -> torch.Tensor:
    """NCHW 2x2 stride-1 conv with (top, bottom) / (left, right) zero
    padding, in ``x``'s dtype."""
    return F.conv2d(F.pad(x, (*pad_c, *pad_r)), w)


def packed_stem_conv(x: torch.Tensor, kernels: List[torch.Tensor],
                     b0: torch.Tensor, act0: str, b1: torch.Tensor,
                     act1: str) -> torch.Tensor:
    """NHWC ``x`` [B, H, W, C] in the compute dtype -> the post-conv1
    activation, NCHW [B, C1, H/2, W/2] (``channels_last``), from
    ``packed_weights``' kernels and the biases in the compute dtype."""
    xp = _space_to_depth(x).permute(0, 3, 1, 2)
    subs = []
    for i, kw in enumerate(kernels[:4]):
        dy, dx = divmod(i, 2)
        subs.append(_conv2x2(xp, kw, (1 - dy, dy), (1 - dx, dx)))
    y0 = torch.cat(subs, dim=1)                  # [B, 4*C0, H/2, W/2]
    y0 = _activate(y0 + b0.repeat(4).view(1, -1, 1, 1), act0)
    y1 = _conv2x2(y0, kernels[4], (1, 0), (1, 0))
    return _activate(y1 + b1.view(1, -1, 1, 1), act1)


def packed_stem_apply(x: torch.Tensor, spec0, p0: Dict[str, torch.Tensor],
                      spec1, p1: Dict[str, torch.Tensor],
                      compute_dtype: torch.dtype) -> torch.Tensor:
    """Exact packed evaluation of conv0 (3x3/1) + conv1 (3x3/2) on
    BN-folded params {"w" OIHW, "b"} (the port's layout). Returns the
    post-conv1 activation NHWC [B, H/2, W/2, O1] in ``compute_dtype``."""
    kernels = packed_weights(p0["w"], p1["w"], compute_dtype)
    y = packed_stem_conv(x.to(compute_dtype), kernels,
                         p0["b"].to(compute_dtype), spec0.activation,
                         p1["b"].to(compute_dtype), spec1.activation)
    return y.permute(0, 2, 3, 1)


def stem_applicable(net) -> bool:
    """The packed stem applies when layers 0/1 are BN-foldable convs of
    shape 3x3/1 then 3x3/2 with a small input channel count and even
    input size."""
    if len(net.layers) < 2:
        return False
    l0, l1 = net.layers[0], net.layers[1]
    return (l0.kind == "convolutional" and l1.kind == "convolutional"
            and l0.conv.size == 3 and l0.conv.stride == 1
            and l1.conv.size == 3 and l1.conv.stride == 2
            and l0.conv.in_ch <= 8
            and net.width % 2 == 0 and net.height % 2 == 0
            and 0 not in net.saved_outputs)
