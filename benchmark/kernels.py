"""Operations and bytes of the port's stem kernels at a cell's shapes
(the arithmetic of the repository's ``chip_smoke.py``, frozen here).

Inputs count at the lanes and channels a kernel must read, outputs whole
(the planar layout needs their zero lanes written). The planar rows of
an image of side ``w`` are ``round_up(w + 2, 128)`` lanes wide; the fused
stem reads the two column phases of x (3 of 8 channels, bfloat16) and
writes y5 ([B, H/4, 128, Wl5] bfloat16) and, saving, the int8 sign masks
of y0 (both phases, 32 channels), y1 (64), y2 (32) and y3 (64).
"""

from __future__ import annotations

BF16 = 2


def lanes(w: int) -> int:
    return -(-(w + 2) // 128) * 128


def stem_flops(b: int, h: int) -> float:
    """2 x multiply-adds of stem convs 0, 1, 2, 3 and 5 on their
    outputs."""
    h1, h5 = h // 2, h // 4
    macs = (h * h * 32 * 27 + h1 * h1 * 64 * 288 + h1 * h1 * 32 * 64
            + h1 * h1 * 64 * 288 + h5 * h5 * 128 * 576)
    return 2.0 * b * macs


def x_phases_read(b: int, h: int) -> int:
    return 2 * b * h * 3 * (h // 2) * BF16


def y5_written(b: int, h: int) -> int:
    return b * (h // 4) * 128 * lanes(h // 4) * BF16


def masks_written(b: int, h: int) -> int:
    h1, wl = h // 2, lanes(h // 2)
    return b * (2 * h * 32 + h1 * (64 + 32 + 64)) * wl


def k2_bytes(b: int, h: int) -> int:
    """K2: the masks at their image lanes, y5 and g5 at theirs, the two
    phase cotangents written whole."""
    h1, h5 = h // 2, h // 4
    masks = b * (2 * h * 32 * h1 + h1 * (64 + 32 + 64) * h1)
    y5_g5 = 2 * b * h5 * 128 * h5 * BF16
    gx = 2 * b * h * 8 * lanes(h1) * BF16
    return masks + y5_g5 + gx
