"""The bfloat16 K6 kernels' ``wgmma`` layout, checked on the CPU (the
kernels run only on a card: ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` hold them against their plain versions there).

- The packed weights the wrappers hand the kernels (``res_fused.
  stage_packed`` with ``FWD_BUILDS`` / ``BWD_BUILDS``, ``conv12_packed``)
  unpack to their HWIO source by ``wg_weights``' byte formula alone:
  element (k, n) of a GEMM (k = tap K + input channel, taps in the GEMM's
  order) lies in chunk k // 64 at byte
  ``n * 128 + (((k % 64) // 8) ^ (n % 8)) * 16 + (k % 8) * 2``. The
  forward's four convs and the backward's ``flip_t`` adjoints are one GEMM
  each in row-major tap order, W9's adjoint two GEMMs of 64 output
  channels back to back, and K6c's conv12^T four parity GEMMs in
  ``RowsT2``'s tap order.
- The sums the kernels run over those chunks (a tile's rows at each tap,
  then 16-deep steps, float32), read through the same formula, equal
  ``F.conv2d`` for the forward convs and ``F.conv_transpose2d`` for the
  stride-1 adjoints, at the kernels' tile geometry.
- The tile boxes (x and g11: 40 lanes from C0 - 8, 12 rows from R0 - 2;
  gp12: 24 lanes from C0/2 - 8, 7 rows from R0/2 - 1; 32 channels a box)
  start on a 16-byte boundary and, transposed as ``land_tile`` does (the
  8-lane groups from the box's lane 0, tile column = box lane - OFF, image
  columns outside the image zero), give each tile's halo exactly, also in
  the last tile column of an image whose width leaves it partial.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF

# the kernels' tile and boxes (csrc/res_fused.cu: tc::TR, TL, BC, XBL, GBL)
TR, TL, BC, XBL, GBL = 8, 16, 32, 40, 24


def _stage(seed=0):
    """The stage's HWIO weights as the model builds them (``res_weights``,
    ``res12_weights``), bfloat16 from numpy."""
    rng = np.random.default_rng(seed)
    sp = [(torch.tensor(rng.standard_normal(s) * np.sqrt(2 / np.prod(s[:3])),
                        dtype=torch.bfloat16), torch.zeros(s[-1]))
          for s in RF.FWD_SHAPES]
    fwd, bwd = RF.res_weights(sp)
    w12 = torch.tensor(rng.standard_normal((3, 3, RF.CIN, 2 * RF.CIN)) / 48,
                       dtype=torch.bfloat16)
    return [w for w, _ in fwd], bwd, RF.res12_weights(w12)


def unpack(packed: torch.Tensor, gemms) -> list:
    """Each GEMM's [T, K, N] values from packed bytes laid out as
    ``wg_weights`` documents (``gemms``: their (T, K, N), back to back),
    and whether every byte was some element's."""
    raw = packed.contiguous().view(torch.uint8).reshape(-1).numpy()
    used = np.zeros(raw.size, bool)
    out, base = [], 0
    for t, k, n in gemms:
        kk = np.arange(t * k)[:, None]
        nn = np.arange(n)[None, :]
        off = (base + (kk // 64) * n * 128 + nn * 128
               + (((kk % 64) // 8) ^ (nn % 8)) * 16 + (kk % 8) * 2)
        bits = raw[off].astype(np.uint16) | (raw[off + 1].astype(np.uint16)
                                             << 8)
        used[off] = used[off + 1] = True
        vals = torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)
        out.append(vals.reshape(t, k, n))
        base += -(-(t * k) // 64) * n * 128
    assert base == raw.size
    return out, bool(used.all())


def _gemms(name, w):
    """The GEMMs (T, K, N) a weight runs as, and their values from the
    HWIO tensor in the kernel's tap order."""
    kh, kw, k, n = w.shape
    if name == "w9t":
        return [(1, k, n // 2)] * 2, [w[..., :n // 2].reshape(1, k, n // 2),
                                       w[..., n // 2:].reshape(1, k, n // 2)]
    if name == "w12t":
        taps = SF.T2_PARITY_TAPS
        return ([(len(t), k, n) for t in taps],
                [torch.stack([w[dy, dx] for dy, dx in t]) for t in taps])
    return [(kh * kw, k, n)], [w.reshape(kh * kw, k, n)]


NAMES = ("w6", "w7", "w9", "w10", "w6t", "w7t", "w9t", "w10t", "w12t")


def _named(seed=0):
    fwd, bwd, w12t = _stage(seed)
    return dict(zip(NAMES, [*fwd, *bwd, w12t]))


def _packed(name, w):
    if name == "w12t":
        ptr = RF.conv12_packed(w, torch.bfloat16)
        return PC._mma_cached(w, SF.wg_weights_t2), ptr
    builds = RF.FWD_BUILDS if not name.endswith("t") else RF.BWD_BUILDS
    i = ("w6", "w7", "w9", "w10").index(name.rstrip("t"))
    ptr = RF.stage_packed([w], builds[i:i + 1], torch.bfloat16)[0]
    return PC._mma_cached(w, builds[i]), ptr


@pytest.mark.parametrize("name", NAMES)
def test_packed_weights_unpack_to_hwio(name):
    """Every packed K6 weight, read back by the byte formula alone, is its
    HWIO source in the kernel's GEMM and tap order, with no byte left
    over; the wrapper's pointer is the cached copy (built once per
    tensor), and float32 passes none."""
    w = _named()[name]
    packed, ptr = _packed(name, w)
    assert ptr == packed.data_ptr() and packed.dtype == torch.bfloat16
    shapes, want = _gemms(name, w)
    got, whole = unpack(packed, shapes)
    assert whole
    for g, v in zip(got, want):
        assert torch.equal(g, v)
    assert RF.stage_packed([w.float()], RF.FWD_BUILDS[:1],
                           torch.float32) == [None]
    assert RF.conv12_packed(w.float(), torch.float32) is None


def _gemm_sum(a_tile, tw, rows_out, taps, b, ks):
    """The kernel's implicit GEMM, float32: output (oy, ox) of a tile of
    rows_out[0] x rows_out[1] sums a_tile[(oy + dy) tw + ox + dx] over the
    taps (dy, dx) in order, then 16-deep steps of the K channels, against
    b [T, K, N] (the unpacked weights)."""
    oh, ow = rows_out
    acc = torch.zeros(oh * ow, b.shape[-1])
    pos = (torch.arange(oh)[:, None] * tw + torch.arange(ow)[None, :]).reshape(
        -1)
    for t, (dy, dx) in enumerate(taps):
        rows = a_tile[pos + dy * tw + dx]
        for s in range(0, b.shape[1], ks):
            acc += rows[:, s:s + ks].float() @ b[t, s:s + ks].float()
    return acc.reshape(oh, ow, -1)


@pytest.mark.parametrize("name,hw", [
    ("w6", (12, 20)), ("w7", (10, 18)), ("w9", (10, 18)), ("w10", (8, 16)),
    ("w10t", (10, 18)), ("w9t", (10, 18)), ("w7t", (8, 16)),
    ("w6t", (8, 16))])
def test_packed_sums_equal_the_convs(name, hw):
    """Each GEMM the kernels run, over a numpy-seeded tile at the size the
    kernel computes it, summed tap by tap and 16 channels at a time over
    the unpacked chunks, equals ``F.conv2d`` of the forward weight (the
    forward convs) or ``F.conv_transpose2d`` of it (the adjoints: the
    input cotangent of a stride-1 conv) in float32, each valid position."""
    ws = _named()
    w = ws[name]
    packed, _ = _packed(name, w)
    shapes, _ = _gemms(name, w)
    got_parts, _ = unpack(packed, shapes)
    b = torch.cat(got_parts, dim=-1)        # [T, K, N]
    kh = w.shape[0]
    oh, ow = hw
    ih, iw = oh + kh - 1, ow + kh - 1
    rng = np.random.default_rng(len(name) + oh)
    x = torch.tensor(rng.standard_normal((ih, iw, w.shape[2])),
                     dtype=torch.bfloat16)
    taps = [(t // kh, t % kh) for t in range(kh * kh)]
    got = _gemm_sum(x.reshape(ih * iw, -1), iw, (oh, ow), taps, b, 16)
    xn = x.float().permute(2, 0, 1)[None]
    if name.endswith("t"):
        fwd = ws[name[:-1]].float()              # the forward HWIO weight
        want = F.conv_transpose2d(xn, fwd.permute(3, 2, 0, 1),
                                  padding=kh - 1)
    else:
        want = F.conv2d(xn, w.float().permute(3, 2, 0, 1))
    want = want[0].permute(1, 2, 0)
    assert want.shape == got.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def _box(t, l0, r0, bl, br, ch0):
    """A TMA box of the planar [H, CH, wl] image t: rows r0 .., channels
    ch0 .. ch0 + BC - 1, lanes l0 .. (positions outside the tensor zero),
    as [br][BC][bl]."""
    h, _, wl = t.shape
    out = torch.zeros(br, BC, bl, dtype=t.dtype)
    for r in range(br):
        for lane in range(bl):
            gr, gl = r0 + r, l0 + lane
            if 0 <= gr < h and 0 <= gl < wl:
                out[r, :, lane] = t[gr, ch0:ch0 + BC, gl]
    return out


def _land(box, nc, off, w_img, l0, tile):
    """``land_tile``: the box's 8-lane groups v < (off + nc + 7) / 8 into
    tile [rows][nc][ch] (tile column = box lane - off), image columns
    outside [0, w_img) zero; returns the tile columns written."""
    nv = (off + nc + 7) // 8
    seen = []
    for v in range(nv):
        for j in range(8):
            lane = 8 * v + j
            col = lane - off
            if not 0 <= col < nc:
                continue
            gc = l0 + lane - 1
            vals = box[:, :, lane] if 0 <= gc < w_img else 0
            tile[:, col, :] = vals
            seen.append(col)
    return seen


@pytest.mark.parametrize("h,w", [(16, 72), (24, 40)])
def test_tile_boxes_cover_each_halo(h, w):
    """For every block of the grid (``tc_grid``: lanes 0 .. W in 16-lane
    tiles, the last one partial at these widths) the x / g11 box and the
    gp12 box start on a 16-byte boundary (a multiple of 8 lanes, negative
    only for the first tile column), and transposed as the kernel does
    they give the 12 x 20 halo from image (R0 - 2, C0 - 3) and gp12's
    7 x 12 tile from (R0/2 - 1, C0/2 - 2), every column once, zero
    outside the image."""
    rng = np.random.default_rng(h + w)
    img = torch.tensor(rng.standard_normal((h, w, 2 * BC)),
                       dtype=torch.bfloat16)
    planar = PC.to_planar(img[None])[0]                  # [h, 2 BC, wl]
    wl = planar.shape[-1]
    assert wl == PC._round_up(w + 2, 128)
    ncols = -(-(w + 1) // TL)
    assert (w + 1) % TL, "the last tile column is partial"
    for bx in range(ncols):
        c0 = TL * bx
        for by in range(-(-h // TR)):
            r0 = TR * by
            for nc, off, bl, br, rr0, l0, rows, cols, src in (
                    (20, 6, XBL, 12, r0 - 2, c0 - 8, h, w, planar),
                    (12, 7, GBL, 7, r0 // 2 - 1, c0 // 2 - 8, h // 2,
                     w // 2, planar[::2, :, :])):
                assert l0 % 8 == 0 and (l0 >= 0 or bx == 0)
                tile = torch.zeros(br, nc, 2 * BC, dtype=torch.bfloat16)
                for k in range(2):
                    box = _box(src[:rows], l0, rr0, bl, br, BC * k)
                    t = torch.zeros(br, nc, BC, dtype=torch.bfloat16)
                    seen = _land(box, nc, off, cols, l0, t)
                    assert sorted(seen) == list(range(nc))
                    tile[..., BC * k:BC * (k + 1)] = t
                # tile column c is image column (l0 + off - 1) + c
                want = torch.zeros_like(tile)
                for r in range(br):
                    for c in range(nc):
                        gr, gc = rr0 + r, l0 + off - 1 + c
                        if 0 <= gr < rows and 0 <= gc < cols:
                            want[r, c] = src[gr, :, gc + 1]
                assert torch.equal(tile, want)
