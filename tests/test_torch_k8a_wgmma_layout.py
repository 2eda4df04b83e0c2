"""The bfloat16 K8a's ``wgmma`` layout, checked on the CPU (the kernel
runs only on a card: ``chip_smoke.py`` phase 9 holds it against its plain
version and K1 there).

- K1's packed weights (``ops/stem_fused.py: k1_packed``), read through
  ``wg_weights``' byte formula alone (element (k, n) of a GEMM in chunk
  k // 64 at byte ``n * 128 + (((k % 64) // 8) ^ (n % 8)) * 16 +
  (k % 8) * 2``), give the sums K8a's five GEMMs run over its tiles (its
  rows at each tap, in the Rows maps' tap order, then 16-deep steps):
  conv0 as ``RowsConv0`` pairs its taps, convs 1-3 row-major, conv5 at
  stride (2, 1) through ``RowsConv21`` over the dense 8 x 16 y5 tile.
  Those sums equal ``F.conv2d`` on the tile, and conv5's even columns are
  K1's conv5 (``RowsConv<3, 2>``) sums bit for bit.
- The tile and ring plan, mirrored from ``csrc/stem_batched.cu``'s
  constants (its ``GeomB<8>``, ``GeomTC`` and the five ``wg::Gemm``s of
  ``namespace k8a``), stays within a block's 232,448 bytes; convs 0-3 are
  resident and conv5 is one pass.
- The warps' transposing stage (``Stage``) is bank-conflict free, and the
  stores' lane maps (``store_act`` for the y0 phases, y1, y2 and y3;
  ``store_y5``) write each lane of every output row exactly once, lane
  j + 1 with column j's value and lane 0 and the slack zero, only the
  first and last tile columns touching lane 0 and the slack, at 608^2 and
  at a size whose last tile is partial.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import stem_batched as SB

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, SB.__name__.split(".")[0], "csrc",
                   "stem_batched.cu")

# GeomB<8> (csrc/stem_batched.cu): the tiles' rows and columns
TILE = 8
S4N, S4W = 2 * TILE + 1, 2 * TILE + 2
Y1N, Y1W = S4N + 2, S4W + 2
Y0N, Y0W = 2 * Y1N + 1, 2 * Y1W + 1
XN, XW = Y0N + 2, Y0W + 2


def _stem_params(seed=7):
    """K1's (HWIO bfloat16 weight, float32 bias) pairs, from numpy."""
    rng = np.random.default_rng(seed)
    sp = []
    for cin, cout, k in zip(SF.STEM_IN, SF.STEM_FILTERS, SF.STEM_KSIZE):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(2 / (cin * k * k))
        sp.append((torch.tensor(w, dtype=torch.bfloat16),
                   torch.tensor(rng.standard_normal(cout) * 0.1,
                                dtype=torch.float32)))
    return sp


def _unpack(packed, depth, n):
    """[depth, n] bfloat16 from packed bytes by the documented formula."""
    raw = packed.contiguous().view(torch.uint8).reshape(-1).numpy()
    k = np.arange(depth)[:, None]
    j = np.arange(n)[None, :]
    off = ((k // 64) * n * 128 + j * 128 + (((k % 64) // 8) ^ (j % 8)) * 16
           + (k % 8) * 2)
    bits = raw[off].astype(np.uint16) | (raw[off + 1].astype(np.uint16) << 8)
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def _packed_b(sp):
    """K8a's five GEMMs' B [steps, 16, N] (float32), unpacked from the
    tensors ``k1_packed`` hands the kernel (its pointers are theirs)."""
    ptrs = SF.k1_packed(sp)
    builds = (SF.wg_weights_conv0,) + (SF.wg_weights_conv,) * 4
    out = []
    for (w, _), build, ptr in zip(sp, builds, ptrs):
        packed = SF._mma_cached(w, build)
        assert packed.data_ptr() == ptr
        kh, kw, cin, n = w.shape
        depth = 96 if cin == 3 else kh * kw * cin
        out.append(_unpack(packed, depth, n).float().reshape(-1, 16, n))
    return out


def _gemm(tile, rows, b):
    """The implicit GEMM, float32: tile [pos, C] (C a multiple of 8), rows
    [M, steps] (the first input position of each output row's 16-deep
    step: two positions of 8 channels for conv0, else the step's 16
    channels of one position), summed step by step."""
    flat = tile.reshape(-1)
    c = tile.shape[1]
    acc = torch.zeros(rows.shape[0], b.shape[-1])
    for s in range(b.shape[0]):
        if c == 8:
            idx = rows[:, s, None] * 8 + torch.arange(16)
        else:
            ks = c // 16
            idx = (rows[:, s // ks, None] * c + (s % ks) * 16
                   + torch.arange(16))
        acc += flat[idx] @ b[s]
    return acc


def _rows(oh, ow, iw, sy, sx, ks):
    """RowsConv<ks, s> / RowsConv21: output (oy, ox) reads (sy oy + ky,
    sx ox + kx) at tap ky ks + kx, the taps in order."""
    oy, ox = np.divmod(np.arange(oh * ow), ow)
    taps = [(ky, kx) for ky in range(ks) for kx in range(ks)]
    return torch.tensor(np.stack([(sy * oy + ky) * iw + sx * ox + kx
                                  for ky, kx in taps], 1))


def _rows_conv0(oh, ow, iw):
    """RowsConv0: step i reads (oy + i // 2, ox + 2 (i % 2)) and the next
    position (the taps kx = 2 (i % 2) and 2 (i % 2) + 1 of row i // 2)."""
    oy, ox = np.divmod(np.arange(oh * ow), ow)
    return torch.tensor(np.stack([(oy + i // 2) * iw + ox + 2 * (i % 2)
                                  for i in range(6)], 1))


def _conv(tile, w, stride):
    """F.conv2d over a [rows, cols, C] tile, no padding, float32 HWIO w."""
    v = tile.permute(2, 0, 1)[None].float()
    y = F.conv2d(v, w.float().permute(3, 2, 0, 1), stride=stride)
    return y[0].permute(1, 2, 0)


def test_k1_packed_sums_are_k8a_convs_at_its_tiles():
    """Through the byte formula alone, K1's packed weights give the sums of
    K8a's five GEMMs at its tile geometry (conv0 over the x tile [41 x 43]
    with its paired taps, conv1 stride 2 to [19 x 20], conv2 1x1, conv3 to
    [17 x 18], conv5 at stride (2, 1) to the dense [8 x 16]); each equals
    ``F.conv2d`` on the tile, and conv5's even columns are K1's conv5
    sums (stride 2 over the same s4 tile) bit for bit."""
    sp = _stem_params()
    b = _packed_b(sp)
    rng = np.random.default_rng(11)

    def tile(rows, cols, c):
        return torch.tensor(rng.standard_normal((rows, cols, c)),
                            dtype=torch.bfloat16).float()

    # conv0: x [XN XW + 1][8], channels 3..7 and the last position zero
    x = torch.zeros(XN * XW + 1, 8)
    x[:XN * XW, :3] = tile(XN, XW, 3).reshape(-1, 3)
    got = _gemm(x, _rows_conv0(Y0N, Y0W, XW), b[0]).reshape(Y0N, Y0W, 32)
    want = _conv(x[:XN * XW, :3].reshape(XN, XW, 3), sp[0][0], 1)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # conv1 (3x3 s2), conv2 (1x1), conv3 (3x3 s1)
    for i, (src, oh, ow, s, ks) in enumerate(
            ((tile(Y0N, Y0W, 32), Y1N, Y1W, 2, 3),
             (tile(Y1N, Y1W, 64), Y1N, Y1W, 1, 1),
             (tile(Y1N, Y1W, 32), S4N, S4W, 1, 3)), 1):
        iw = src.shape[1]
        got = _gemm(src.reshape(-1, src.shape[2]),
                    _rows(oh, ow, iw, s, s, ks), b[i]).reshape(oh, ow, -1)
        torch.testing.assert_close(got, _conv(src, sp[i][0], s), rtol=1e-4,
                                   atol=1e-4)
    # conv5 at stride (2, 1) over the s4 tile, and K1's at stride 2
    s4 = tile(S4N, S4W, 64)
    flat = s4.reshape(-1, 64)
    dense = _gemm(flat, _rows(TILE, 2 * TILE, S4W, 2, 1, 3),
                  b[4]).reshape(TILE, 2 * TILE, 128)
    torch.testing.assert_close(dense, _conv(s4, sp[4][0], (2, 1)),
                               rtol=1e-4, atol=1e-4)
    k1 = _gemm(flat, _rows(TILE, TILE, S4W, 2, 2, 3),
               b[4]).reshape(TILE, TILE, 128)
    assert torch.equal(dense[:, 0::2], k1)


def _k8a_source():
    text = open(SRC).read()
    return text[text.index("namespace k8a {"):text.index("}  // namespace k8a")]


def _gemm_plan(ntap, kt, n, ng, mt, m, slot, stages, calls=1, gs=4):
    """wg::Gemm's passes, slots a pass and residency (stem_common.cuh)."""
    nstep = ntap * kt // 16
    nch = -(-nstep // 4)
    items0 = (-(-m // 64) + mt - 1) // mt * ng
    npass = (items0 + items0 % 2) // 2
    nsl = -(-(nch * n * 128) // slot)
    return {"npass": npass, "nsl": nsl,
            "res": npass * calls > 1 and nsl <= stages}


def test_shared_memory_plan_fits_one_block():
    """The tiles (GeomTC: y0 then y2 and s4 in one region; x, then y1, then
    the y5 tile in the other), the warps' transposing stages and the ring
    of ``namespace k8a`` (its STAGES slots of SLOT bytes, the alignment
    slack, two barriers a slot),
    mirrored from the source, fit a block's 232,448 bytes; the five GEMMs
    parsed from the source plan convs 0-3 resident (their slots within the
    ring) and conv5 as one streamed pass."""
    src = _k8a_source()
    stages = int(re.search(r"STAGES = (\d+)", src).group(1))
    slot = int(re.search(r"SLOT = (\d+)", src).group(1))
    p32, p64, p128 = 40, 72, 136
    xe = (XN * XW + 1) * 8
    y2 = Y1N * Y1W * p32
    region_b = max(Y0N * Y0W * p32, y2 + S4N * S4W * p64)
    region_c = max(xe, Y1N * Y1W * p64, TILE * 2 * TILE * p128)
    tiles = 2 * (region_b + region_c)
    assert tiles == 182640
    # the eight consumer warps' transposing stages, 512 bytes each
    assert "RING_AT = STAGE_AT + wg::CONSUMER_WARPS * 512" in src
    smem = tiles + 8 * 512 + 1024 + stages * slot + 16 * stages
    assert smem == 228800 and smem <= 232448
    # one more slot would not fit beside the tiles
    assert smem + slot > 232448
    env = {"G::Y0N": Y0N, "G::Y0W": Y0W, "G::Y1N": Y1N, "G::Y1W": Y1W,
           "G::S4N": S4N, "G::S4W": S4W, "TILE": TILE, "SLOT": slot,
           "STAGES": stages}
    plans = {}
    for name, args in re.findall(r"using (C\d) = wg::Gemm<([^>]*)>;", src):
        for k, v in sorted(env.items(), key=lambda kv: -len(kv[0])):
            args = args.replace(k, str(v))
        plans[name] = _gemm_plan(*[eval(a, {}) for a in args.split(",")])
    assert sorted(plans) == ["C0", "C1", "C2", "C3", "C5"]
    for name in ("C0", "C1", "C2", "C3"):
        assert plans[name]["res"], name
    assert plans["C1"]["nsl"] == plans["C3"]["nsl"] == stages
    assert plans["C5"] == {"npass": 1, "nsl": 18, "res": False}


def _unit(line, half):
    """Stage::unit: a staged line's 16-byte unit (csrc/stem_batched.cu)."""
    return (2 * line + half) ^ ((line >> 2) & 1)


def test_stage_units_are_conflict_free():
    """The warp's transposing stage holds 16 lines x 32 bytes in 32
    distinct 16-byte units; the eight rows each stmatrix phase writes
    (lane l of matrix k: line 8 (k // 2) + l % 8, half k % 2) and the eight
    units each quarter-warp reads (thread t: line t // 2, half t % 2) fall
    in eight distinct bank groups (unit % 8)."""
    units = {_unit(line, half) for line in range(16) for half in (0, 1)}
    assert units == set(range(32))
    for k in range(4):
        rows = [_unit(8 * (k // 2) + r, k % 2) % 8 for r in range(8)]
        assert len(set(rows)) == 8, k
    for qw in range(4):
        reads = [_unit(t // 2, t % 2) % 8 for t in range(8 * qw, 8 * qw + 8)]
        assert len(set(reads)) == 8, qw


def _act_writes(l0, last, seg):
    """store_act's (lane, value index j of the phase) pairs for one line
    of a block's row: the unit's positions L (the stage's lanes of a line)
    are own columns L - 1, thread t of the warp stores the 8 lanes of half
    t % 2 of line t // 2 at lanes l0 + 8 (t % 2) ..; lane l0 + L holds
    value index l0 + L - 1 of its phase. The last tile column adds lane
    l0 + 16 (value l0 + 15) and zeroes the rest."""
    out = [(l0 + 8 * half + i, l0 + 8 * half + i - 1)
           for half in range(2) for i in range(8)]
    if last:
        out.append((l0 + 16, l0 + 15))
        out += [(lane, None) for lane in range(l0 + 17, seg)]
    return out


def _y5_writes(l0, first, last, seg):
    """store_y5's (lane, dense column) pairs for one line: thread e of the
    line's half-warp stores the staged column e at lane l0 + 1 + e; lane 0
    (first tile column) and lanes past l0 + 16 (last) zero."""
    out = [(l0 + 1 + e, l0 + e) for e in range(16)]
    if first:
        out.append((0, None))
    if last:
        out += [(lane, None) for lane in range(l0 + 17, seg)]
    return out


@pytest.mark.parametrize("h", [608, 40, 72, 96])
def test_store_lanes_cover_each_output_lane_once(h):
    """Over all blocks of one image, the y0 phases', y1's, y2's, y3's and
    y5's stores write each lane of each output row exactly once: lane
    j + 1 the value of column j (of the phase), zero where that column is
    outside the image (the tile holds zero there; y5 masks it), lane 0 and
    the slack past the values zero, and only the first and last tile
    columns write lane 0 or the slack. The tile columns the activation
    stores read (the halo column left of the own region, the last own
    column) lie inside each tile. h = 40: the last tile is partial (y5's
    rows 8..9 of 16, columns 16..19 of 32)."""
    h1, h5 = h // 2, h // 4
    seg = SB._seg(h1)
    nt = -(-h5 // TILE)
    # (rows, own rows a block, value lanes a phase, phases, tile offset and
    # row width of the tile read)
    acts = {"y0": (h, 4 * TILE, h1, 2, 5, Y0W), "y1": (h1, 2 * TILE, h1, 1,
                                                      2, Y1W),
            "y2": (h1, 2 * TILE, h1, 1, 2, Y1W), "y3": (h1, 2 * TILE, h1, 1,
                                                      1, S4W)}
    for name, (rows, nr, wq, nph, off, tw) in acts.items():
        for ph in range(nph):
            # tile columns read: lane l0 + L from off + (phase) (L - 1)
            cols = [off + (2 * (L - 1) + ph if nph == 2 else L - 1)
                    for L in range(17)]
            assert 0 <= min(cols) and max(cols) < tw, name
            count = np.zeros((rows, seg), int)
            for by in range(nt):
                for bx in range(nt):
                    l0 = 16 * bx
                    for lane, j in _act_writes(l0, bx == nt - 1, seg):
                        assert 0 <= lane < seg
                        if lane == 0 or lane > wq:
                            assert bx in (0, nt - 1), (name, lane)
                        # the value of index j, or zero outside the image
                        if j is not None and 0 <= j < wq:
                            assert lane == j + 1, (name, lane, j)
                        else:
                            assert lane == 0 or lane > wq, (name, lane, j)
                        for r in range(by * nr, min((by + 1) * nr, rows)):
                            count[r, lane] += 1
            assert (count == 1).all(), (name, ph, np.argwhere(count != 1)[:4])
    count = np.zeros((h5, seg), int)
    for by in range(nt):
        for bx in range(nt):
            l0 = 2 * TILE * bx
            for lane, col in _y5_writes(l0, bx == 0, bx == nt - 1, seg):
                if lane == 0 or lane > h1:
                    assert bx in (0, nt - 1), lane
                if col is not None and col < h1:
                    assert lane == col + 1
                else:
                    assert lane == 0 or lane > h1, (lane, col)
                for r in range(by * TILE, min((by + 1) * TILE, h5)):
                    count[r, lane] += 1
    assert (count == 1).all(), np.argwhere(count != 1)[:4]
