"""The index arithmetic of the bfloat16 K5 and K8b, which run K2's
``wgmma`` chain (``csrc/stem_common.cuh: wgc::chain``), emulated in numpy
on the CPU, and the packed weights their wrappers hand the kernels.

K5 (``csrc/stem_remat.cu: fused_stem_remat_wg_kernel``) owns K2's 16 x 16
gx tile at (R0, C0) and recomputes, before the chain, the signs the chain
gates with: x over 35^2 from R0 - 8, y0 over 33^2 from R0 - 7 (two chunks
of 17 rows, each feeding 8 rows of y1), y1 and y2 over 16^2 from R0/2 - 3,
y3 over 14^2 from R0/2 - 2 (rows; columns alike). The chain reads y3's
gates at gs4's 14^2 from R0/2 - 2 (bit tile offset 0), y1's and y2's at
11^2 from R0/2 - 1 (offset 2) and y0's at 20^2 from R0 - 2 (offset 5).
Its x tile comes in 16-byte loads of 8 planar lanes, three runs a row and
column phase from lane 8 bx - 8.

K8b (``csrc/stem_batched.cu: fused_stem_bwd_b_wg_kernel``) reads TMA boxes
of the batch-on-lanes tensors: each box's first lane is the 8-lane
(16-byte) boundary at or below the first lane the chain reads, from the
image's segment lane 0 at least; gp5dd and y3 take 24 lanes, y0, y1 and
y2 16. gp5dd comes through a map whose row stride is two rows (its data
rows), and the consumers pick gp5 column c at segment lane 2c + 1.
"""

import types

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.experimental import stem_batched as SB
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF

TX = 16                       # the gx tile
NX, NY0, N2, N3 = 35, 33, 16, 14
Y0_ROWS, Y1_ROWS = 17, 8      # a y0 chunk, the y1 rows it feeds


def _span(origin, side, lo, hi):
    """The positions origin .. origin + side - 1 that lie in [lo, hi)."""
    p = np.arange(origin, origin + side)
    return p[(p >= lo) & (p < hi)]


def _k5_regions(r0):
    """K5's recompute regions along one axis for the tile at r0: name ->
    (origin in image coordinates, side), as the kernel's origins set them
    (x_r = R0 - 8, the y0 chunk's conv0 at x_r + 1, y1_r = R0/2 - 3, y3 at
    y1_r + 1)."""
    x_r, y1_r = r0 - 8, r0 // 2 - 3
    return {"x": (x_r, NX), "y0": (x_r + 1, NY0), "y12": (y1_r, N2),
            "y3": (y1_r + 1, N3)}


@pytest.mark.parametrize("h", [608, 64])
def test_k5_recompute_regions_cover_every_gate_the_chain_reads(h):
    """Along each axis, for every tile of an h^2 image: each gate position
    of the chain that lies in the image falls in its recompute region at
    the bit tile's offset (y3 0, y1 and y2 2, y0 5); each recomputed layer's
    inputs over the image lie in the region below it (3x3 taps, y1 at
    stride 2, y2 1x1), y1's rows of a chunk in that chunk's 17 y0 rows, and
    the two chunks cover y0's 33 rows."""
    h1 = h // 2
    for t in range(h // TX):
        r0 = t * TX
        reg = _k5_regions(r0)
        # the chain's reads (image positions) and the bit tiles' offsets
        for name, (origin, side, img), off in (
                ("y3", (r0 // 2 - 2, 14, h1), 0),
                ("y12", (r0 // 2 - 1, 11, h1), 2),
                ("y0", (r0 - 2, 20, h), 5)):
            o, n = reg[name]
            read = _span(origin, side, 0, img)
            idx = read - origin + off        # BitMask's tile index
            assert (idx >= 0).all() and (idx < n).all(), (h, t, name)
            assert np.array_equal(o + idx, read), (h, t, name)
        # each conv's tap 0 lines up with its input region's first row:
        # y0 (3x3, pad 1) from x, y1 (3x3, stride 2, pad 1) from y0, y3
        # (3x3, pad 1) from y2
        o3, n3 = reg["y3"]
        o12, n12 = reg["y12"]
        assert reg["y0"][0] - 1 == reg["x"][0]
        assert 2 * o12 - 1 == reg["y0"][0] and o3 - 1 == o12
        # y3 (3x3, stride 1) from y2, y2 (1x1) from y1: rows y3_o - 1 ..
        need = _span(o3 - 1, n3 + 2, 0, h1)
        assert need.min() >= o12 and need.max() < o12 + n12
        # y1 (3x3, stride 2) from y0: y1 row j needs y0 rows 2j - 1 .. 2j + 1
        o0, n0 = reg["y0"]
        for k in range(2):
            rows = np.arange(k * Y0_ROWS - k, k * Y0_ROWS - k + Y0_ROWS)
            for j in range(k * Y1_ROWS, (k + 1) * Y1_ROWS):
                need = _span(2 * (o12 + j) - 1, 3, 0, h) - o0
                assert np.isin(need, rows).all(), (h, t, k, j)
        assert 2 * (Y0_ROWS - 1) + 1 == NY0 and 2 * Y1_ROWS == N2
        # y0 (3x3, stride 1) from x
        ox, nx = reg["x"]
        need = _span(o0 - 1, n0 + 2, 0, h)
        assert need.min() >= ox and need.max() < ox + nx


def _k5_x_columns(bx, h, wlh):
    """K5's x-tile loads along the columns for tile column bx: for each
    tile column, the (phase, planar lane, inside the image) a load writes
    it with, and how many loads write it. A thread takes 8 lanes of one
    row and phase from lane lv0 + 8 v (v < 3, lv0 = 8 bx - 8); lane l + k
    holds image column 2 (l + k - 1) + ph."""
    x_c, lv0 = TX * bx - 8, 8 * bx - 8
    ph_of = np.full(NX, -1)
    lane_of = np.full(NX, -1)
    inside = np.zeros(NX, bool)
    writes = np.zeros(NX, int)
    for ph in (0, 1):
        for v in range(3):
            lane0 = lv0 + 8 * v
            loaded = lane0 >= 0 and lane0 + 8 <= wlh
            for k in range(8):
                gc = 2 * (lane0 + k - 1) + ph
                col = gc - x_c
                if not 0 <= col < NX:
                    continue
                writes[col] += 1
                ph_of[col], lane_of[col] = ph, lane0 + k
                inside[col] = loaded and 0 <= gc < h
    return ph_of, lane_of, inside, writes


@pytest.mark.parametrize("h", [608, 64])
def test_k5_x_tile_loads_each_position_once_and_zero_outside(h):
    """Every column of every tile's x region is written by exactly one
    16-byte load, from its own phase and lane, and is zero outside the
    image; on a 64^2 batch of two images the assembled x tiles of all 16
    tiles equal the image crop padded with zeros (channels 3..7 zero)."""
    wlh = PC._round_up(h // 2 + 2, 128)
    for bx in range(h // TX):
        ph, lane, inside, writes = _k5_x_columns(bx, h, wlh)
        assert (writes == 1).all(), (h, bx)
        gc = TX * bx - 8 + np.arange(NX)
        assert np.array_equal(ph, gc & 1)
        assert np.array_equal(lane, (gc >> 1) + 1)
        assert np.array_equal(inside, (gc >= 0) & (gc < h))
    if h != 64:
        return
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((2, h, h, 3)), dtype=torch.float32)
    xe, xo = SF.split_phases(x)
    phases = (xe.numpy(), xo.numpy())
    img = np.pad(x.numpy(), ((0, 0), (8, 8 + TX), (8, 8 + TX), (0, 0)))
    for b in range(2):
        for by in range(h // TX):
            rows = TX * by - 8 + np.arange(NX)
            row_in = (rows >= 0) & (rows < h)
            for bx in range(h // TX):
                ph, lane, inside, _ = _k5_x_columns(bx, h, wlh)
                tile = np.zeros((NX, NX, 8), np.float32)
                for c in range(NX):
                    src = phases[ph[c]][b, np.clip(rows, 0, h - 1), :3,
                                        lane[c]]
                    tile[:, c, :3] = np.where(
                        (row_in & inside[c])[:, None], src, 0.0)
                want = img[b, TX * by:TX * by + NX, TX * bx:TX * bx + NX]
                assert np.array_equal(tile[..., :3], want), (b, by, bx)
                assert not tile[..., 3:].any()


def _k8b_first_lanes(c0):
    """K8b's boxes' first lanes in an image's segment for the gx tile
    column c0 (the kernel's l5, l3, l12, l0)."""
    o5c, o4c, o1c, o0c = c0 // 4 - 1, c0 // 2 - 2, c0 // 2 - 1, c0 - 2
    return {"gp5dd": max((2 * o5c + 1) & ~7, 0),
            "y3": max((o4c + 1) & ~7, 0), "y12": (o1c + 1) & ~7,
            "y0": ((o0c >> 1) + 1) & ~7}


# each box's lanes, and the segment lanes the chain reads from it for a
# gx tile column c0 of an h-wide image (the in-image positions only)
K8B_LANES = {"gp5dd": 24, "y3": 24, "y12": 16, "y0": 16}


def _k8b_lanes_read(c0, h):
    h1, h5 = h // 2, h // 4
    g5 = _span(c0 // 4 - 1, 8, 0, h5)
    y3 = _span(c0 // 2 - 2, 14, 0, h1)
    y12 = _span(c0 // 2 - 1, 11, 0, h1)
    y0 = _span(c0 - 2, 20, 0, h)
    return {"gp5dd": 2 * g5 + 1, "y3": y3 + 1, "y12": y12 + 1,
            "y0": (y0 >> 1) + 1}


@pytest.mark.parametrize("h", [608, 72, 64])
def test_k8b_boxes_start_on_16_bytes_in_the_segment_and_cover_the_reads(h):
    """For every tile column of every image of a batch of three (72: a
    partial last tile): each box's first lane is a 16-byte boundary (8
    bfloat16 lanes) inside its image's 128-aligned segment, and the box
    holds every lane the chain reads from it."""
    seg = SB._seg(h // 2)
    assert seg % 128 == 0
    for b in range(3):
        for bx in range(-(-h // TX)):
            first = _k8b_first_lanes(TX * bx)
            read = _k8b_lanes_read(TX * bx, h)
            for name, lanes in K8B_LANES.items():
                lane = b * seg + first[name]
                assert lane % 8 == 0 and b * seg <= lane < (b + 1) * seg, (
                    h, b, bx, name)
                r = read[name]
                assert r.size and r.min() >= first[name], (h, bx, name)
                assert r.max() < first[name] + lanes, (h, bx, name)


@pytest.mark.parametrize("h", [72, 64])
def test_k8b_gp5dd_map_selects_the_data_rows_and_odd_lanes(h):
    """gp5dd as ``FusedStemBatched.backward`` builds it
    (``interleave_zero_cols``, ``interleave_zero_rows``,
    ``nhwc_to_batched``): the map's rows (a row stride of two rows, H/4 of
    them) are its data rows, zeros elsewhere; and for every tile and image
    the kernel's box (8 rows from R0/4 - 1, 24 lanes from the first lane,
    zeros outside the tensor) and pick (segment lane 2 gc + 1, zero
    outside the image) give the tile's gp5 exactly."""
    b_n, h1, h5 = 2, h // 2, h // 4
    seg = SB._seg(h1)
    rng = np.random.default_rng(9)
    gp5 = rng.standard_normal((b_n, h5, h5, 128)).astype(np.float32)
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(torch.tensor(gp5))), seg).numpy()
    assert gp5dd.shape == (h1, 128, b_n * seg)
    rows = gp5dd[0::2]                      # the map's rows
    assert rows.shape[0] == h5 and not gp5dd[1::2].any()
    lanes = rows.reshape(h5, 128, b_n, seg)
    odd = lanes[..., 1:2 * h5:2]            # segment lanes 2c + 1
    assert np.array_equal(odd.transpose(2, 0, 3, 1), gp5)
    rest = lanes.copy()
    rest[..., 1:2 * h5:2] = 0
    assert not rest.any()
    padded = np.zeros((h5 + 16, 128, b_n * seg + 64), np.float32)
    padded[8:8 + h5, :, :b_n * seg] = rows
    for b in range(b_n):
        for by in range(-(-h // TX)):
            o5r = TX * by // 4 - 1
            for bx in range(-(-h // TX)):
                o5c = TX * bx // 4 - 1
                l5 = _k8b_first_lanes(TX * bx)["gp5dd"]
                lane0 = b * seg + l5
                box = padded[8 + o5r:8 + o5r + 8, :, lane0:lane0 + 24]
                z = np.zeros((8, 8, 128), np.float32)
                for r in range(8):
                    for k in range(8):
                        gr, gc = o5r + r, o5c + k
                        if 0 <= gr < h5 and 0 <= gc < h5:
                            z[r, k] = box[r, :, 2 * gc + 1 - l5]
                want = np.zeros((8, 8, 128), np.float32)
                rr = _span(o5r, 8, 0, h5)
                cc = _span(o5c, 8, 0, h5)
                want[np.ix_(rr - o5r, cc - o5c)] = gp5[b][np.ix_(rr, cc)]
                assert np.array_equal(z, want), (b, by, bx)


def _meta_params():
    """K1's and K2's weights on the meta device, bfloat16 (the wrappers'
    checks pass; no values)."""
    sp = [(torch.empty(k, k, ci, co, dtype=torch.bfloat16, device="meta"),
           torch.empty(co, device="meta"))
          for ci, co, k in zip(SF.STEM_IN, SF.STEM_FILTERS, SF.STEM_KSIZE)]
    return sp, SF.stem_bwd_params(sp)


def test_k5_and_k8b_pass_k1_and_k2_packing_built_once(monkeypatch):
    """Through a recording stub of ``_cuda.launch`` (meta tensors stand in
    for the card's): K5 passes K1's packing of convs 0-3
    (``wg_weights_conv0``, ``wg_weights_conv``; what the bfloat16 K1 takes)
    and K2's of the five adjoints (``K2_BUILDS``, what K2 takes); K8b
    passes K2's; no fragment-order build is asked for; and a second call
    gets the very copies of the first (built once a tensor)."""
    sp, sbp = _meta_params()
    built = {}
    real = PC._mma_cached

    def cached(w, build=PC.mma_weights):
        assert build is not PC.mma_weights, "a fragment-order build"
        out = real(w, build)
        token = (id(w), build.__name__)
        assert built.setdefault(token, out) is out, "built twice"
        return types.SimpleNamespace(data_ptr=lambda: token)

    calls = []
    monkeypatch.setattr(SF, "_mma_cached", cached)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a: None)
    monkeypatch.setattr(_cuda, "launch",
                        lambda what, lib, entry, t, *args: calls.append(
                            (what, args)))
    bf16, meta = torch.bfloat16, "meta"
    b, h = 2, 64
    wlh, wl5 = PC._round_up(h // 2 + 2, 128), PC._round_up(h // 4 + 2, 128)
    xe = torch.empty(b, h, 8, wlh, dtype=bf16, device=meta)
    y5 = torch.empty(b, h // 4, 128, wl5, dtype=bf16, device=meta)
    seg = SB._seg(h // 2)
    acts = [torch.empty(rows, c, b * seg, dtype=bf16, device=meta)
            for rows, c in ((h // 4, 128), (h, 32), (h, 32), (h // 2, 64),
                            (h // 2, 32), (h // 2, 64))]
    gp5dd = torch.empty(h // 2, 128, b * seg, dtype=bf16, device=meta)
    masks = [torch.empty(b, rows, c, wlh, dtype=torch.int8, device=meta)
             for rows, c in ((h, 32), (h, 32), (h // 2, 64), (h // 2, 32),
                             (h // 2, 64))]
    k1 = [(id(w), f.__name__) for (w, _), f in
          zip(sp[:4], (SF.wg_weights_conv0,) + (SF.wg_weights_conv,) * 3)]
    k2 = [(id(v), f.__name__) for v, f in zip(sbp, SF.K2_BUILDS)]
    assert [f.__name__ for f in SF.K2_BUILDS] == [
        "wg_weights_conv", "wg_weights_t2", "wg_weights_conv",
        "wg_weights_conv", "wg_weights_t2"]
    for _ in range(2):
        SF.fused_stem_bwd(xe, xe, y5, y5, sp, sbp)
        SB.fused_stem_bwd_b(gp5dd, acts, sbp, b)
        SF.fused_stem_bwd_saved((y5, *masks), y5, sbp)
        SF.fused_stem_fwd(xe, xe, sp)
    names = [what for what, _ in calls]
    assert names == ["fused_stem_bwd", "fused_stem_bwd_b",
                     "fused_stem_bwd_saved", "fused_stem_fwd"] * 2
    for i in (0, 4):
        k5, k8b, k2s, k1s = (args for _, args in calls[i:i + 4])
        # K5: xe, xo, w0-w3, b0-b3, y5, g5, v0-v5, then the packed lists
        assert list(k5[17:26]) == k1 + k2
        # K8b: gp5dd, five activations, v0-v5, then K2's packing
        assert list(k8b[11:16]) == k2
        # K2: five masks, y5, g5, v0-v5, then its packing
        assert list(k2s[12:17]) == k2
        # K1: xe, xo, w0-w5, b0-b5, then its packing of all five
        assert list(k1s[12:16]) == k1
    assert len(built) == 4 + 1 + 5
