"""The bfloat16 152^2 stage kernels' ``wgmma`` design, checked on the CPU
(the kernels themselves run only on a card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold them against their plain versions there).

- The packed weights the wrappers hand the bfloat16 kernels
  (``res_fused.stage_packed`` with ``FWD_BUILDS`` / ``BWD_BUILDS``,
  ``conv12_packed``; built once per weight tensor by ``_mma_cached``) for
  the forward's four HWIO kernels, the backward's four ``flip_t`` kernels
  and K6c's ``res12_weights`` are the GEMMs the kernels' producer warp
  streams: [chunks, N, 64] a GEMM, back to back, each GEMM's 64-deep
  chunks of its taps in the kernel's order, and invert to their HWIO
  source through ``wg_weights``' documented index map.
- K6c's prologue: g11 = conv12^T gp12 as four parity GEMMs over each
  block's unexpanded gp12 tile, with the kernel's tile origins, its 6 x 10
  super positions a parity (the even-column parities' grid one column
  right) and ``RowsT2``'s tap map, equals ``F.conv_transpose2d`` (stride
  2, padding 1, output_padding 1) in float32, at sizes whose last 16-lane
  tile column is partial.
- The sources: the bfloat16 K6a / K6b / K6c kernels run their convs
  through ``wg::conv`` (no ``mma_conv``), the float32 kernels keep
  ``conv_tile``, and the dtype is dispatched at compile time with no
  fallback.
"""

import os
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import planar_conv as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import res_fused as RF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(
    ROOT, "adversarial_patch_based_false_positive_creation_attacks_against_"
    "aerial_imagery_object_detectors_tpu_torch", "csrc")

# the kernels' tile (csrc/res_fused.cu: tc::TR, tc::TL)
TR, TL = 8, 16


def _stage_tensors(seed=0):
    """The nine weight tensors the bfloat16 kernels read, by name: the
    forward's HWIO w6, w7, w9, w10 (``res_weights``' first half), the
    backward's flip_t kernels and K6c's w12t, bfloat16."""
    rng = np.random.default_rng(seed)
    sp = [(torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16),
           torch.tensor(rng.standard_normal(shape[-1]), dtype=torch.float32))
          for shape in RF.FWD_SHAPES]
    fwd, bwd = RF.res_weights(sp)
    w12 = torch.tensor(rng.standard_normal((3, 3, RF.CIN, 2 * RF.CIN)),
                       dtype=torch.bfloat16)
    names = ("w6", "w7", "w9", "w10")
    out = {n: w for n, (w, _) in zip(names, fwd)}
    out.update({n + "t": w for n, w in zip(names, bwd)})
    out["w12t"] = RF.res12_weights(w12)
    return out


WEIGHTS = ("w6", "w7", "w9", "w10", "w6t", "w7t", "w9t", "w10t", "w12t")


def _gemms(name, w):
    """The GEMMs a weight runs as, [T, K, N] each in the kernel's tap
    order: one (row-major taps) for the forward convs and the adjoints but
    W9's, whose two halves of 64 output channels are two; conv12^T's four
    output parities in ``RowsT2``'s order."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
    kh, kw, k, n = w.shape
    if name == "w12t":
        return [torch.stack([w[dy, dx] for dy, dx in taps])
                for taps in SF.T2_PARITY_TAPS]
    if name == "w9t":
        return [w[..., :n // 2].reshape(1, k, n // 2),
                w[..., n // 2:].reshape(1, k, n // 2)]
    return [w.reshape(kh * kw, k, n)]


@pytest.mark.parametrize("name", WEIGHTS)
def test_stage_frags_invert_to_hwio(name):
    """The packed copy the wrapper passes for each weight (its pointer the
    cached copy's, built once per tensor; none in float32) holds the
    weight's GEMMs back to back, each ``ceil(T K / 64)`` chunks of N rows
    of 64 bfloat16 values (the byte counts the producer walks: 128 N a
    chunk), and element (k, n) of a GEMM lies in its chunk k // 64, row n,
    at the 16-byte unit ((k % 64) // 8) ^ (n % 8), element k % 8."""
    w = _stage_tensors()[name]
    if name == "w12t":
        ptr, build = RF.conv12_packed(w, torch.bfloat16), None
        assert RF.conv12_packed(w.float(), torch.float32) is None
    else:
        builds = RF.BWD_BUILDS if name.endswith("t") else RF.FWD_BUILDS
        build = builds[("w6", "w7", "w9", "w10").index(name.rstrip("t"))]
        ptr = RF.stage_packed([w], [build], torch.bfloat16)[0]
        assert RF.stage_packed([w.float()], [build], torch.float32) == [None]
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
    packed = PC._mma_cached(w, build or SF.wg_weights_t2)
    assert ptr == packed.data_ptr() and packed.dtype == torch.bfloat16
    rows = packed.reshape(-1, 64)
    at = 0
    for g in _gemms(name, w):
        t, k, n = g.shape
        nch = -(-(t * k) // 64)
        kk = torch.arange(t * k)[:, None]
        nn = torch.arange(n)[None, :]
        back = rows[at + (kk // 64) * n + nn,
                    (((kk % 64) // 8) ^ (nn % 8)) * 8 + kk % 8]
        assert torch.equal(back, g.reshape(t * k, n))
        at += nch * n
    assert at * 64 == packed.numel()


def _prologue(gp12: torch.Tensor, w12t: torch.Tensor, h: int, w: int):
    """K6c's prologue as the bfloat16 kernel tiles it, in float32: per
    block (R0, C0) = (8 blockIdx.y, 16 blockIdx.x), the gp12 tile of 7 x 12
    positions from (R0/2 - 1, C0/2 - 2) (zero outside), then per output
    parity (PY, PX) the dense products of ``RowsT2``'s taps over 6 x 10
    super positions (a, b): tap i = (iy, ix), dy = PY ? 2 iy : 1,
    ey = PY ? 1 - iy : 0 (columns alike), tap index dy 3 + dx, input at
    (a + ey, b + ex + (PX ? 0 : 1)) (the even-column parities' grid one
    column right); output (2a + PY, 2b + PX) is tile position
    (2a + PY, 2b + PX + (PX ? -1 : 1)) of the 12 x 20 halo from image
    (R0 - 2, C0 - 3). Returns each block's halo as (image rows, image
    columns, [rows, cols, 128] values) and whether every halo position
    was written exactly once."""
    g = gp12.float()
    wt = w12t.float().reshape(9, *w12t.shape[2:])  # [tap][cin][cout]
    h12, w12 = h // 2, w // 2
    nsr, nsc = 6, 10
    out = []
    for r0 in range(0, h, TR):
        for c0 in range(0, w + 1, TL):
            ir0, ic0 = r0 // 2 - 1, c0 // 2 - 2
            tile = torch.zeros(nsr + 1, nsc + 2, g.shape[-1])
            for r in range(nsr + 1):
                for c in range(nsc + 2):
                    if 0 <= ir0 + r < h12 and 0 <= ic0 + c < w12:
                        tile[r, c] = g[ir0 + r, ic0 + c]
            halo = torch.zeros(12, 20, wt.shape[-1])
            writes = torch.zeros(12, 20, dtype=torch.int32)
            for py in (0, 1):
                for px in (0, 1):
                    sh = 0 if px else 1
                    acc = torch.zeros(nsr, nsc, wt.shape[-1])
                    for iy in range(py + 1):
                        for ix in range(px + 1):
                            dy, ey = (2 * iy, 1 - iy) if py else (1, 0)
                            dx, ex = (2 * ix, 1 - ix) if px else (1, 0)
                            acc += tile[ey:ey + nsr,
                                        ex + sh:ex + sh + nsc] @ \
                                wt[dy * 3 + dx]
                    for a in range(nsr):
                        for b in range(nsc):
                            ty = 2 * a + py
                            tx = 2 * b + px + (-1 if px else 1)
                            halo[ty, tx] = acc[a, b]
                            writes[ty, tx] += 1
            rows = torch.arange(r0 - 2, r0 + 10)
            cols = torch.arange(c0 - 3, c0 + 17)
            out.append((rows, cols, halo, bool((writes == 1).all())))
    return out


@pytest.mark.parametrize("h,w", [(40, 40), (24, 36), (16, 16)])
def test_prologue_parity_gemms_equal_conv_transpose(h, w):
    """The four parity GEMMs give conv12^T gp12 at every position of each
    block's halo that lies in the image (every image position is in some
    block's halo), float32, summation order apart."""
    rng = np.random.default_rng(h + w)
    gp12 = torch.tensor(rng.standard_normal((h // 2, w // 2, 2 * RF.CIN)),
                        dtype=torch.float32)
    w12t = torch.tensor(rng.standard_normal((3, 3, 2 * RF.CIN, RF.CIN))
                        / 48.0, dtype=torch.float32)
    # conv_transpose2d's weight [cin, cout, kh, kw] is conv12's OIHW
    want = F.conv_transpose2d(gp12.permute(2, 0, 1)[None],
                              w12t.permute(2, 3, 0, 1), stride=2, padding=1,
                              output_padding=1)[0].permute(1, 2, 0)
    assert tuple(want.shape) == (h, w, RF.CIN)
    scale = want.abs().max().item()
    seen = torch.zeros(h, w, dtype=torch.bool)
    for rows, cols, halo, once in _prologue(gp12, w12t, h, w):
        assert once
        ri = (rows >= 0) & (rows < h)
        ci = (cols >= 0) & (cols < w)
        got = halo[ri][:, ci]
        ref = want[rows[ri]][:, cols[ci]]
        assert (got - ref).abs().max().item() <= 1e-5 * scale
        seen[rows[ri][:, None], cols[ci][None, :]] = True
    assert seen.all()


def _body(src: str, kern: str) -> str:
    b = src[src.index(kern):]
    return b[:b.index("\n}\n")]


def test_bf16_stage_kernels_run_on_tensor_cores():
    """bfloat16 K6a runs its four convs through ``wg::conv`` (``wgmma``,
    weights streamed by its producer warp: ``wg::produce``, once a GEMM),
    the bfloat16 K6b / K6c kernel its four adjoints (W9^T in two halves),
    plus four parity GEMMs (``RowsT2``) under ``W12``; their tiles come as
    tensor-map boxes; no ``mma_conv`` is left in the file; the float32
    kernels keep ``conv_tile`` (four convs each) and K6c's
    ``conv12_adjoint``; the launchers pick the kernel by dtype at compile
    time (``if constexpr``), the bfloat16 path reaches no FMA kernel, and
    nothing reads an environment switch."""
    src = open(os.path.join(CSRC, "res_fused.cu")).read()
    fwd = _body(src, "res152_fwd_wg_kernel(")
    bwd = _body(src, "res152_bwd_wg_kernel(")
    assert len(re.findall(r"\bwg::conv<", fwd)) == 4
    assert len(re.findall(r"\bwg::produce<", fwd)) == 4
    assert len(re.findall(r"\bwg::conv<", bwd)) == 9
    assert len(re.findall(r"\bwg::produce<", bwd)) == 9
    w12 = bwd[bwd.index("if constexpr (W12) {\n    // the gp12 tile"):
              bwd.index("} else {\n    consume")]
    assert len(re.findall(r"\bwg::conv<", w12)) == 4
    assert sorted(re.findall(r"RowsT2<(\d), (\d)>", w12)) == [
        ("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]
    for body in (fwd, bwd):
        assert "produce_boxes<" in body and "consume_boxes<" in body
        assert "conv_tile" not in body
    assert "mma_conv" not in src and "mma_bf16" not in src
    assert "wg::tma_load_4d(" in src and "wg::planar_map(" in src
    assert len(re.findall(r"\bconv_tile<",
                          _body(src, "res152_fwd_kernel("))) == 4
    f32_bwd = _body(src, "res152_bwd_kernel(")
    assert len(re.findall(r"\bconv_tile<", f32_bwd)) == 4
    assert "conv12_adjoint<T>(" in f32_bwd
    # dispatch: bfloat16 always to the wgmma kernels
    for fn in ("int fwd_any(", "int bwd_any("):
        body = _body(src, fn)
        assert "if constexpr (sizeof(T) == 2)" in body
        tc = body[body.index("if constexpr"):body.index("} else {")]
        assert "_wg<" in tc and "launch_fwd<" not in tc \
            and "launch_bwd<" not in tc
    assert not re.search(r"res152_(fwd|bwd)_kernel<\s*(bf16|__nv_bfloat16)",
                         src)
    assert "getenv" not in src


def test_stage_kernels_info_entry_points_are_declared():
    """``chip_smoke.py`` phase 1 reads each stage kernel's registers,
    shared memory and blocks per multiprocessor through its ``_info``
    entry point: declared in the source and bound in ``_cuda.SIGNATURES``
    as (dtype, flag, info[3])."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    src = open(os.path.join(CSRC, "res_fused.cu")).read()
    sig = _cuda.SIGNATURES["res_fused"]
    for name, flag in (("apfp_res152_fused_info", "save"),
                       ("apfp_res152_fused_grad_info", "w12")):
        assert f'extern "C" int {name}(int dtype, int {flag}, int* info)' \
            in src
        assert sig[name] == [_cuda._I, _cuda._I, _cuda._P]
