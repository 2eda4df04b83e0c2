"""The bfloat16 152^2 stage kernels' tensor-core design, checked on the
CPU (the kernels themselves run only on a card: ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold them against their plain versions there).

- The fragment-order weights the wrappers hand the bfloat16 kernels
  (``res_fused.stage_frags``: ``mma_weights`` through ``_mma_cached``) for
  the forward's four HWIO kernels, the backward's four ``flip_t`` kernels
  and K6c's ``res12_weights`` invert to their HWIO source through
  ``mma_weights``' documented index map.
- K6c's prologue: g11 = conv12^T gp12 as four parity GEMMs over each
  block's unexpanded gp12 tile, with the kernel's tile origins and
  ``RowsT2``'s tap map, equals ``F.conv_transpose2d`` (stride 2, padding 1,
  output_padding 1) in float32, at sizes whose last 16-lane tile column is
  partial.
- The sources: the bfloat16 K6a / K6b / K6c kernels run their convs
  through ``mma_conv``, the float32 kernels keep ``conv_tile``, and the
  dtype is dispatched at compile time with no fallback.
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


@pytest.mark.parametrize("name", WEIGHTS)
def test_stage_frags_invert_to_hwio(name):
    """Lane 4g + t of the 16-deep step s and 8-wide block j of tap i holds
    B[k][8j + g] at k = 16s + 2t + (0, 1, 8, 9): the wrappers' fragment
    copy of each weight, read back through that map, is the HWIO tensor;
    it is built once per tensor, and float32 passes none."""
    w = _stage_tensors()[name]
    ptrs = RF.stage_frags([w], torch.bfloat16)
    frag = PC._mma_cached(w)
    assert ptrs == [frag.data_ptr()]
    assert RF.stage_frags([w.float()], torch.float32) == [None]
    kh, kw, k, n = w.shape
    assert tuple(frag.shape) == (kh * kw, k // 16, n // 8, 32, 4)
    assert frag.dtype == torch.bfloat16
    tap, s, j, lane, e = np.meshgrid(
        np.arange(kh * kw), np.arange(k // 16), np.arange(n // 8),
        np.arange(32), np.arange(4), indexing="ij")
    g, t = lane // 4, lane % 4
    kk = 16 * s + 2 * t + np.array([0, 1, 8, 9])[e]
    back = w.reshape(kh * kw, k, n)[tap, kk, 8 * j + g]
    assert torch.equal(frag, back)
    # every element of w appears exactly once
    assert frag.numel() == w.numel()


def _prologue(gp12: torch.Tensor, w12t: torch.Tensor, h: int, w: int):
    """K6c's prologue as the bfloat16 kernel tiles it, in float32: per
    block (R0, C0) = (8 blockIdx.y, 16 blockIdx.x), the gp12 tile of 7 x 12
    super positions from (R0/2 - 1, C0/2 - 2) (zero outside), then per
    output parity (PY, PX) the dense products of ``RowsT2``'s taps over
    the 6 x 11 super positions (a, b): tap i = (iy, ix), dy = PY ? 2 iy : 1,
    ey = PY ? 1 - iy : 0 (columns alike), tap index dy 3 + dx, input at
    (a + ey, b + ex); output (2a + PY, 2b + PX) is tile position
    (2a + PY, 2b + PX - 1) of the 12 x 20 halo from image (R0 - 2,
    C0 - 3), kept inside the tile and the image. Returns each block's
    halo as (image rows, image columns, [rows, cols, 128] values)."""
    g = gp12.float()
    wt = w12t.float().reshape(9, *w12t.shape[2:])  # [tap][cin][cout]
    h12, w12 = h // 2, w // 2
    nsr, nsc = 6, 11
    out = []
    for r0 in range(0, h, TR):
        for c0 in range(0, w + 1, TL):
            ir0, ic0 = r0 // 2 - 1, c0 // 2 - 2
            tile = torch.zeros(nsr + 1, nsc + 1, g.shape[-1])
            for r in range(nsr + 1):
                for c in range(nsc + 1):
                    if 0 <= ir0 + r < h12 and 0 <= ic0 + c < w12:
                        tile[r, c] = g[ir0 + r, ic0 + c]
            halo = torch.zeros(12, 20, wt.shape[-1])
            for py in (0, 1):
                for px in (0, 1):
                    acc = torch.zeros(nsr, nsc, wt.shape[-1])
                    for iy in range(py + 1):
                        for ix in range(px + 1):
                            dy, ey = (2 * iy, 1 - iy) if py else (1, 0)
                            dx, ex = (2 * ix, 1 - ix) if px else (1, 0)
                            acc += tile[ey:ey + nsr, ex:ex + nsc] @ \
                                wt[dy * 3 + dx]
                    for a in range(nsr):
                        for b in range(nsc):
                            ty, tx = 2 * a + py, 2 * b + px - 1
                            if 0 <= tx < 20:
                                halo[ty, tx] = acc[a, b]
            rows = torch.arange(r0 - 2, r0 + 10)
            cols = torch.arange(c0 - 3, c0 + 17)
            out.append((rows, cols, halo))
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
    for rows, cols, halo in _prologue(gp12, w12t, h, w):
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
    """bfloat16 K6a runs its four convs through ``mma_conv``, the bfloat16
    K6b / K6c kernel its four adjoints, plus four parity GEMMs (``RowsT2``)
    under ``W12``; the float32 kernels keep ``conv_tile`` (four convs each)
    and K6c's ``conv12_adjoint``; the launchers pick the kernel by dtype at
    compile time (``if constexpr``), the bfloat16 path reaches no FMA
    kernel, and nothing reads an environment switch."""
    src = open(os.path.join(CSRC, "res_fused.cu")).read()
    fwd = _body(src, "res152_fwd_tc_kernel(")
    bwd = _body(src, "res152_bwd_tc_kernel(")
    assert len(re.findall(r"\bmma_conv<", fwd)) == 4
    assert len(re.findall(r"\bmma_conv<", bwd)) == 8
    w12 = bwd[bwd.index("if constexpr (W12)"):bwd.index("} else {")]
    assert len(re.findall(r"\bmma_conv<", w12)) == 4
    assert sorted(re.findall(r"RowsT2<(\d), (\d)>", w12)) == [
        ("0", "0"), ("0", "1"), ("1", "0"), ("1", "1")]
    assert "conv_tile" not in fwd and "conv_tile" not in bwd
    assert len(re.findall(r"\bconv_tile<",
                          _body(src, "res152_fwd_kernel("))) == 4
    f32_bwd = _body(src, "res152_bwd_kernel(")
    assert len(re.findall(r"\bconv_tile<", f32_bwd)) == 4
    assert "conv12_adjoint<T>(" in f32_bwd
    # dispatch: bfloat16 always to the tensor-core kernels
    for fn in ("int fwd_any(", "int bwd_any("):
        body = _body(src, fn)
        assert "if constexpr (sizeof(T) == 2)" in body
        tc = body[body.index("if constexpr"):body.index("} else {")]
        assert "_tc<" in tc and "launch_fwd<" not in tc \
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
