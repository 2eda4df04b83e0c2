"""The port's TPU-route A/B micro tools (``<port>/tools/``: ``conv_micro``,
``s2dx_poly_ab``, ``c12_micro``, ``stem_ab``, ``stem_fused_ab``,
``c12_ab``) on the CPU, at tiny shapes:

- the library forms against the repository tools' JAX expressions in
  float32, max |err| / max |want| <= 1e-5 (float32 convolutions and
  GEMMs in different summation orders): ``conv_micro.conv`` and its input
  gradient (the repository tool loaded by path: its module level only
  defines names), the three stride-2 adjoints of ``s2dx_poly_ab`` (the
  repository tool loaded with ``sys.argv`` naming a batch of 3, which its
  functions read from the module; the port's read it from g),
  ``c12_micro.c12_dx`` and ``stem_ab.xla_stem`` with its input gradient
  (rebuilt from ``jax.lax``: those repository tools run at import), and
  ``stem_fused_ab``'s fused forward against the Pallas kernel in
  interpret mode at 64^2, batch 1;
- the port alone: ``stem_ab``'s chained pieces equal ``_stem_bwd`` bit
  for bit, ``c12_ab.check_route`` exits non-zero where a route was asked
  and not taken, ``stem_fused_ab`` refuses ``s5``, ``time_calls`` refuses
  a non-finite result, and every tool's ``main`` runs end to end on the
  CPU at tiny sizes with finite rows.
"""

import importlib
import importlib.util
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.ops import stem_fused as JSF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import (
    Darknet, build_network, fold_bn, init_params, tiny_test_blocks,
    yolov3_blocks)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models.stem_planar import (
    _forward, _stem_bwd, planar_stem_params)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils.profiling import (
    time_calls)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
TOL = 1e-5


def _tool(name):
    return importlib.import_module(f"{PORT}.tools.{name}")


def _repo_tool(name, *argv):
    """The repository's ``tools/<name>.py`` loaded by path, with
    ``sys.argv`` set to ``[name, *argv]`` while its module level runs."""
    saved = sys.argv
    sys.argv = [name, *argv]
    try:
        spec = importlib.util.spec_from_file_location(
            f"repo_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.argv = saved


def _max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _stem_params(rng, dtype=np.float32):
    """(HWIO weight, bias) numpy pairs of stem convs 0, 1, 2, 3, 5."""
    return [((rng.standard_normal((k, k, cin, cout)) * 0.1).astype(dtype),
             (rng.standard_normal(cout) * 0.1).astype(np.float32))
            for cin, cout, k in _tool("stem_ab").STEM]


def _torch_sp(sp, dtype=torch.float32):
    return [(torch.from_numpy(w).to(dtype), torch.from_numpy(b))
            for w, b in sp]


def jax_stem(v, sp):
    """The repository ``tools/stem_ab.py``'s ``xla_stem`` with its
    weights passed in."""
    def conv(u, w, b, s):
        pad = (w.shape[0] - 1) // 2
        y = lax.conv_general_dilated(
            u, w.astype(u.dtype), (s, s), [(pad, pad), (pad, pad)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            precision=lax.Precision.HIGHEST)
        y = y + b.astype(y.dtype)
        return jnp.where(y > 0, y, 0.1 * y)
    sp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]
    y0 = conv(v, *sp[0], 1)
    y1 = conv(y0, *sp[1], 2)
    y2 = conv(y1, *sp[2], 1)
    y3 = conv(y2, *sp[3], 1)
    return conv(y3 + y1, *sp[4], 2)


# --- JAX parity ----------------------------------------------------------

@pytest.mark.parametrize("h,cin,cout,k,s", [
    (16, 3, 8, 3, 1), (16, 8, 16, 3, 2), (12, 16, 8, 1, 1)])
def test_conv_micro_conv_and_dx_equal_the_repository_tool(h, cin, cout, k,
                                                          s):
    jt = _repo_tool("conv_micro")
    CM = _tool("conv_micro")
    rng = np.random.default_rng(h + cin)
    x = rng.standard_normal((2, h, h, cin)).astype(np.float32)
    w = rng.standard_normal((k, k, cin, cout)).astype(np.float32)
    want = jt.conv(jnp.asarray(x), jnp.asarray(w), s)
    wt = CM.library_weight(torch.from_numpy(w))
    assert torch.equal(wt, torch.from_numpy(w))
    got = CM.conv(torch.from_numpy(x), wt, s)
    assert _max_rel(got.numpy(), want) <= TOL
    g = rng.standard_normal(want.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jt.conv(v, jnp.asarray(w), s), jnp.asarray(x))
    want_dx = vjp(jnp.asarray(g))[0]
    got_dx = CM.conv_dx(torch.from_numpy(g), wt, s, x.shape)
    assert got_dx.shape == x.shape
    assert _max_rel(got_dx.numpy(), want_dx) <= TOL


@pytest.mark.parametrize("fn", ["s2dx_xla", "s2dx_poly", "s2dx_poly_conv"])
@pytest.mark.parametrize("h", [16, 14])
def test_s2dx_forms_equal_the_repository_tool(fn, h):
    """At batch 3 (the repository tool's functions read their batch from
    the module's ``B``, set through ``sys.argv``; the port's from g), on
    an even and an odd-half height."""
    jt = _repo_tool("s2dx_poly_ab", "3")
    assert jt.B == 3
    S = _tool("s2dx_poly_ab")
    rng = np.random.default_rng(h)
    cin, cout = 8, 16
    w = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    g = rng.standard_normal((3, h // 2, h // 2, cout)).astype(np.float32)
    xshape = (3, h, h, cin)
    want = getattr(jt, fn)(jnp.asarray(g), jnp.asarray(w), xshape)
    got = getattr(S, fn)(torch.from_numpy(g), torch.from_numpy(w), xshape)
    assert tuple(got.shape) == xshape
    assert _max_rel(got.numpy(), want) <= TOL


def test_c12_dx_equals_the_repository_tools_vjp():
    """``c12_micro.c12_dx`` against the repository tool's conv12 dgrad
    (``jax.vjp`` of the stride-2 conv, rebuilt: the tool defines it inside
    ``main``), at C = 8."""
    rng = np.random.default_rng(12)
    c, h = 8, 16
    w12 = (rng.standard_normal((3, 3, c, 2 * c)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, h, h, c)).astype(np.float32)
    g = rng.standard_normal((2, h // 2, h // 2, 2 * c)).astype(np.float32)

    def c12(v):
        return lax.conv_general_dilated(
            v, jnp.asarray(w12), (2, 2), [(1, 1)] * 2,
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
    _, vjp = jax.vjp(c12, jnp.asarray(x))
    want = vjp(jnp.asarray(g))[0]
    got = _tool("c12_micro").c12_dx(torch.from_numpy(g),
                                   torch.from_numpy(w12))
    assert got.shape == x.shape
    assert _max_rel(got.numpy(), want) <= TOL


def test_xla_stem_and_its_gradient_equal_the_repository_tools():
    SA = _tool("stem_ab")
    rng = np.random.default_rng(5)
    sp = _stem_params(rng)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    want = jax_stem(jnp.asarray(x), sp)
    got = SA.xla_stem(torch.from_numpy(x), _torch_sp(sp))
    assert _max_rel(got.numpy(), want) <= TOL
    want_g = jax.grad(lambda v: jnp.sum(jax_stem(v, sp)))(jnp.asarray(x))
    got_g = SA.input_grad(SA.loss_xla, torch.from_numpy(x), _torch_sp(sp))
    assert _max_rel(got_g.numpy(), want_g) <= TOL
    # stem_fused_ab's is the same walk
    assert torch.equal(_tool("stem_fused_ab").xla_stem(
        torch.from_numpy(x), _torch_sp(sp)), got)


def test_fused_forward_equals_the_pallas_kernel_in_interpret_mode():
    """``stem_fused_ab.fused`` (split_phases -> K1 -> from_planar, plain
    versions on the CPU) against ``fused_stem_fwd(interpret=True)`` at
    64^2, batch 1, float32."""
    rng = np.random.default_rng(9)
    sp = _stem_params(rng)
    x = rng.random((1, 64, 64, 3)).astype(np.float32)
    je, jo = JSF.split_phases(jnp.asarray(x))
    jsp = [(jnp.asarray(w), jnp.asarray(b)) for w, b in sp]
    y5p = np.asarray(JSF.fused_stem_fwd(je, jo, jsp, interpret=True))
    want = y5p[:, :, :, 1:17].transpose(0, 1, 3, 2)
    got = _tool("stem_fused_ab").fused(torch.from_numpy(x), _torch_sp(sp))
    assert got.shape == (1, 16, 16, 128)
    assert _max_rel(got.numpy(), want) <= TOL


# --- the port alone -------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_ab_chain_equals_stem_bwd(dtype):
    """The pieces, each run on the previous one's output, end where
    ``_stem_bwd`` ends, bit for bit (the same plain versions on the same
    inputs), and the last piece is ``from_planar``'s narrow form."""
    SA = _tool("stem_ab")
    rng = np.random.default_rng(3)
    sp = _torch_sp(_stem_params(rng), dtype)
    h = 64
    x = torch.from_numpy(rng.random((2, h, h, 3))).to(dtype)
    fwd, bwd = planar_stem_params(sp)
    with torch.no_grad():
        acts = _forward(x, fwd)
        g5 = torch.from_numpy(rng.random((2, h // 4, h // 4, 128))).to(dtype)
        pieces, gx = SA.chain(acts, g5, sp, h)
        assert len(pieces) == 8 and pieces[0][2] is g5
        g = g5
        for _, fn, arg in pieces:
            assert torch.equal(arg, g)
            g = fn(arg)
        assert torch.equal(g, gx)
        want = _stem_bwd(acts, g5, bwd, h)
    assert gx.shape == (2, h, h, 3)
    assert torch.equal(gx, want)


@pytest.fixture(scope="module")
def c12_model():
    """The full-width YOLOv3 (random weights, BN-folded) on the CPU in
    float32, and a tiny network that has no c12 route."""
    net = build_network(yolov3_blocks())
    tiny = build_network(tiny_test_blocks(width=64, height=64))
    return (Darknet(net, fold_bn(net, init_params(net, 1)), device="cpu"),
            Darknet(tiny, fold_bn(tiny, init_params(tiny, 1)),
                    device="cpu"))


@pytest.mark.parametrize("case", ["c12_not_square", "c12_on_tiny",
                                  "default_not_square", "default_after_c12"])
def test_check_route_exits_where_the_route_was_not_taken(c12_model, case):
    """On a 64 x 96 input the stem's and the c12 gates fail
    (``stem_shape_ok``, ``c12_shape_ok``: not square); the tiny network
    has no c12 route (``has_c12``); a c12 forward is not the default
    route. Each exits non-zero; the routes asked for and taken pass."""
    AB = _tool("c12_ab")
    yolo, tiny = c12_model
    model, shape, run_c12, check_c12 = {
        "c12_not_square": (yolo, (1, 64, 96, 3), True, True),
        "c12_on_tiny": (tiny, (1, 64, 64, 3), True, True),
        "default_not_square": (yolo, (1, 64, 96, 3), False, False),
        "default_after_c12": (yolo, (1, 64, 64, 3), True, False)}[case]
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(x, fused_stem=True, res152="c12" if run_c12 else None)
    with pytest.raises(SystemExit) as exc:
        AB.check_route(check_c12)
    assert exc.value.code not in (0, None)
    # taken where it applies
    with torch.no_grad():
        yolo(torch.rand(1, 64, 64, 3), fused_stem=True, res152="c12")
        assert AB.check_route(True) == {"stem": "c12", "res152": "c12"}
        yolo(torch.rand(1, 64, 64, 3), fused_stem=True)
        assert AB.check_route(False) == {"stem": "fused", "res152": "conv"}


def test_stem_fused_ab_refuses_s5(capsys):
    with pytest.raises(SystemExit) as exc:
        _tool("stem_fused_ab").main(["1", "64", "8", "--device", "cpu"])
    assert exc.value.code == 2
    assert "pinned deviation" in capsys.readouterr().err


def test_time_calls_refuses_a_non_finite_result():
    calls = []

    def fn():
        calls.append(1)
        return torch.tensor([1.0, float("nan")])
    with pytest.raises(FloatingPointError):
        time_calls(fn, 2, "cpu", warmup=1)
    assert len(calls) == 3
    seconds, out = time_calls(lambda: torch.ones(3), 2, "cpu")
    assert seconds >= 0 and torch.equal(out, torch.ones(3))


def _finite(values):
    return all(math.isfinite(v) for v in values)


def test_conv_micro_main(monkeypatch, capsys):
    CM = _tool("conv_micro")
    monkeypatch.setattr(CM, "SHAPES", (("a 16^2 3->8 k3s1", 16, 3, 8, 3, 1),
                                       ("b 16^2 8->16 k3s2", 16, 8, 16, 3, 2),
                                       ("c 8^2 16->8 k1s1", 8, 16, 8, 1, 1)))
    monkeypatch.setattr(CM, "ITERS", 2)
    monkeypatch.setattr(CM, "HOST_BOUND_MS", float("inf"))
    out = CM.main(["2", "--device", "cpu"])
    assert [r["name"] for r in out["rows"]] == [s[0] for s in CM.SHAPES]
    for r in out["rows"]:
        assert _finite([r["fwd_ms"], r["dx_ms"], r["fwd_tflops"],
                        r["dx_tflops"]])
    assert math.isclose(out["sum_fwd_ms"],
                        sum(r["fwd_ms"] for r in out["rows"]))
    # every row reads under an infinite threshold
    assert len(out["host_bound"]) == 2 * len(CM.SHAPES)
    assert "a 16^2 3->8 k3s1" in capsys.readouterr().out


def test_s2dx_poly_ab_main(monkeypatch):
    S = _tool("s2dx_poly_ab")
    monkeypatch.setattr(S, "CASES", [("s2 16^2 8->16", 16, 8, 16),
                                     ("s2 8^2 16->32", 8, 16, 32)])
    monkeypatch.setattr(S, "ITERS", 2)
    out = S.main(["3", "--device", "cpu"])
    assert len(out["rows"]) == 2 and out["batch"] == 3
    for r in out["rows"]:
        assert _finite([r["xla_ms"], r["poly_ms"], r["poly_conv_ms"]])
        assert r["relerr_poly"] <= TOL and r["relerr_poly_conv"] <= TOL


def test_c12_micro_main(monkeypatch, capsys):
    C = _tool("c12_micro")
    monkeypatch.setattr(C, "H", 16)
    monkeypatch.setattr(C, "ITERS", 2)
    out = C.main(["1", "--device", "cpu"])
    times = [out[k] for k in ("fwd_save_ms", "bwd_g11_ms", "bwd_g12_ms",
                              "conv12_dgrad_ms")]
    assert _finite(times)
    assert math.isclose(out["widened_minus_parts_ms"],
                        times[2] - times[1] - times[3])
    assert "widened - (g11 + xla12)" in capsys.readouterr().out


def test_stem_ab_main(monkeypatch):
    SA = _tool("stem_ab")
    monkeypatch.setattr(SA, "ITERS", 2)
    out = SA.main(["1", "64", "--device", "cpu"])
    assert out["chain_vs_stem_bwd_differing"] == 0
    assert len(out["pieces_ms"]) == 8 and len(out["ms"]) == 4
    assert _finite([*out["ms"].values(), *out["pieces_ms"].values()])
    assert math.isclose(out["pieces_sum_ms"], sum(out["pieces_ms"].values()))


def test_stem_fused_ab_main(monkeypatch):
    SF = _tool("stem_fused_ab")
    monkeypatch.setattr(SF, "ITERS", 2)
    out = SF.main(["1", "64", "--device", "cpu"])
    assert len(out["ms"]) == 6 and _finite(out["ms"].values())
    # bfloat16 plain versions against the cuDNN walk's stand-in
    assert out["fused_fwd_rel_err_b1"] < 5e-2


@pytest.mark.parametrize("argv", [["grad"], ["grad", "c12"], ["step", "2"],
                                  ["step", "2", "c12"]])
def test_c12_ab_main(monkeypatch, argv):
    """Both modes on both routes at 64^2 (the full-width network, which
    takes the c12 route there; patch 16)."""
    AB = _tool("c12_ab")
    SP = _tool("step_profile")
    blocks = lambda: yolov3_blocks(width=64, height=64)  # noqa: E731
    for mod in (AB, SP):
        monkeypatch.setattr(mod, "IMG", 64)
        monkeypatch.setattr(mod, "yolov3_blocks", blocks)
    monkeypatch.setattr(SP, "PATCH", 16)
    monkeypatch.setattr(AB, "STEPS", 1)
    out = AB.main(argv + ["--device", "cpu"])
    c12 = argv[-1] == "c12"
    assert out["route"] == ("c12" if c12 else "default")
    assert out["routes"] == AB.WANT_ROUTES[c12]
    keys = (("loss", "gsum", "gmax", "gnorm") if argv[0] == "grad"
            else ("ms_per_step", "steps_per_min", "loss"))
    assert _finite([out[k] for k in keys])


def test_c12_ab_refuses_a_bad_argv():
    AB = _tool("c12_ab")
    for argv in (["step"], ["step", "c12"], ["grad", "2"], ["step", "x"]):
        with pytest.raises(SystemExit) as exc:
            AB.main(argv + ["--device", "cpu"])
        assert exc.value.code == 2, argv
