"""The port's serving and training measurement tools and warp quality
A/Bs (``<port>/tools/``) on the CPU, at tiny sizes:

- ``victims.craft_brightness_victim`` against the repository's helper
  (``tests/test_attack_closed_loop.py``): parameters within 1e-6, heads
  within 1e-5;
- the A/B tools' evaluation leg against the JAX tools' on one fixed
  patch and the tools' own scenes, with the paste's draws rebuilt from
  ``PRNGKey(5)``: the patched scenes within 1e-5 (float32 warps
  interpolating in different orders), M1 / M2 within 1e-4;
- both A/B tools, ``serve_soak``, ``serving_throughput``,
  ``detector_throughput`` and ``perf_breakdown`` end to end on tiny
  victims; ``serve_soak``'s ramp against the repository tool's
  expression and its report against the repository tool's keys;
- ``step_profile``'s parse-only mode on a synthetic Chrome trace, and its
  attribution against the by-kind split that ``chip_smoke.py`` phase 12
  made inline before it called the tool.
"""

import ast
import collections
import contextlib
import gzip
import importlib
import io
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import evals as JEV
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import apply as jax_apply
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.evals import Detector
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import (
    apply, tiny_test_blocks)
from test_attack_closed_loop import craft_brightness_victim as jax_victim
from test_torch_eot import jax_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
IMG = 64


def _tool(name):
    return importlib.import_module(f"{PORT}.tools.{name}")


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args)


def _tiny_victim(monkeypatch, module, **sizes):
    """Swap the full-width network the tool builds (``yolov3_blocks()``
    in ``module``) for ``tiny_test_blocks`` at 64^2, and the module's
    608^2 (``IMG``) and other ``sizes`` for tiny ones, so the tool runs its
    own code and counts on the CPU in seconds."""
    monkeypatch.setattr(module, "yolov3_blocks",
                        lambda: tiny_test_blocks(width=IMG, height=IMG))
    for name, value in dict(IMG=IMG, **sizes).items():
        monkeypatch.setattr(module, name, value)


def test_brightness_victim_equals_the_repository_helper():
    net, params = _tool("victims").craft_brightness_victim()
    jnet, jparams = jax_victim()
    assert set(params) == set(jparams)
    for k, p in params.items():
        assert set(p) == {"w", "b"}
        # the port's kernels are OIHW, the JAX package's HWIO
        np.testing.assert_allclose(
            p["w"].numpy(), np.asarray(jparams[k]["w"]).transpose(3, 2, 0, 1),
            rtol=0, atol=1e-6)
        np.testing.assert_allclose(p["b"].numpy(), np.asarray(jparams[k]["b"]),
                                   rtol=0, atol=1e-6)
    for v in (0.2, 0.5, 0.9):
        x = np.full((1, IMG, IMG, 3), v, np.float32)
        with torch.no_grad():
            got = apply(net, params, torch.from_numpy(x))
        want = jax_apply(jnet, jparams, jnp.asarray(x))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-5)
    # the calibration's anchor: brightness 0.9 -> objectness logit +3
    assert abs(float(got[0][0, 0, 0, 4]) - 3.0) < 1e-4


@pytest.fixture(scope="module")
def ab_eval():
    """The A/B tools' held-out scenes and the crafted victim's detectors,
    port and JAX package, with their clean detections at 0.4 / 0.01."""
    WA = _tool("warp_ab")
    imgs, labs = WA.scenes(42, 64)
    net, params = _tool("victims").craft_brightness_victim()
    det = Detector(net, params, img_size=IMG, compute_dtype=torch.float32,
                   max_candidates=256, device="cpu")
    jdet = JEV.Detector(*jax_victim(), img_size=IMG,
                        compute_dtype=jnp.float32, max_candidates=256)
    confs = (0.4, 0.01)
    return dict(imgs=imgs, labs=labs, det=det, jdet=jdet,
                clean={c: det.detect_batch(imgs, c, 0.4) for c in confs},
                jclean={c: jdet.detect_batch(imgs, c, 0.4) for c in confs})


@pytest.mark.parametrize("tool,warp", [("warp_ab", "mxu"),
                                       ("warp_ab", "gather"),
                                       ("warp_dtype_ab", None)])
def test_ab_evaluation_leg_equals_the_jax_tools(ab_eval, tool, warp):
    """One fixed patch pasted on the tools' 64 held-out scenes with the
    draws of ``PRNGKey(5)``: ``warp_ab`` through each warp (``gather``
    against the JAX package's exact gather), ``warp_dtype_ab`` through
    the default float32 paste; then M1 / M2 at 0.4 and 0.01."""
    WA = _tool("warp_ab")
    imgs, labs = ab_eval["imgs"], ab_eval["labs"]
    patch = np.random.default_rng(3).random((16, 16, 3)).astype(np.float32)
    kw = {} if warp is None else {"warp_method": warp}
    jcfg = JE.EOTConfig(img_size=IMG, do_rotate=True, **kw)
    key = jax.random.PRNGKey(5)
    want, _ = JE.apply_eot_patch(jnp.asarray(patch), jnp.asarray(imgs),
                                 jnp.asarray(labs), key, jcfg)
    want = np.asarray(want)
    got = WA.paste(torch.from_numpy(patch), torch.from_numpy(imgs),
                   torch.from_numpy(labs), jax_draws(key, 64, 16, jcfg),
                   *([] if warp is None else [warp]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    row = WA.creation_row(ab_eval["det"], got, ab_eval["clean"])
    jdet = ab_eval["jdet"]
    for conf in (0.4, 0.01):
        pre = jdet.detect_batch(want, conf, 0.4)
        cl = ab_eval["jclean"][conf]
        m1 = JEV.m1_average_instances_created(pre, cl, n_images=64)
        m2 = JEV.m2_average_confidence_created(pre, cl)
        assert abs(row[f"M1@{conf}"] - m1) <= 1e-4, (conf, row, m1)
        assert abs(row[f"M2@{conf}"] - m2) <= 1e-4, (conf, row, m2)
    assert row["M1@0.4"] > 0     # the bright patch creates detections


@pytest.mark.parametrize("tool,rows", [("warp_ab", 4), ("warp_dtype_ab", 2)])
def test_ab_tools_run_end_to_end(tool, rows):
    rec = _quiet(_tool(tool).main, ["5", "8", "--device", "cpu"])
    assert (rec["steps"], rec["n_eval"]) == (5, 8)
    assert len(rec["table"]) == rows
    for row in rec["table"]:
        for c in ("M1@0.4", "M2@0.4", "M1@0.01", "M2@0.01"):
            assert np.isfinite(row[c]), row
    if tool == "warp_ab":
        assert [(r["train_warp"], r["paste_warp"]) for r in rec["table"]] \
            == [(t, p) for t in ("mxu", "gather") for p in ("mxu", "gather")]
    else:
        assert [r["warp_dtype"] for r in rec["table"]] == ["float32",
                                                           "bfloat16"]


def _jax_soak_source():
    return ast.parse(open(os.path.join(REPO, "tools", "serve_soak.py")).read())


def test_serve_soak_ramp_equals_the_repository_expression():
    """``clients_at`` against the repository tool's inline ramp (its
    ``phase[0] = ...`` statement, evaluated as written), on a grid of
    elapsed times (the thirds' edges included) and client counts."""
    (stmt,) = [n for n in ast.walk(_jax_soak_source())
               if isinstance(n, ast.Assign)
               and isinstance(n.targets[0], ast.Subscript)
               and getattr(n.targets[0].value, "id", "") == "phase"]
    expr = compile(ast.Expression(stmt.value), "serve_soak", "eval")
    clients_at = _tool("serve_soak").clients_at
    for duration in (3.0, 90.0, 1800.0):
        third = duration / 3.0
        grid = list(np.linspace(0, duration * 1.1, 47)) + [third, 2 * third]
        for clients in (1, 2, 3, 16):
            args = types.SimpleNamespace(duration=duration, clients=clients)
            for el in grid:
                want = eval(expr, {"args": args, "el": el, "third": third})
                assert clients_at(el, duration, clients) == want, (el,
                                                                   clients)


def test_serve_soak_reports_the_repository_keys(tmp_path, monkeypatch):
    """A 2 s soak on a tiny detector: the report has every key of the
    repository tool's ``report``, ``--out`` holds it with the RSS samples,
    and ``requests`` counts every answered request but the warm one."""
    SS = _tool("serve_soak")
    services = []

    class Recorded(SS.DetectionService):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            services.append(self)

    monkeypatch.setattr(SS, "DetectionService", Recorded)
    _tiny_victim(monkeypatch, _tool("serving_throughput"))
    out = str(tmp_path / "soak.json")
    rep = _quiet(SS.main, ["--duration", "2", "--clients", "4",
                           "--max-batch", "4", "--img-size", str(IMG),
                           "--out", out, "--device", "cpu"])
    (node,) = [n for n in ast.walk(_jax_soak_source())
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "report"]
    keys = [k.value for k in node.value.keys]
    assert list(rep) == keys
    assert rep["requests"] > 0 and rep["req_per_s"] > 0
    assert services[0].stats.requests == rep["requests"] + 1
    assert set(rep["latency_ms"]) == {"p50", "p95", "p99", "max"}
    assert rep["latency_ms"]["p50"] <= rep["latency_ms"]["p99"]
    assert (rep["max_batch"], rep["wire"], rep["img_size"]) == (4, "uint8",
                                                                IMG)
    with open(out) as f:
        saved = json.load(f)
    assert list(saved) == keys and saved["requests"] == rep["requests"]


def test_serving_throughput_on_a_tiny_detector(monkeypatch):
    ST = _tool("serving_throughput")
    _tiny_victim(monkeypatch, ST)
    rec = _quiet(ST.main, ["24", "4", "3", "uint8", "--device", "cpu"])
    # the service's own count: every request and the warm one
    assert rec["served"] == 24 + 1 and rec["img_per_s"] > 0
    assert 1 <= rec["mean_fill"] <= 4
    # every request and the warm one, in batches of at most 4
    assert rec["batches"] >= 7


def test_detector_throughput_on_a_tiny_detector(monkeypatch):
    _tiny_victim(monkeypatch, _tool("serving_throughput"))
    rec = _quiet(_tool("detector_throughput").main, ["2", "--device", "cpu"])
    for line in ("device_pipeline", "end_to_end", "detect_batch_device"):
        r = rec[line]
        assert np.isfinite(r["ms_per_batch"]) and r["img_per_s"] > 0, rec
    assert (rec["batch"], rec["img_size"]) == (2, IMG)


def test_perf_breakdown_on_tiny_blocks(monkeypatch):
    """The tool's own 3 + 30 steps on the tiny network (64^2, patch 16)."""
    _tiny_victim(monkeypatch, _tool("step_profile"), PATCH=16)
    rec = _quiet(_tool("perf_breakdown").main, ["2", "--device", "cpu"])
    assert (rec["batch"], rec["steps"], rec["devices"]) == (2, 30, 1)
    assert rec["ms_per_step"] > 0 and np.isfinite(rec["loss"])
    assert rec["routes"]["stem"] == "conv"


# synthetic device operations: (name, category, trace category, start us,
# duration us); the window is [1000, 5000)
SYNTHETIC_OPS = [
    ("void (anonymous namespace)::fused_stem_fwd_kernel<__nv_bfloat16, 8, "
     "true>(Args)", "stem-fwd", "kernel", 1000, 300),
    ("void (anonymous namespace)::fused_stem_remat_tc_kernel<8>(Args)",
     "stem-fwd", "kernel", 1300, 40),
    ("void (anonymous namespace)::fused_stem_bwd_tc_kernel<8>(Args)",
     "stem-bwd", "kernel", 1400, 200),
    ("void (anonymous namespace)::to_planar_narrow_kernel<__nv_bfloat16>"
     "(Args)", "layout", "kernel", 1600, 20),
    ("void (anonymous namespace)::from_planar_tiled_kernel<__nv_bfloat16>"
     "(Args)", "layout", "kernel", 1620, 30),
    ("void (anonymous namespace)::planar_conv_tc_kernel<3, 1, 8>(Args)",
     "planar-conv", "kernel", 1650, 50),
    ("void (anonymous namespace)::planar_convt2_tc_kernel<2>(Args)",
     "planar-conv", "kernel", 1700, 25),
    ("void (anonymous namespace)::res152_bwd_tc_kernel<true>(Args)",
     "stage", "kernel", 1725, 75),
    ("void (anonymous namespace)::median_net_kernel<float, 7>(Args)",
     "median", "kernel", 1800, 10),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv", "kernel", 1810, 190),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>(Args)",
     "conv", "kernel", 2000, 15),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_stages_64x4_tn", "conv",
     "kernel", 2015, 85),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(Args)",
     "elementwise", "kernel", 2100, 400),
    ("void at::native::unrolled_elementwise_kernel<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(Args)",
     "elementwise", "kernel", 2500, 60),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float> > >(Args)", "reduce", "kernel",
     2560, 90),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
     "unsigned int, 4, 64, 64>(Args)", "copy / set", "kernel", 2650, 35),
    ("Memcpy HtoD (Pageable -> Device)", "copy / set", "gpu_memcpy",
     2700, 12),
    ("Memset (Device)", "copy / set", "gpu_memset", 2712, 3),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<Policy>(Args)",
     "other", "kernel", 2715, 45),
    # the same kernel twice more: the sums run by name
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, std::array<char*, 3ul> >(Args)",
     "elementwise", "kernel", 2800, 100),
    ("void (anonymous namespace)::fused_stem_fwd_kernel<__nv_bfloat16, 8, "
     "true>(Args)", "stem-fwd", "kernel", 3000, 300),
    # overlapping another operation (a second stream)
    ("void (anonymous namespace)::fused_stem_bwd_tc_kernel<8>(Args)",
     "stem-bwd", "kernel", 3200, 200),
    # straddling the window's end: only its inside counts
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, "
     "at::native::func_wrapper_t<float> > >(Args)", "reduce", "kernel",
     4900, 300),
    # outside the window
    ("void (anonymous namespace)::median_net_kernel<float, 7>(Args)",
     "median", "kernel", 6000, 10),
    ("void (anonymous namespace)::fused_stem_fwd_kernel<__nv_bfloat16, 8, "
     "true>(Args)", "stem-fwd", "kernel", 500, 200),
]
WINDOW = (1000, 5000)


def _synthetic_events():
    events = [{"ph": "M", "name": "process_name", "pid": 0,
               "args": {"name": "python"}},
              {"ph": "X", "cat": "user_annotation", "name": "apfp_steps",
               "pid": 0, "tid": 1, "ts": WINDOW[0],
               "dur": WINDOW[1] - WINDOW[0]},
              {"ph": "X", "cat": "cpu_op", "name": "aten::add", "pid": 0,
               "tid": 1, "ts": 1200, "dur": 900},
              {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "pid": 0, "tid": 1, "ts": 1210, "dur": 5}]
    for name, _, cat, ts, dur in SYNTHETIC_OPS:
        events.append({"ph": "X", "cat": cat, "name": name, "pid": 1,
                       "tid": 7, "ts": ts, "dur": dur})
    return events


def _expected_by_category():
    want = collections.Counter()
    for _, label, _, ts, dur in SYNTHETIC_OPS:
        lo, hi = max(ts, WINDOW[0]), min(ts + dur, WINDOW[1])
        if hi > lo:
            want[label] += hi - lo
    return want


@pytest.mark.parametrize("gz", [False, True])
def test_step_profile_parse_only_attributes_a_synthetic_trace(
        tmp_path, monkeypatch, gz):
    """``STEP_PROFILE_TRACE`` names a capture: the tool reads it (plain or
    gzipped) without a card, takes the ``apfp_steps`` window and files
    each device operation under its first matching category (K2's
    ``fused_stem_bwd_tc_kernel`` under stem-bwd, K4's ``planar_conv`` under
    planar-conv and not conv, the direct-copy elementwise kernel under
    elementwise); host events count for nothing."""
    SP = _tool("step_profile")
    path = str(tmp_path / ("t.pt.trace.json" + (".gz" if gz else "")))
    with (gzip.open if gz else open)(path, "wt") as f:
        json.dump({"traceEvents": _synthetic_events()}, f)
    monkeypatch.setenv("STEP_PROFILE_TRACE", path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rec = SP.main(["8", "2"])     # default --device: no card needed
    want = _expected_by_category()
    total = sum(want.values())
    got = rec["ms_per_step_by_category"]
    assert set(got) == set(want)
    for label, us in want.items():
        assert got[label] == pytest.approx(us / 2 / 1e3, abs=1e-12), label
    assert rec["device_ms_per_step"] == pytest.approx(total / 2 / 1e3)
    assert sum(got.values()) == pytest.approx(rec["device_ms_per_step"])
    assert rec["window_ms"] == pytest.approx(4.0)
    for name, label, *_ in SYNTHETIC_OPS:
        assert SP.categorize(name) == label, name
    assert SP.categorize("fused_stem_bwd_tc_kernel") == "stem-bwd"
    out = buf.getvalue()
    assert "batch 8, 2 steps" in out and "top 25 ops" in out
    assert f"trace: {path}" in out


def _inline_phase12_by_kind(ops):
    """The by-kind split ``chip_smoke.py`` phase 12 made inline before it
    called ``tools/step_profile``, as it stood."""
    by_name = {}
    for s, e, name in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    kinds = {"port kernels (csrc)": ("fused_stem", "planar", "res152",
                                     "median"),
             "GEMM / conv (cuBLAS, cuDNN, CUTLASS)": (
                 "gemm", "conv", "cudnn", "xmma", "cutlass", "sm90_",
                 "wgrad", "dgrad", "implicit"),
             "elementwise": ("elementwise",),
             "reduction": ("reduce",),
             "copy / set": ("Memcpy", "Memset", "copy", "Cat")}
    by_kind = {}
    for name, d in by_name.items():
        kind = next((k for k, keys in kinds.items()
                     if any(w in name for w in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + d
    return by_name, by_kind


def test_step_profile_attribution_equals_phase_12s_former_split():
    """The tool's categories, grouped as phase 12 grouped its kinds (the
    port's six kernel categories as one), equal the former inline split
    on the same operations, and so do the sums by name."""
    SP = _tool("step_profile")
    events = _synthetic_events()
    window = SP.steps_window(events)
    assert window == WINDOW
    merged, ops = SP.device_intervals(events, window)
    by_op, by_cat = SP.attribute(ops)
    old_by_name, old_by_kind = _inline_phase12_by_kind(ops)
    assert dict(by_op) == old_by_name
    group = {"stem-fwd": "port kernels (csrc)",
             "stem-bwd": "port kernels (csrc)",
             "layout": "port kernels (csrc)",
             "planar-conv": "port kernels (csrc)",
             "stage": "port kernels (csrc)",
             "median": "port kernels (csrc)",
             "conv": "GEMM / conv (cuBLAS, cuDNN, CUTLASS)",
             "elementwise": "elementwise", "reduce": "reduction",
             "copy / set": "copy / set", "other": "other"}
    grouped = collections.Counter()
    for label, us in by_cat.items():
        grouped[group[label]] += us
    assert dict(grouped) == old_by_kind
    # the merged busy intervals are disjoint, in order, and hold every
    # operation
    assert all(a[1] < b[0] for a, b in zip(merged, merged[1:]))
    assert all(any(lo <= s and e <= hi for lo, hi in merged)
               for s, e, _ in ops)


def test_step_profile_without_a_window_takes_the_device_span():
    """A capture without the ``apfp_steps`` annotation is read over the
    span of its device operations."""
    SP = _tool("step_profile")
    events = [e for e in _synthetic_events() if e["name"] != "apfp_steps"]
    assert SP.steps_window(events) == (500, 6010)
    with pytest.raises(ValueError, match="no device operation"):
        SP.steps_window([e for e in events if e["pid"] == 0])
