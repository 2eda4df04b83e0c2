"""Structure of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse a missing CUDA device instead of
running on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = ("adversarial_patch_based_false_positive_creation_attacks_"
           "against_aerial_imagery_object_detectors_tpu")
PORT = JAX_PKG + "_torch"


def _port_sources():
    for dirpath, _, files in os.walk(os.path.join(ROOT, PORT)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_sources_import_no_jax():
    """An AST scan of every port module and chip_smoke.py finds no import
    of jax or of the JAX package (the port's own name extends the JAX
    package's, so the match is on whole dotted components)."""
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "optax", JAX_PKG), (
                f"{path} imports {mod}")


def test_port_import_loads_no_jax():
    """A fresh interpreter importing the whole port (every submodule)
    ends with neither jax nor the JAX package in sys.modules."""
    code = (
        "import sys, importlib, pkgutil\n"
        f"import {PORT} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in "
        f"('jax', 'jaxlib', '{JAX_PKG}')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """With no visible card, ``device="cuda"`` (the default) raises at
    the Detector, the Darknet module and the serve CLI's build_detector."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = importlib.import_module(f"{PORT}.models")
    evals = importlib.import_module(f"{PORT}.evals")
    common = importlib.import_module(f"{PORT}.cli.common")
    net = models.build_network(models.tiny_test_blocks())
    params = models.init_params(net, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        evals.Detector(net, params, img_size=64)
    with pytest.raises(RuntimeError, match="cuda"):
        models.Darknet(net, params)
    import argparse
    ap = argparse.ArgumentParser()
    common.add_model_args(ap)
    args = ap.parse_args(["--img-size", "64"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        common.build_detector(args)
    # the CPU is taken only when asked for
    det = evals.Detector(net, params, img_size=64, device="cpu")
    assert det.device.type == "cpu" and not det.fused_stem


def test_training_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """With no visible card, the ``PatchTrainer`` (default ``device``) and
    the training CLI (default ``--device cuda``) raise before training."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    models = importlib.import_module(f"{PORT}.models")
    train = importlib.import_module(f"{PORT}.train")
    cli = importlib.import_module(f"{PORT}.cli.train_patch")
    net = models.build_network(models.tiny_test_blocks())
    params = models.init_params(net, 0)
    exp = train.get_experiment("paper_obj", img_size=64, patch_size=16)
    with pytest.raises(RuntimeError, match="cuda"):
        train.PatchTrainer(exp, net, params)
    assert cli.build_parser().parse_args([]).device == "cuda"
    cfg = tmp_path / "tiny.cfg"
    models.write_darknet_cfg(models.tiny_test_blocks(), str(cfg))
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--cfgfile", str(cfg), "--img-size", "64",
                  "--patch-size", "16", "--synthetic", "2",
                  "--out-dir", str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


def test_kernel_wrappers_use_plain_versions_only_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions and
    count no launch."""
    import importlib
    pc = importlib.import_module(f"{PORT}.ops.planar_conv")
    sf = importlib.import_module(f"{PORT}.ops.stem_fused")
    def counts():
        return (pc.to_planar.launches, pc.to_planar.tiled_launches,
                pc.to_planar.phases_launches, pc.from_planar.launches,
                pc.from_planar.narrow_launches, sf.fused_stem_fwd.launches,
                sf.fused_stem_fwd.save_acts_launches,
                sf.fused_stem_bwd_saved.launches)
    before = counts()
    rng = np.random.default_rng(0)
    for c in (3, 40):   # both forms' choice of C, each way
        x = torch.from_numpy(rng.random((1, 8, 8, c), dtype=np.float32))
        xp = pc.to_planar(x)
        assert torch.equal(pc.from_planar(xp, 8, c), x)
    xe, xo = sf.split_phases(x[..., :3].contiguous())
    assert torch.equal(xo, pc.to_planar_plain(x[..., :3], 8, 2, 1))
    assert counts() == before
    meta = torch.empty(1, 8, 8, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pc.to_planar_phases(meta, 8)
    assert counts() == before


def test_layout_launch_helpers_write_only_into_a_matching_block():
    """The layout kernels' launch helpers (``_to_planar_into`` and its
    siblings, which the GPU tests and ``chip_smoke.py`` hand NaN-filled
    blocks) take the caller's block only when it is contiguous and of the
    output's shape, dtype and device, and refuse a CPU tensor without
    counting a launch."""
    import importlib
    pc = importlib.import_module(f"{PORT}.ops.planar_conv")
    bf16 = torch.bfloat16
    like = torch.zeros(1, 2, dtype=bf16)
    out = torch.full((2, 3, 4), float("nan"), dtype=bf16)
    assert pc._out_block(out, (2, 3, 4), like, "k") is out
    new = pc._out_block(None, (2, 3, 4), like, "k")
    assert new is not out and new.shape == (2, 3, 4) and new.dtype == bf16
    for bad in (torch.empty(2, 3, 5, dtype=bf16), torch.empty(2, 3, 4),
                torch.empty(2, 4, 3, dtype=bf16).transpose(1, 2)):
        with pytest.raises(ValueError, match="out must be"):
            pc._out_block(bad, (2, 3, 4), like, "k")
    x = torch.zeros(1, 4, 4, 3)
    counts = (pc.to_planar.launches, pc.to_planar.phases_launches,
              pc.from_planar.narrow_launches)
    for call in (lambda: pc._to_planar_into(x, None, 8),
                 lambda: pc._to_planar_phases_into(x, None, None, 8),
                 lambda: pc._from_planar_into(pc.to_planar_plain(x, 8),
                                              None, 4, 3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (pc.to_planar.launches, pc.to_planar.phases_launches,
            pc.from_planar.narrow_launches) == counts


def test_no_tf32_nests_and_restores_across_threads():
    """TF32 stays off while any user (of any thread) is inside
    ``no_tf32`` and the caller's flag returns when the last one leaves."""
    import importlib
    import threading
    _cuda = importlib.import_module(f"{PORT}.ops._cuda")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        inside, leave = threading.Event(), threading.Event()

        def other():
            with _cuda.no_tf32():
                inside.set()
                leave.wait(timeout=30)

        t = threading.Thread(target=other)
        t.start()
        assert inside.wait(timeout=30)
        with _cuda.no_tf32():
            with _cuda.no_tf32():
                assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cudnn.allow_tf32  # the thread is inside
        leave.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_planar_and_stage_wrappers_plain_on_cpu_raise_elsewhere():
    """K4's and K6's wrappers (``planar_conv``, ``res152_fused``,
    ``res152_fused_grad``) run their plain versions on CPU tensors and
    count no launch; a tensor on any other device that is not a card
    raises instead of falling back. Their modules and the route modules
    are among the sources the no-JAX scans read."""
    import importlib
    pc = importlib.import_module(f"{PORT}.ops.planar_conv")
    rf = importlib.import_module(f"{PORT}.ops.res_fused")
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("ops/planar_conv.py", "ops/res_fused.py",
                "models/stem_planar.py", "models/res_planar.py"):
        assert os.path.join(PORT, mod) in names

    def counts():
        return (pc.planar_conv.launches_k1, pc.planar_conv.launches_k3,
                pc.planar_conv.launches_k3s2, rf.res152_fused.launches,
                rf.res152_fused.save_launches,
                rf.res152_fused_grad.launches)
    before = counts()
    g = torch.Generator().manual_seed(0)
    xp = pc.to_planar(torch.rand(1, 8, 8, 128, generator=g))
    for k, s in ((1, 1), (3, 1), (3, 2)):
        y = pc.planar_conv(xp, torch.rand(k, k, 128, 8, generator=g),
                           torch.zeros(8), k=k, stride=s)
        assert y.shape == (1, 8 // s, 8, 128)
    fwd, bwd = rf.res_weights(
        [(torch.rand(k, k, ci, co, generator=g) * 0.1, torch.zeros(co))
         for k, ci, co in ((1, 128, 64), (3, 64, 128)) * 2])
    y11, *masks = rf.res152_fused(xp, fwd, save=True)
    assert tuple(rf.res152_fused_grad(y11, masks, bwd).shape) == tuple(
        xp.shape)
    assert counts() == before
    meta = torch.empty(xp.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pc.planar_conv(meta, torch.empty(3, 3, 128, 8, device="meta"),
                       torch.empty(8, device="meta"), k=3)
    with pytest.raises(ValueError, match="CUDA"):
        rf.res152_fused(meta, fwd)
    with pytest.raises(ValueError, match="CUDA"):
        rf.res152_fused_grad(meta, masks, bwd)
    assert counts() == before


def test_remat_and_c12_wrappers_plain_on_cpu_raise_elsewhere():
    """K5's and K6c's wrappers (``fused_stem_bwd``,
    ``res152_fused_grad12``) run their plain versions on CPU tensors and
    count no launch; a tensor on a device that is not a card raises
    instead of falling back. Their sources are among those the no-JAX
    scans read."""
    import importlib
    pc = importlib.import_module(f"{PORT}.ops.planar_conv")
    sf = importlib.import_module(f"{PORT}.ops.stem_fused")
    rf = importlib.import_module(f"{PORT}.ops.res_fused")
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert os.path.join(PORT, "ops/stem_fused.py") in names

    def counts():
        return (sf.fused_stem_bwd.launches, rf.res152_fused_grad12.launches)
    before = counts()
    g = torch.Generator().manual_seed(0)
    sp = [(torch.rand(k, k, ci, co, generator=g) * 0.1, torch.zeros(co))
          for ci, co, k in zip(sf.STEM_IN, sf.STEM_FILTERS, sf.STEM_KSIZE)]
    sbp = sf.stem_bwd_params(sp)
    xe, xo = sf.split_phases(torch.rand(1, 32, 32, 3, generator=g))
    y5p = sf.fused_stem_fwd(xe, xo, sp)
    gxe, gxo = sf.fused_stem_bwd(xe, xo, y5p, y5p, sp, sbp)
    assert gxe.shape == gxo.shape == xe.shape
    fwd, bwd = rf.res_weights(
        [(torch.rand(k, k, ci, co, generator=g) * 0.1, torch.zeros(co))
         for k, ci, co in ((1, 128, 64), (3, 64, 128)) * 2])
    w12t = rf.res12_weights(torch.rand(3, 3, 128, 256, generator=g) * 0.1)
    xp = pc.to_planar(torch.rand(1, 8, 8, 128, generator=g))
    _, *masks = rf.res152_fused(xp, fwd, save=True)
    gp12 = pc.to_planar(torch.rand(1, 4, 4, 256, generator=g))
    assert rf.res152_fused_grad12(gp12, masks, bwd, w12t).shape == xp.shape
    assert counts() == before
    meta = [torch.empty(t.shape, device="meta") for t in (xe, xo, y5p, gp12)]
    with pytest.raises(ValueError, match="CUDA"):
        sf.fused_stem_bwd(meta[0], meta[1], meta[2], meta[2], sp, sbp)
    with pytest.raises(ValueError, match="CUDA"):
        rf.res152_fused_grad12(meta[3], masks, bwd, w12t)
    assert counts() == before


def test_experimental_wrappers_plain_on_cpu_raise_elsewhere():
    """The experimental package's kernel wrappers (K7
    ``median_pool_2d_pallas``, K8a ``fused_stem_fwd_b`` with and without
    ``save_acts``, K8b ``fused_stem_bwd_b``) run their plain versions on
    CPU tensors and count no launch; a tensor on a device that is not a
    card raises instead of falling back. Their modules are among the
    sources the no-JAX scans read."""
    import importlib
    mp = importlib.import_module(f"{PORT}.experimental.median_pallas")
    sb = importlib.import_module(f"{PORT}.experimental.stem_batched")
    sf = importlib.import_module(f"{PORT}.ops.stem_fused")
    names = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod in ("__init__", "median_pallas", "stem_batched", "packed_stem"):
        assert os.path.join(PORT, "experimental", f"{mod}.py") in names

    def counts():
        return (mp.median_pool_2d_pallas.launches,
                sb.fused_stem_fwd_b.launches,
                sb.fused_stem_fwd_b.save_acts_launches,
                sb.fused_stem_bwd_b.launches)
    before = counts()
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 9, 11, generator=g)
    assert torch.equal(mp.median_pool_2d_pallas(x, 3),
                       mp.median_pool_2d_pallas_plain(x, 3))
    sp = [(torch.rand(k, k, ci, co, generator=g) * 0.1, torch.zeros(co))
          for ci, co, k in zip(sf.STEM_IN, sf.STEM_FILTERS, sf.STEM_KSIZE)]
    sbp = sf.stem_bwd_params(sp)
    xe, xo = sb.split_phases_b(torch.rand(2, 32, 32, 3, generator=g), 128)
    y5 = sb.fused_stem_fwd_b(xe, xo, sp, 2)
    acts = sb.fused_stem_fwd_b(xe, xo, sp, 2, save_acts=True)
    assert torch.equal(y5, acts[0])
    gp5dd = torch.rand(16, 128, 256, generator=g)
    gxe, gxo = sb.fused_stem_bwd_b(gp5dd, acts, sbp, 2)
    assert gxe.shape == gxo.shape == xe.shape
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        mp.median_pool_2d_pallas(torch.empty(x.shape, device="meta"), 3)
    meta = [torch.empty(t.shape, device="meta") for t in (xe, *acts)]
    with pytest.raises(ValueError, match="CUDA"):
        sb.fused_stem_fwd_b(meta[0], meta[0], sp, 2)
    with pytest.raises(ValueError, match="CUDA"):
        sb.fused_stem_fwd_b(meta[0], meta[0], sp, 2, save_acts=True)
    with pytest.raises(ValueError, match="CUDA"):
        sb.fused_stem_bwd_b(torch.empty(gp5dd.shape, device="meta"),
                            meta[1:], sbp, 2)
    assert counts() == before


@pytest.mark.parametrize("k", range(1, 10))
def test_median_wrapper_plain_on_cpu_raises_on_meta_at_every_k(k):
    """K7's wrapper runs its plain version on a CPU tensor and counts no
    launch of either form, and raises on a ``meta`` tensor, at every k of
    the network form (1-8) and at 9 (the rank-counting form). The module
    of the new ``ops/median_pool.py`` names is among the sources the
    no-JAX scan reads, and imports no JAX."""
    import importlib
    import inspect
    mp = importlib.import_module(f"{PORT}.experimental.median_pallas")
    ops_mp = importlib.import_module(f"{PORT}.ops.median_pool")
    path = inspect.getsourcefile(ops_mp.median_net_table)
    assert path in set(_port_sources())
    for name in ("median_select", "median_pool_nhwc", "median_net_table",
                 "median_net_minmax", "median_net_header", "_batcher_pairs"):
        assert inspect.getsourcefile(getattr(ops_mp, name)) == path
    assert not [m for m in _imported_modules(path)
                if m.split(".")[0] in ("jax", "jaxlib", JAX_PKG)]
    assert mp.kernel_form(k) == ("network" if k <= 8 else "rank")
    fn = mp.median_pool_2d_pallas
    before = (fn.launches, fn.network_launches)
    x = torch.rand(2, 11, 12, generator=torch.Generator().manual_seed(k))
    assert torch.equal(fn(x, k), mp.median_pool_2d_pallas_plain(x, k))
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.empty(x.shape, device="meta"), k)
    assert (fn.launches, fn.network_launches) == before


def test_port_import_leaves_experimental_unloaded():
    """As in the JAX package, nothing on a default path imports the
    experimental package: not ``import <port>``, not a ``Darknet`` built
    from BN-folded params and run on its default routes; asking for the
    packed stem loads it."""
    code = (
        "import sys, torch\n"
        f"import {PORT} as p\n"
        "exp = p.__name__ + '.experimental'\n"
        "assert exp not in sys.modules\n"
        "M = p.models\n"
        "net = M.build_network(M.tiny_test_blocks())\n"
        "params = M.fold_bn(net, M.init_params(net, 0))\n"
        "model = M.Darknet(net, params, device='cpu')\n"
        "with torch.no_grad():\n"
        "    model(torch.zeros(1, 64, 64, 3))\n"
        "assert exp not in sys.modules\n"
        "with torch.no_grad():\n"
        "    model(torch.zeros(1, 64, 64, 3), packed_stem=True)\n"
        "assert exp in sys.modules and M.last_routes()['stem'] == 'packed'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_bf16_stem_kernels_run_on_tensor_cores():
    """The bfloat16 K1, K2, K5 and K8b run their convs on ``wgmma`` through
    stem_common.cuh's ``wg::conv`` (K1's five convs; K2's chain,
    ``wgc::chain``, which K2, K5 and K8b share: its adjoints two parity
    groups of four and three single GEMMs; K5's four recompute convs),
    their weights streamed by ``cp.async.bulk`` and their boxes by tensor
    maps; the ``mma.sync`` chain (``bwd_tc::chain``) and its staging
    helpers are gone; the bfloat16 K6a and K6b / K6c run their convs on
    ``wg::conv`` too (their tiles by tensor maps), and so does the
    bfloat16 K8a (K1's five convs); ``mma_conv`` is gone and ``mma.sync``
    is left only in the k16 step's bit check (``wgmma_bitcheck_kernel``),
    the bfloat16 K4 runs ``wgmma``, the float32 paths keep the CUDA-core
    helpers, and no kernel source includes a library's kernels (cuDNN,
    cuBLAS, CUTLASS's device-level GEMMs)."""
    import re
    csrc = os.path.join(ROOT, PORT, "csrc")
    src = {f: open(os.path.join(csrc, f)).read() for f in os.listdir(csrc)
           if f.endswith((".cu", ".cuh"))}
    common = src["stem_common.cuh"]
    assert re.search(r"mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16"
                     r"\.bf16\.f32", common)
    assert "ldmatrix.sync.aligned" in common
    assert not any("mma_conv" in text for text in src.values())
    for n in (8, 32, 64):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16" \
            in common
    assert "cp.async.bulk.shared::cluster.global.mbarrier" in common
    assert "cp.async.bulk.tensor.4d" in common
    fwd, bwd = src["stem_fused.cu"], src["stem_bwd.cu"]

    def body(text, kern):
        b = text[text.index(kern):]
        return b[:b.index("\n}\n")]
    # mma.sync: the k16 step's bit check alone calls it
    assert sorted(f for f, text in src.items() if "mma_bf16(" in text) == [
        "stem_common.cuh", "stem_fused.cu"]
    assert fwd.count("mma_bf16(") == 1
    assert "mma_bf16(" in body(fwd, "wgmma_bitcheck_kernel(")
    # K1: the bfloat16 kernel takes wg::conv for its five convs and no
    # mma_conv; float32 conv_stage
    k1 = body(fwd, "fused_stem_fwd_wg_kernel(")
    assert len(re.findall(r"\bwg::conv<", k1)) == 5
    assert len(re.findall(r"\bwg::produce<", k1)) == 5
    assert "mma_conv<" not in fwd
    assert len(re.findall(r"\bconv_stage<", fwd)) == 5
    # the chain K2, K5 and K8b share: eleven GEMMs on wg::conv (two
    # parity groups of four, three single), their producer side eleven
    # wg::produce
    wgc = common[common.index("namespace wgc {"):]
    assert len(re.findall(r"\bwg::conv<", body(wgc, " void chain("))) == 11
    assert len(re.findall(r"\bwg::produce<",
                          body(wgc, " void produce("))) == 11
    for gone in ("bwd_tc::chain", "convt_s2<128", "stage_signs",
                 "StagedMask", "load_gp5", "_tc_kernel(const bf16* "
                 "__restrict__ gp5dd", "fused_stem_remat_tc_kernel"):
        assert not any(gone in text for text in src.values()), gone
    # K2: the shared chain, its loads by tensor maps; float32 the FMA
    # grad_chain
    k2 = body(bwd, "fused_stem_bwd_wg_kernel(")
    assert "wgc::chain(" in k2 and "wgc::produce(" in k2
    assert len(re.findall(r"\bwg::tma_load_4d\(", k2)) == 7
    assert "mma_conv<" not in bwd
    assert "grad_chain<T>" in bwd and "launch_wg" in bwd
    # K5: K1's four recompute convs on wg::conv (conv0 and conv1 once a y0
    # chunk), y5's and g5's boxes by tensor maps, then the shared chain;
    # float32 conv_stage + grad_chain
    remat = src["stem_remat.cu"]
    k5 = body(remat, "fused_stem_remat_wg_kernel(")
    chunk = body(remat, " void y0_chunk(")
    assert len(re.findall(r"\bwg::conv<", chunk)) == 2
    assert len(re.findall(r"\bwg::conv<", k5)) == 2
    assert len(re.findall(r"\by0_chunk<", k5)) == 2
    assert len(re.findall(r"\bwg::produce<", k5)) == 4
    assert len(re.findall(r"\bwg::tma_load_4d\(", k5)) == 2
    assert "wgc::chain(" in k5 and "wgc::produce(" in k5
    assert "mma_conv<" not in remat and "grad_chain<T>" in remat
    # K6a, K6b / K6c: the bfloat16 kernels on wg::conv (K6a four convs,
    # K6b five GEMMs, K6c four parity GEMMs more), their tiles by tensor
    # maps; float32 keeps conv_tile
    k6 = src["res_fused.cu"]
    k6f = body(k6, "res152_fwd_wg_kernel(")
    k6b = body(k6, "res152_bwd_wg_kernel(")
    assert len(re.findall(r"\bwg::conv<", k6f)) == 4
    assert len(re.findall(r"\bwg::conv<", k6b)) == 9
    assert "produce_boxes<" in k6f and "produce_boxes<" in k6b
    assert "wg::tma_load_4d(" in k6 and len(re.findall(r"\bconv_tile<",
                                                        k6)) == 8
    # K8a: the bfloat16 kernel on K1's five convs (wg::conv, their packed
    # weights streamed by wg::produce); K8b: the shared chain, its gp5dd and
    # activations' boxes by tensor maps; float32 keeps conv_stage and
    # chain_tail
    k8 = src["stem_batched.cu"]
    k8a = body(k8, "fused_stem_fwd_b_wg_kernel(")
    assert len(re.findall(r"\bwg::conv<", k8a)) == 5
    assert len(re.findall(r"\bwg::produce<", k8a)) == 5
    assert "fused_stem_fwd_b_tc_kernel" not in k8
    k8b = body(k8, "fused_stem_bwd_b_wg_kernel(")
    assert "wgc::chain(" in k8b and "wgc::produce(" in k8b
    assert len(re.findall(r"\bwg::tma_load_4d\(", k8b)) == 6
    assert len(re.findall(r"\bconv_stage<",
                          body(k8, "fused_stem_fwd_b_kernel("))) == 5
    assert "chain_tail<T>(" in body(k8, "fused_stem_bwd_b_kernel(")
    # K4: the bfloat16 kernel on wgmma (its input by TMA, its weights by
    # bulk copies, no mma.sync left), float32 on FMAs
    k4 = src["planar_conv.cu"]
    wgk = k4[k4.index("planar_conv_wg_kernel("):]
    wgk = wgk[:wgk.index("\n}\n")]
    assert "chunk_mma<" in wgk and "tma_load_4d(" in wgk
    assert "bulk_load(" in wgk and "transpose<" in wgk
    assert "wg::mma_async<N>(" in k4 and "fmaf(" in k4
    assert "mma_bf16(" not in k4 and "tap_mma" not in k4
    for name, text in src.items():
        for inc in re.findall(r'#include\s*[<"]([^>"]+)[>"]', text):
            low = inc.lower()
            assert not any(lib in low for lib in ("cudnn", "cublas", "cutlass",
                                                  "cute/")), (name, inc)


def _launch_calls(tree):
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "launch"
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "_cuda"):
            yield node


def test_kernel_wrappers_launch_under_their_tensors_device():
    """An AST scan of the port: no module but ``ops/_cuda.py`` calls a
    kernel library (``lib(...)``), and there only ``launch`` does, which
    enters the device of the tensor it is given; every kernel entry point
    of ``_cuda.SIGNATURES`` (the ``_info`` queries apart) is launched
    through ``_cuda.launch`` with a tensor argument, so each wrapper runs
    its kernel in the context of its tensors' card."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    entries = {e for lib in _cuda.SIGNATURES.values() for e in lib
               if not e.endswith("_info")}
    launched = set()
    for path in _port_sources():
        if path.endswith("chip_smoke.py"):
            continue
        tree = ast.parse(open(path).read(), path)
        owners = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    owners.setdefault(node, fn.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                f = node.func
                name = f.attr if isinstance(f, ast.Attribute) else getattr(
                    f, "id", None)
                if name == "lib":
                    assert path.endswith(os.path.join("ops", "_cuda.py")) \
                        and owners.get(node) == "launch", (path, node.lineno)
        for call in _launch_calls(tree):
            assert len(call.args) >= 4, (path, call.lineno)
            assert isinstance(call.args[3], ast.Name), (path, call.lineno)
            for c in ast.walk(call.args[2]):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    launched.add(c.value)
    assert launched == entries, (sorted(entries - launched),
                                 sorted(launched - entries))


def test_launch_enters_the_tensors_device(monkeypatch):
    """``_cuda.launch`` calls the entry point with the tensor's device as
    the current CUDA device and that device's stream last, restores the
    caller's device after, and raises naming the wrapper when the entry
    point returns an error (``torch.cuda.device``, the stream and the
    library replaced by recorders, so this runs without a card)."""
    import contextlib
    import types
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    current = [None]
    calls = []

    @contextlib.contextmanager
    def device(d):
        prev, current[0] = current[0], d
        try:
            yield
        finally:
            current[0] = prev

    class Lib:
        def __init__(self, err):
            self.err = err

        def apfp_k(self, *args):
            calls.append((current[0], args))
            return self.err

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: ("stream", t.device))
    t = types.SimpleNamespace(device=torch.device("cuda", 1))
    monkeypatch.setattr(_cuda, "lib", lambda name: Lib(0))
    _cuda.launch("k", "planar", "apfp_k", t, 3, None)
    assert calls == [(t.device, (3, None, ("stream", t.device)))]
    assert current[0] is None
    monkeypatch.setattr(_cuda, "lib", lambda name: Lib(7))
    with pytest.raises(RuntimeError, match="k: CUDA launch failed"):
        _cuda.launch("k", "planar", "apfp_k", t)
    assert calls[-1][0] == t.device and current[0] is None


def test_build_keeps_the_ptxas_log_for_cached_libraries(tmp_path,
                                                        monkeypatch):
    """A fresh build keeps each library's compiler log beside it, and a
    later ``build_all`` that finds the library already built reports that
    log (the registers and spill lines ``chip_smoke.py`` phase 1 reads)
    instead of a placeholder. ``nvcc`` is replaced by a script that writes
    the library and prints one ptxas line, so this runs without a card."""
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import _cuda
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo lib > "$2"\n'
                    'echo "ptxas info    : Used 42 registers"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "BUILD_INFO", {})
    fresh = _cuda.build_all()
    assert set(fresh) == set(_cuda.SIGNATURES)
    assert all("Used 42 registers" in v["log"] for v in fresh.values())
    monkeypatch.setattr(_cuda, "BUILD_INFO", {})
    cached = _cuda.build_all()
    assert [v["path"] for v in cached.values()] == [
        v["path"] for v in fresh.values()]
    assert all(v["seconds"] == 0.0 and "Used 42 registers" in v["log"]
               for v in cached.values())


def _defined_names(path):
    """Top-level ``def``s and ``class``es of a module, and its classes'
    methods as ``Class.method``, each with its argument names."""
    tree = ast.parse(open(path).read(), path)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ([a.arg for a in node.args.args]
                              if isinstance(node, ast.FunctionDef) else [])
        if isinstance(node, ast.ClassDef):
            for fn in node.body:
                if isinstance(fn, ast.FunctionDef):
                    out[f"{node.name}.{fn.name}"] = [a.arg
                                                     for a in fn.args.args]
    return out


# the training path's names that the port had left out, by module
TRAINING_PATH_NAMES = {
    "data/dataset.py": ("DeviceStore",),
    "train/trainer.py": ("make_epoch_scan_fn", "PatchTrainer.run_epoch_store",
                         "PatchTrainer.train_store"),
    "parallel/mesh.py": ("init_distributed", "make_mesh",
                         "make_mesh_for_batch", "batch_sharding",
                         "replicated", "shard_batch"),
    "utils/profiling.py": ("StepTimer", "trace", "annotate"),
}


def test_name_diff_finds_the_training_path_in_the_port():
    """A name diff of the two packages' modules (top-level ``def``s,
    ``class``es and methods, by AST) finds each training-path name of the
    JAX package in the port's module of the same path, and ``mesh`` among
    the arguments of ``make_loss_fn``, ``make_train_step``,
    ``make_epoch_scan_fn`` and ``PatchTrainer``, as in the JAX package;
    the new modules are among the sources the no-JAX scans read and
    import no JAX."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for mod, names in TRAINING_PATH_NAMES.items():
        jax_names = _defined_names(os.path.join(ROOT, JAX_PKG, mod))
        port_path = os.path.join(ROOT, PORT, mod)
        port_names = _defined_names(port_path)
        assert os.path.join(PORT, mod) in scanned, mod
        assert not [m for m in _imported_modules(port_path)
                    if m.split(".")[0] in ("jax", "jaxlib", JAX_PKG)], mod
        for name in names:
            assert name in jax_names, (mod, name)
            assert name in port_names, (mod, name)
    trainer = "train/trainer.py"
    for pkg in (JAX_PKG, PORT):
        names = _defined_names(os.path.join(ROOT, pkg, trainer))
        for fn in ("make_loss_fn", "make_train_step", "make_epoch_scan_fn",
                   "PatchTrainer.__init__"):
            assert "mesh" in names[fn], (pkg, fn)


# slices C and D: the evaluation half and the two remaining attacks, by
# module (the JAX package's path; ``cli/`` is the repository's)
EVAL_PATH_NAMES = {
    "utils/native.py": ("get_lib", "available", "iou_xywh_matrix",
                        "greedy_nms", "interference_map", "parse_floats"),
    "ops/nms.py": ("greedy_nms_host", "merge_nms_host"),
    "evals/metrics.py": ("instance_count", "conf_sum", "instances_per_class",
                         "m1_average_instances_created",
                         "m2_average_confidence_created", "m4_per_class_gap",
                         "precision_recall", "ap_from_pr",
                         "average_precision", "mean_average_precision",
                         "creation_metrics_report", "_m2_04_quirk"),
    "evals/plotting.py": ("class_color", "draw_detections"),
    "models/darknet.py": ("head_strides", "describe_network"),
    "attack/eot_eval.py": ("EvalEOTConfig", "select_reference_box_7col",
                           "interference_map", "mask_semi_edge",
                           "transform_patch_eval"),
    "attack/vanishing.py": ("VanishingConfig", "transform_patch_vanishing",
                            "paste_vanishing"),
    "attack/pgd.py": ("PGDConfig", "fabrication_loss",
                      "make_pgd_fabrication"),
}
EVAL_CLIS = ("clean_img_pre", "images_filter", "test_patch",
             "test_patch_metrics", "paste_patch", "dataset_tools")

# what the name diff leaves unmatched on purpose: the Pallas kernels'
# internals, the TPU layout switches, the JAX state types, the windowed-
# gather VJP (the port warps through grid_sample), and the JAX compilation
# cache (``utils/cache.py``: the port compiles only its kernels, keyed by
# their sources' hash)
DELIBERATE_DEVIATIONS = {
    "ops/affine.py": {"_bilinear_block_sample", "_block_gather", "_hat",
                      "affine_sample_bwd_window", "affine_sample_fast"},
    "ops/median_pool.py": {"_median_net"},
    "ops/planar_conv.py": {"_auto_r_out", "_k1_kernel", "_k3_kernel",
                           "_leaky", "_row_chunk", "_shift_mat",
                           "from_planar_auto", "from_planar_mxu",
                           "planar_conv_reference", "to_planar_auto",
                           "to_planar_mxu", "use_mxu_layout"},
    "ops/res_fused.py": {"_bias_pair", "_blocked", "_bwd12_kernel",
                         "_bwd_kernel", "_common", "_conv1x1_pairs",
                         "_conv3x3_pairs", "_flip_t", "_fwd_kernel",
                         "_gate_i8", "_sgn_rows", "_stage_chain",
                         "_store_body", "_store_body4", "_w12dx_pair",
                         "_w1x1_pair", "_w3x3_pair", "_zero_edges"},
    "ops/stem_fused.py": {
        "_blkw", "_bwd_kernel", "_bwd_kernel_sv", "_bwd_weights",
        "_compute_y0_phases", "_compute_y123", "_flip_t", "_fs_bwd",
        "_fs_fwd", "_fsp_bwd", "_fsp_fwd", "_fsr_bwd", "_fsr_fwd",
        "_fwd_kernel", "_fwd_weights", "_g5_to_planar", "_grad_chain",
        "_halo_copy", "_halo_copy_multi", "_in_range", "_leaky_f32",
        "_mask_of", "_onehot_sel", "_pad_cin", "_pad_cout", "_pairs",
        "_phase_block", "_pick_s5", "_sh_rows_grad", "_shift_block",
        "_store_out_row", "_store_row", "_w0_pair", "_w0t_pair", "_w1_pair",
        "_w1dx_pair", "_w3_pair", "_w3t_pair", "_w5dx_pair", "_y5_to_nhwc"},
    "experimental/median_pallas.py": {"_median_kernel"},
    "experimental/stem_batched.py": {
        "_bwd_kernel_b", "_bwd_weights_b", "_compute_y0_b",
        "_compute_y123_b", "_dot_b", "_fsb_bwd", "_fsb_fwd",
        "_fwd_kernel_b", "_fwd_weights_b", "_halo_copy_b", "_in_range",
        "_pairs", "_phase_block_b", "_pick_s5", "_shiftrow", "_store_rowb",
        "_w5_pair", "_w5t_pair"},
    "train/optim.py": {"AmsgradState", "scale_by_torch_amsgrad"},
    "train/trainer.py": {"TrainState", "init_train_state"},
    "models/darknet.py": {"_conv_layer"},
    "models/res_planar.py": {"_c12_bwd", "_c12_fwd", "_flip_t", "_fused_bwd",
                             "_fused_fwd", "_mask", "_res_bwd", "_res_fwd",
                             "_stage_params"},
    "models/stem_planar.py": {"_flip_t", "_leaky_bwd_planar", "_pad_cout",
                              "_stem_fwd"},
    "utils/checkpoint.py": {"restore_checkpoint"},
}
MODULES_NOT_PORTED = {"utils/cache.py"}


def _jax_modules():
    top = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(top):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(dirpath, f), top)


def test_name_diff_finds_the_eval_path_in_the_port():
    """Each name of slices C and D of the JAX package is in the port's
    module of the same path, and each of the repository's six eval CLIs
    has a port module of its name with the same top-level names; every
    one of these modules is among the no-JAX scans' sources and imports
    no JAX."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    mods = [(os.path.join(JAX_PKG, m), m, names)
            for m, names in EVAL_PATH_NAMES.items()]
    mods += [(os.path.join("cli", f"{c}.py"), f"cli/{c}.py", None)
             for c in EVAL_CLIS]
    for ref, mod, names in mods:
        ref_names = _defined_names(os.path.join(ROOT, ref))
        port_path = os.path.join(ROOT, PORT, mod)
        port_names = _defined_names(port_path)
        assert os.path.join(PORT, mod) in scanned, mod
        assert not [m for m in _imported_modules(port_path)
                    if m.split(".")[0] in ("jax", "jaxlib", JAX_PKG)], mod
        for name in names or ref_names:
            assert name in ref_names, (mod, name)
            assert name in port_names, (mod, name)


def test_name_diff_leaves_only_the_deliberate_deviations():
    """Over every module of the JAX package, the names the port's module
    of the same path lacks are exactly the deliberate deviations, and the
    only module without a counterpart is the JAX compilation cache."""
    missing_modules, unmatched = set(), {}
    for mod in _jax_modules():
        port_path = os.path.join(ROOT, PORT, mod)
        if not os.path.exists(port_path):
            missing_modules.add(mod)
            continue
        left = (set(_defined_names(os.path.join(ROOT, JAX_PKG, mod)))
                - set(_defined_names(port_path)))
        if left:
            unmatched[mod] = left
    assert missing_modules == MODULES_NOT_PORTED
    assert unmatched == DELIBERATE_DEVIATIONS


# the repository's attack-of-record tools, each ported as
# ``<port>/tools/<name>.py`` with its public names and ``main``
PROTOCOL_TOOLS = ("attack_quality", "protocol_prep", "protocol_run",
                  "convergence_compare", "soak", "plot_history")
# the port's own helpers, by module: names no repository tool of the same
# name defines (``tools/scenes.py`` copies the scene generator, checked
# against its sources below)
PORT_TOOL_HELPERS = {
    "attack_quality": {"_release"},
    "protocol_prep": {"prepare"},
    "protocol_run": {"schedule_summary"},
    "convergence_compare": set(),
    "soak": set(),
    "plot_history": set(),
}
SCENE_SOURCES = {"_palette": "make_refparity_fixture",
                 "make_scene": "make_refparity_fixture",
                 "_gen_scenes": "attack_quality"}


# the repository's serving and training measurement tools and warp
# quality A/Bs, each ported as ``<port>/tools/<name>.py`` with its public
# names and ``main``; the names only the port defines, by tool
# (``tools/victims.py`` copies the crafted victim of the tests)
MEASUREMENT_TOOL_HELPERS = {
    "serving_throughput": {"build_detector", "device_count"},
    "detector_throughput": {"_timed"},
    "serve_soak": {"clients_at"},
    "perf_breakdown": set(),
    "step_profile": {"device_intervals", "attribute", "steps_window",
                     "read_trace", "capture", "step_inputs"},
    "warp_ab": {"scenes", "train_with", "paste_draws", "paste",
                "creation_row", "setup", "format_row", "parse"},
    "warp_dtype_ab": set(),
}
MEASUREMENT_TOOLS = tuple(MEASUREMENT_TOOL_HELPERS)

# the repository's TPU-route A/B micro tools, each ported as
# ``<port>/tools/<name>.py`` with its public names and ``main``; the names
# only the port defines, by tool
MICRO_TOOL_HELPERS = {
    "stem_ab": {"stem_inputs", "input_grad", "chain"},
    "stem_fused_ab": set(),
    "c12_ab": {"grad_digest", "step_time"},
    "c12_micro": {"c12_dx"},
    "conv_micro": {"library_weight", "conv_dx"},
    "s2dx_poly_ab": {"_interleave"},
}
MICRO_TOOLS = tuple(MICRO_TOOL_HELPERS)


# the repository's root entry points, each ported as
# ``<port>/tools/<name>.py``: its top-level names, the port's counterpart
# of each name it renames (the CPU re-exec becomes the gloo / NCCL launch
# of either platform), and the names only the port defines. One
# deviation: ``dryrun_multichip``'s ``device`` defaults to "cuda" and
# raises without n cards (``_probe_device_count`` counts them), where
# ``__graft_entry__.py`` moves to the CPU by itself
ROOT_ENTRY_POINTS = {
    "bench": ("bench.py", {}, {"bench_record", "_card_line", "_ranks"}),
    "entry": ("__graft_entry__.py", {"_reexec_cpu_dryrun": "_launch"}, {
        "_line", "_rank_views", "_rank_main", "main"}),
}


def _port_tool_sources():
    top = os.path.join(ROOT, PORT, "tools")
    return sorted(os.path.join(top, f) for f in os.listdir(top)
                  if f.endswith(".py"))


def test_name_diff_finds_the_protocol_tools_in_the_port():
    """Each of the six repository tools has a port module of its name
    with the tool's public top-level names and ``main(argv)``; the names
    only the port defines are its listed helpers; ``tools/scenes.py``
    holds the scene generator's names; every module is among the no-JAX
    scans' sources."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in PROTOCOL_TOOLS:
        ref = _defined_names(os.path.join(ROOT, "tools", f"{name}.py"))
        path = os.path.join(PORT, "tools", f"{name}.py")
        assert path in scanned, path
        ours = _defined_names(os.path.join(ROOT, path))
        public = {n for n in ref if not n.startswith("_")}
        assert "main" in public and public <= set(ours), (name, public)
        assert ours["main"] == ["argv"], name
        assert set(ours) - set(ref) == PORT_TOOL_HELPERS[name], name
    scenes = _defined_names(os.path.join(ROOT, PORT, "tools", "scenes.py"))
    assert set(scenes) == set(SCENE_SOURCES)
    for fn, src in SCENE_SOURCES.items():
        assert fn in _defined_names(os.path.join(ROOT, "tools",
                                                 f"{src}.py")), fn
    assert os.path.join(PORT, "tools", "scenes.py") in scanned


def test_name_diff_finds_the_measurement_tools_in_the_port():
    """Each of the seven repository measurement and warp A/B tools has a
    port module of its name with the tool's public top-level names and
    ``main(argv)``; the names only the port defines are its listed
    helpers; ``tools/victims.py`` holds the crafted victim, the one name
    of the tests that the repository's A/B tools import; every module is
    among the no-JAX scans' sources."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in MEASUREMENT_TOOLS:
        ref = _defined_names(os.path.join(ROOT, "tools", f"{name}.py"))
        path = os.path.join(PORT, "tools", f"{name}.py")
        assert path in scanned, path
        ours = _defined_names(os.path.join(ROOT, path))
        public = {n for n in ref if not n.startswith("_")}
        assert public <= set(ours), (name, public)
        assert ours["main"] == ["argv"], name
        assert set(ours) - set(ref) - {"main"} == \
            MEASUREMENT_TOOL_HELPERS[name], name
    victims = _defined_names(os.path.join(ROOT, PORT, "tools", "victims.py"))
    assert set(victims) == {"craft_brightness_victim"}
    assert "craft_brightness_victim" in _defined_names(
        os.path.join(ROOT, "tests", "test_attack_closed_loop.py"))
    assert os.path.join(PORT, "tools", "victims.py") in scanned


def test_name_diff_finds_the_micro_tools_in_the_port():
    """Each of the six repository A/B micro tools has a port module of its
    name with the tool's public top-level names and ``main(argv)`` (the
    repository's ``stem_ab``, ``stem_fused_ab`` and ``c12_ab`` run at
    import: their module-level code is the port's ``main``); the names
    only the port defines are its listed helpers; every module is among
    the no-JAX scans' sources."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in MICRO_TOOLS:
        ref = _defined_names(os.path.join(ROOT, "tools", f"{name}.py"))
        path = os.path.join(PORT, "tools", f"{name}.py")
        assert path in scanned, path
        ours = _defined_names(os.path.join(ROOT, path))
        public = {n for n in ref if not n.startswith("_")}
        assert public <= set(ours), (name, public - set(ours))
        assert ours["main"] == ["argv"], name
        assert set(ours) - set(ref) - {"main"} == \
            MICRO_TOOL_HELPERS[name], name


def test_name_diff_finds_the_root_entry_points_in_the_port():
    """Every top-level def of ``bench.py`` and ``__graft_entry__.py`` has
    its counterpart of the same name (and arguments, for ``entry`` and
    ``_probe_device_count``) in the port's module, or is a pinned
    rename; the names only the port defines are its listed helpers; both
    modules are among the no-JAX scans' sources."""
    scanned = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name, (script, renamed, helpers) in ROOT_ENTRY_POINTS.items():
        ref = _defined_names(os.path.join(ROOT, script))
        path = os.path.join(PORT, "tools", f"{name}.py")
        assert path in scanned, path
        ours = _defined_names(os.path.join(ROOT, path))
        want = {renamed.get(n, n) for n in ref}
        assert want <= set(ours), (name, want - set(ours))
        assert set(ours) - want == helpers, (name, set(ours) - want)
        assert ours["main"] == ["argv"], name
    ours = _defined_names(os.path.join(ROOT, PORT, "tools", "entry.py"))
    assert ours["entry"] == ["device"]
    assert ours["dryrun_multichip"][:2] == ["n_devices", "device"]
    assert ours["_dryrun_impl"] == ["n_devices", "device", "params",
                                    "patch", "draws"]
    assert ours["_probe_device_count"] == []


def test_port_imports_neither_root_script():
    """No module of the port, nor ``chip_smoke.py``, imports the
    repository's ``bench.py`` or ``__graft_entry__.py``."""
    for path in _port_sources():
        for mod in _imported_modules(path):
            assert mod.split(".")[0] not in ("bench", "__graft_entry__"), (
                path, mod)


def test_port_tools_import_neither_the_repo_tools_nor_its_cli():
    """No port tool imports JAX, the JAX package, the repository's
    ``tools/`` or ``cli/`` (absolutely, by path or through ``sys.path``):
    they drive the port's own CLI modules. Only the root entry points
    start processes (the probe, the bench's children, the dryrun's
    ranks)."""
    sources = _port_tool_sources()
    # + scenes, victims, __init__
    assert len(sources) == (len(PROTOCOL_TOOLS) + len(MEASUREMENT_TOOLS)
                            + len(MICRO_TOOLS) + len(ROOT_ENTRY_POINTS) + 3)
    launchers = tuple(f"{n}.py" for n in ROOT_ENTRY_POINTS)
    for path in sources:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", JAX_PKG, "tools", "cli",
                               "importlib", "subprocess", "matplotlib",
                               "bench", "__graft_entry__") or (
                top == "matplotlib"
                and path.endswith("plot_history.py")) or (
                top == "subprocess" and path.endswith(launchers)), (path, mod)
        tree = ast.parse(open(path).read(), path)
        assert not [n for n in ast.walk(tree) if isinstance(n, ast.Attribute)
                    and n.attr == "path" and isinstance(n.value, ast.Name)
                    and n.value.id == "sys"], path
    # matplotlib only inside the figure's function (the card's machine
    # has none)
    tree = ast.parse(open(os.path.join(ROOT, PORT, "tools",
                                       "plot_history.py")).read())
    assert not [n for n in tree.body if isinstance(n, (ast.Import,
                                                       ast.ImportFrom))
                and "matplotlib" in ast.dump(n)]


@pytest.mark.parametrize("name", PROTOCOL_TOOLS + MEASUREMENT_TOOLS
                         + MICRO_TOOLS + tuple(ROOT_ENTRY_POINTS))
def test_port_tools_run_as_modules(name):
    """``python -m <port>.tools.<name> --help`` parses and exits 0."""
    out = subprocess.run([sys.executable, "-m", f"{PORT}.tools.{name}",
                          "--help"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")
