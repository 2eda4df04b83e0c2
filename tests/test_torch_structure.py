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
                pc.from_planar.launches, sf.fused_stem_fwd.launches,
                sf.fused_stem_fwd.save_acts_launches,
                sf.fused_stem_bwd_saved.launches)
    before = counts()
    rng = np.random.default_rng(0)
    for c in (3, 40):   # both K3a variants' choice of C
        x = torch.from_numpy(rng.random((1, 8, 8, c), dtype=np.float32))
        xp = pc.to_planar(x)
        assert torch.equal(pc.from_planar(xp, 8, c), x)
    assert counts() == before


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
