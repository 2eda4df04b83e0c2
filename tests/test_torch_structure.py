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


def test_kernel_wrappers_use_plain_versions_only_on_cpu():
    """On CPU tensors the kernel wrappers run their plain versions and
    count no launch."""
    import importlib
    pc = importlib.import_module(f"{PORT}.ops.planar_conv")
    sf = importlib.import_module(f"{PORT}.ops.stem_fused")
    before = (pc.to_planar.launches, pc.from_planar.launches,
              sf.fused_stem_fwd.launches)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, 8, 8, 3), dtype=np.float32))
    xp = pc.to_planar(x)
    assert torch.equal(pc.from_planar(xp, 8, 3), x)
    assert (pc.to_planar.launches, pc.from_planar.launches,
            sf.fused_stem_fwd.launches) == before


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
