"""The benchmark's files: configurations at published widths, the FLOP
and byte counts, discovery by name, the card check, the import rules."""

import ast
import json
import os
import subprocess

import pytest
import torch

from benchmark import core, kernels, run
from benchmark.reference import darknet as R

from .conftest import ROOT, TINY_TRAIN, write_root

PORT = core.PORT


def _spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name,classes,size,filters", [
    ("yolov3-dota-608", 15, 608, 60), ("yolov3-coco-416", 80, 416, 255)])
def test_config_builds_published_widths(name, classes, size, filters):
    cfg = core.Bench(ROOT).config(name)
    assert (cfg["num_classes"], cfg["img_size"]) == (classes, size)
    assert cfg["head_filters"] == filters
    convs = R.conv_shapes(R.blocks_for(cfg))
    assert len(convs) == 75
    heads = [c for c in convs if not c[5]]
    assert [c[2] for c in heads] == [filters] * 3
    assert max(c[2] for c in convs) == 1024
    from benchmark import port
    net = port.network(cfg)
    spec = [(s.index, s.in_ch, s.filters, s.size, s.stride, s.bn)
            for s in port.mod("models.darknet").conv_specs(net)]
    assert spec == convs
    assert len(cfg["decode_anchors"]) == 9


def test_flops_hand_count_tiny():
    # conv by conv at 64^2: 2 * out_h * out_w * cout * cin * k * k
    hand = (2 * 64 * 64 * 8 * 3 * 9 + 2 * 32 * 32 * 16 * 8 * 9
            + 2 * 32 * 32 * 8 * 16 + 2 * 32 * 32 * 16 * 8 * 9
            + 2 * 16 * 16 * 32 * 16 * 9 + 2 * 8 * 8 * 32 * 32 * 9
            + 2 * 4 * 4 * 64 * 32 * 9 + 2 * 2 * 2 * 64 * 64 * 9
            + 2 * 2 * 2 * 32 * 64 + 2 * 2 * 2 * 60 * 32
            + 2 * 2 * 2 * 16 * 32 + 2 * 4 * 4 * 32 * 80 * 9
            + 2 * 4 * 4 * 60 * 32 + 2 * 4 * 4 * 16 * 32
            + 2 * 8 * 8 * 32 * 48 * 9 + 2 * 8 * 8 * 60 * 32)
    assert R.conv_flops_per_image(R.tiny_blocks(15), 64) == hand == 14040064
    from benchmark import port
    flops = port.mod("models.flops")
    net = port.network(json.loads(json.dumps(
        {"architecture": "tiny", "num_classes": 15, "img_size": 64})))
    assert flops.conv_fwd_flops_per_image(net) == hand


def _stem_weights():
    gen = torch.Generator().manual_seed(0)
    shapes = [(3, 3, 3, 32), (3, 3, 32, 64), (1, 1, 64, 32), (3, 3, 32, 64),
              (3, 3, 64, 128)]
    return [(0.1 * torch.randn(s, generator=gen)).to(torch.bfloat16)
            for s in shapes], [torch.zeros(s[-1]) for s in shapes]


@pytest.mark.parametrize("b,h", [(1, 64), (2, 96)])
def test_stem_byte_counts(b, h):
    """The roofline's bytes equal the sizes of the tensors the port's
    stem kernels read and write at that shape."""
    from benchmark import port
    SF = port.mod("ops.stem_fused")
    ws, bs = _stem_weights()
    sp = list(zip(ws, bs))
    x = torch.rand(b, h, h, 3).to(torch.bfloat16)
    xe, xo = SF.split_phases(x)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    y5, masks = acts[0], acts[1:]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    assert kernels.y5_written(b, h) == nbytes([y5])
    assert kernels.masks_written(b, h) == nbytes(masks)
    assert kernels.x_phases_read(b, h) == 2 * b * h * 3 * (h // 2) * 2
    g5 = torch.zeros_like(y5)
    gx = SF.fused_stem_bwd_saved(acts, g5, SF.stem_bwd_params(sp))
    h1, h5 = h // 2, h // 4
    mask_read = sum(m.shape[0] * m.shape[1] * m.shape[2] * h1
                    for m in masks)
    assert kernels.k2_bytes(b, h) == (mask_read + 2 * b * h5 * 128 * h5 * 2
                                      + nbytes(gx))


def test_bench_json_names_its_files():
    spec = _spec()
    bench = core.Bench(ROOT)
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/")
        assert bench.config(c["name"])["name"] == c["name"]
    for w in spec["workloads"]:
        tr = bench.traffic(w["traffic"])
        assert os.path.exists(bench.find("loops", tr["loop"], ".py"))
        assert w["name"] in json.dumps(spec["per_layer"])
    for m in spec["per_layer"]:
        assert callable(bench.module("metrics", m["name"]).read)
    for m in spec["per_layer"]:
        for w in m["workloads"]:
            assert m["moves"] in {e["name"] for e in bench.end_to_end(w)}


def test_new_config_traffic_metric_found_without_edits(tmp_path):
    """A configuration, a traffic mix and a metric dropped into a
    checkout as new files are run by name."""
    root = str(tmp_path)
    metric = {"name": "attempted_steps", "unit": "steps",
              "better": "higher", "source": "host_clock",
              "layer": "trainer", "moves": "train_img_per_s.tiny",
              "workloads": ["new-cell"]}
    write_root(root, metrics=[metric])
    with open(os.path.join(root, "benchmark", "traffic",
                           "new-mix.json"), "w") as f:
        json.dump(dict(TINY_TRAIN, steps_per_call=1), f)
    with open(os.path.join(root, "benchmark", "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "benchmark", "configs",
                           "tiny-b.json"), "w") as f:
        json.dump(dict(cfg, name="tiny-b", target_id=3), f)
    os.makedirs(os.path.join(root, "benchmark", "metrics"))
    with open(os.path.join(root, "benchmark", "metrics",
                           "attempted_steps.py"), "w") as f:
        f.write("def read(r):\n    return float(r.window.attempted)\n")
    spec_path = os.path.join(root, "BENCHMARK.json")
    with open(spec_path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny-b", "source": "tests",
                            "file": "benchmark/configs/tiny-b.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "new-cell", "config": "tiny-b",
                              "traffic": "new-mix", "chips": 1,
                              "why": "tests"})
    spec["end_to_end"][0]["workloads"].append("new-cell")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    with open(os.devnull, "w") as out:
        res = run.run_cell(root, "new-cell", 7, 2.0, True, device="cpu",
                           out=out)
    assert res["metrics"]["attempted_steps"]["value"] == res["attempted"]
    assert res["attempted"] > 0
    # the device readers find no device operation on the CPU
    assert all(k == "attempted_steps" for k in res["metrics"])


def test_run_without_card_fails(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "dota608-train-b24", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_command_without_card_or_port_fails(tmp_path):
    """The command in a directory that holds only BENCHMARK.json and the
    benchmark's files exits non-zero and prints no result."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = _spec()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(spec["command"] + ["--workload", "dota608-train-b24",
                                          "--seed", "2", "--seconds", "1",
                                          "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules(sub=""):
    base = os.path.join(ROOT, "benchmark", sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax():
    for path in _modules():
        for top in _imports(path):
            assert top not in core.FORBIDDEN, (path, top)
    # whole names: the port's name begins with the JAX package's
    assert PORT.split(".")[0] not in core.FORBIDDEN
    assert core.forbidden_modules({PORT: 1, PORT + ".ops": 1}) == []
    assert core.forbidden_modules({"jax.numpy": 1}) == ["jax.numpy"]


def test_reference_imports_neither_port_nor_jax():
    for path in _modules("reference"):
        text = open(path).read()
        assert PORT not in text and "importlib" not in text, path
        for top in _imports(path):
            assert top in ("__future__", "contextlib", "math", "os",
                           "typing", "numpy", "torch"), (path, top)
