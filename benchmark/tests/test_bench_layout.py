"""The benchmark's files: configurations at published widths, their
cfgs read alike by the program and the reference (and the graphs the
benchmark ran before it read cfgs), the FLOP and byte counts, discovery
by name, the card check, the import rules."""

import ast
import json
import os
import shutil
import subprocess

import pytest
import torch

from benchmark import core, inputs, kernels, run
from benchmark.reference import darknet as R
from benchmark.weights import make_weights

from .conftest import HERE, ROOT, TINY, TINY_TRAIN, write_root

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


@pytest.mark.parametrize("name", ["yolov3-dota-608", "yolov3-coco-416"])
def test_cfg_network_is_the_generators(name):
    """The program's network from the committed cfg equals the one its
    generator builds for that configuration (``Network`` is a frozen
    dataclass: ``==`` compares it whole)."""
    from benchmark import port
    cfg = core.Bench(ROOT).config(name)
    gen = port.mod("models.darknet_cfg").yolov3_blocks(
        num_classes=cfg["num_classes"], anchors=cfg["anchors"],
        width=cfg["img_size"], height=cfg["img_size"])
    darknet = port.mod("models.darknet")
    assert port.network(cfg) == darknet.build_network(gen)


def _before(name):
    with open(os.path.join(HERE, "graphs_before_cfg.json")) as f:
        return json.load(f)[name]


def _config(name):
    return TINY if name == "tiny" else core.Bench(ROOT).config(name)


def _sources(blocks):
    out = []
    for i, b in enumerate(blocks):
        if b["type"] == "route":
            out.append([i, [i + r if r < 0 else r for r in b["layers"]]])
        elif b["type"] == "shortcut":
            out.append([i, [i - 1, i + b["from"]]])
    return out


@pytest.mark.parametrize("name", ["yolov3-dota-608", "yolov3-coco-416",
                                  "tiny"])
def test_cfg_gives_the_graph_of_before(name):
    """The reference's blocks from the cfg are the blocks its generators
    wrote out before (``graphs_before_cfg.json``, pinned from them): the
    same keys with the same values, the same conv shapes and the same
    route and shortcut sources; the keys the cfg adds give the padding
    that the forward used then."""
    before = _before(name)
    blocks = R.blocks_for(_config(name))
    assert [list(c) for c in R.conv_shapes(blocks)] == before["conv_shapes"]
    assert _sources(blocks) == before["sources"]
    assert [{k: b[k] for k in old} for b, old in
            zip(blocks, before["blocks"])] == before["blocks"]
    assert len(blocks) == len(before["blocks"])
    for b in blocks:
        if b["type"] == "conv":
            assert b["pad"] == (b["size"] - 1) // 2
        elif b["type"] == "shortcut":
            assert b["act"] == "linear"
        elif b["type"] == "maxpool":
            assert (b["size"], b["stride"], b["padding"]) == (2, 2, 1)


def _then(blocks):
    """Blocks of before, with the padding the forward gave them then:
    ``(size - 1) // 2`` a side for a conv, none for the 2/2 maxpool."""
    extra = {"conv": lambda b: {"pad": (b["size"] - 1) // 2},
             "maxpool": lambda b: {"padding": 0},
             "shortcut": lambda b: {"act": "linear"}}
    return [dict(b, **extra.get(b["type"], lambda b: {})(b))
            for b in blocks]


@pytest.mark.parametrize("name,size", [("yolov3-dota-608", 64),
                                       ("yolov3-coco-416", 32),
                                       ("tiny", 64)])
def test_weights_of_the_cfg_equal_those_of_before(name, size):
    """For a seed, the weights made on the cfg's graph equal bit for bit
    those made on the graph of before (calibrated on small tiles)."""
    cal = inputs.smooth_tiles(2, size, 5, "cpu").float() / 255.0
    got = make_weights(R.blocks_for(_config(name)), 2 ** 40 + 7, "cpu", cal)
    want = make_weights(_then(_before(name)["blocks"]), 2 ** 40 + 7, "cpu",
                        cal)
    assert got.keys() == want.keys()
    for i in want:
        assert all(torch.equal(g, w) for g, w in zip(got[i], want[i])), i


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
    assert R.conv_flops_per_image(R.blocks_for(TINY), 64) == hand == 14040064
    from benchmark import port
    flops = port.mod("models.flops")
    assert flops.conv_fwd_flops_per_image(port.network(TINY)) == hand


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


@pytest.mark.parametrize("cfgfile", ["tiny.cfg", "mish_csp_spp.cfg"])
def test_new_config_traffic_metric_found_without_edits(tmp_path, cfgfile):
    """A configuration, a traffic mix and a metric dropped into a
    checkout as new files are run by name; so is a new architecture, a
    configuration naming a new cfg (``mish_csp_spp.cfg``: Mish, a CSP
    split, SPP, a 2/1 maxpool, heads stride 8 first), under the tiny
    configuration's limits, which its own CPU readings separate as well:
    the program (bfloat16, seeds 1-16) reads composite 0.0020-0.0021,
    heads 0.028-0.041, a row's class gradient 0.005-0.018 and the change
    0.0001-0.0061; the float8 control (seeds 1-3) 0.033-0.042, 0.37-0.53
    and 0.070-0.144."""
    root = str(tmp_path)
    metric = {"name": "attempted_steps", "unit": "steps",
              "better": "higher", "source": "host_clock",
              "layer": "trainer", "moves": "train_img_per_s.tiny",
              "workloads": ["new-cell"]}
    write_root(root, metrics=[metric])
    configs = os.path.join(root, "benchmark", "configs")
    if not os.path.exists(os.path.join(configs, cfgfile)):
        shutil.copy(os.path.join(HERE, cfgfile), configs)
    with open(os.path.join(root, "benchmark", "traffic",
                           "new-mix.json"), "w") as f:
        json.dump(dict(TINY_TRAIN, steps_per_call=1), f)
    with open(os.path.join(configs, "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(configs, "tiny-b.json"), "w") as f:
        json.dump(dict(cfg, name="tiny-b", target_id=3, cfgfile=cfgfile), f)
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
    assert res["correct"], res["compared"]
    assert res["metrics"]["attempted_steps"]["value"] == res["attempted"]
    assert res["attempted"] > 0
    # the device readers find no device operation on the CPU
    assert all(k == "attempted_steps" for k in res["metrics"])


@pytest.mark.parametrize("key,value,named", [
    ("img_size", 96, "width x height 64 x 64 against img_size 96"),
    ("num_classes", 80, "classes 15 against num_classes 80"),
    ("head_filters", 255, "filters 60 against head_filters 255"),
])
def test_read_config_refuses_a_mismatch(tmp_path, key, value, named):
    """Set-up refuses a configuration file whose cfg disagrees with it,
    and names the disagreement."""
    write_root(str(tmp_path))
    path = os.path.join(str(tmp_path), "benchmark", "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    with open(path, "w") as f:
        json.dump(dict(cfg, **{key: value}), f)
    assert core.read_config(os.path.join(
        ROOT, "benchmark", "configs", "yolov3-dota-608.json"))["cfg_text"]
    with pytest.raises(ValueError) as e:
        core.Bench(str(tmp_path)).config("tiny")
    assert named in str(e.value)


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
