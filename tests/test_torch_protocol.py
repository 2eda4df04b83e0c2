"""The port's attack-of-record tools (``<port>/tools/``) on the CPU,
held against the repository's JAX-side tools (loaded with ``importlib``)
and the protocol of record (``evidence/protocol_r05``):

- the scene generator, the control patch, ``trim_trainset`` and the
  schedule arithmetic equal the repository tools' exactly;
- ``protocol_run`` end to end on ``tiny_test_blocks()`` (random weights,
  64^2, patch 16): its summary has the record's keys, and its two legs
  (leg 2 resumed from ``ckpt.pt``) equal one uninterrupted run bit for
  bit;
- ``attack_quality``, ``convergence_compare``, ``soak`` and
  ``plot_history`` run and report; every tool that drives a device
  defaults to cuda and refuses to run without a card;
- the slow twin of ``tests/test_attack_quality.py`` on the mini victim
  through the port's tools and CLIs."""

import ast
import contextlib
import importlib
import importlib.util
import io
import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
FIX = os.path.join(REPO, "tests", "fixtures", "refparity")
CFG = os.path.join(FIX, "mini_yolov3_dota.cfg")
WEIGHTS = os.path.join(FIX, "mini_yolov3_dota.weights")
EVIDENCE = os.path.join(REPO, "evidence", "protocol_r05")


def _tool(name):
    return importlib.import_module(f"{PORT}.tools.{name}")


def _repo_tool(name):
    """A module of the repository's ``tools/`` (the JAX-side tool)."""
    spec = importlib.util.spec_from_file_location(
        f"repo_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


def _tree(root):
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


# -- scenes, control patch, trim, schedule: exact against the repo tools --


@pytest.mark.parametrize("img", [320, 608])
@pytest.mark.parametrize("seed", [0, 2024, 90210])
def test_scenes_equal_the_fixture_generator(img, seed, tmp_path):
    """``make_scene`` / ``_palette`` give the fixture generator's uint8
    scenes and boxes for the same seeds, and ``_gen_scenes`` writes the
    repository tool's PNG files."""
    scenes = _tool("scenes")
    gen = _repo_tool("make_refparity_fixture")
    assert scenes.NUM_CLASSES == gen.NUM_CLASSES
    assert scenes.MINI_IMG == gen.MINI_IMG
    pal = scenes._palette(np.random.default_rng(7))
    assert np.array_equal(pal, gen._palette(np.random.default_rng(7)))
    ours, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        a, boxes_a = scenes.make_scene(ours, pal, img=img)
        b, boxes_b = gen.make_scene(ref, pal, img=img)
        assert a.dtype == np.uint8 and a.shape == (img, img, 3)
        assert np.array_equal(a, b)
        assert boxes_a == boxes_b
    scenes._gen_scenes(str(tmp_path / "port"), 3, seed, img)
    _repo_tool("attack_quality")._gen_scenes(gen, str(tmp_path / "repo"), 3,
                                              seed, img)
    names = sorted(os.listdir(tmp_path / "repo"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"scene_{i:04d}.png" for i in range(3)]
    for n in names:
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / n)),
                              np.asarray(Image.open(tmp_path / "repo" / n)))


@pytest.mark.parametrize("patch_size", [112, 224])
def test_control_patch_equals_the_repo_tool(patch_size, tmp_path):
    ours, ref = tmp_path / "port.png", tmp_path / "repo.png"
    _tool("attack_quality").write_control_patch(str(ours), patch_size)
    _repo_tool("attack_quality").write_control_patch(str(ref), patch_size)
    a, b = np.asarray(Image.open(ours)), np.asarray(Image.open(ref))
    assert a.shape == (patch_size, patch_size, 3)
    assert np.array_equal(a, b)


def _filtered_set(root, n):
    """An images_filter-shaped directory of ``n`` images whose label
    files are missing for some stems."""
    for sub in ("images", "yolo-labels", "yolo-labels_w_conf"):
        os.makedirs(os.path.join(root, sub))
    rng = np.random.default_rng(3)
    for i in rng.permutation(n):
        stem = f"scene_{i:04d}"
        Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(
            os.path.join(root, "images", stem + ".png"))
        if i % 3:
            with open(os.path.join(root, "yolo-labels", stem + ".txt"),
                      "w") as f:
                f.write(f"{i % 15} 0.5 0.5 0.1 0.1\n")
        if i % 4:
            with open(os.path.join(root, "yolo-labels_w_conf",
                                   stem + ".txt"), "w") as f:
                f.write(f"0.5 0.5 0.1 0.1 0.9 0.8 {i % 15}\n")


@pytest.mark.parametrize("n", [4, 9])
def test_trim_trainset_equals_the_repo_tool(n, tmp_path):
    """On two copies of one directory, the port's ``trim_trainset`` keeps
    and moves the same files as the repository tool's; too few images
    refuse alike."""
    _filtered_set(str(tmp_path / "src"), 9)
    shutil.copytree(tmp_path / "src", tmp_path / "port")
    shutil.copytree(tmp_path / "src", tmp_path / "repo")
    ours = _tool("protocol_run").trim_trainset(str(tmp_path / "port"), n)
    ref = _repo_tool("protocol_run").trim_trainset(str(tmp_path / "repo"), n)
    assert ours == ref == n
    assert _tree(tmp_path / "port") == _tree(tmp_path / "repo")
    kept = sorted(os.listdir(tmp_path / "port" / "images"))
    assert kept == [f"scene_{i:04d}.png" for i in range(n)]
    assert len(os.listdir(tmp_path / "port" / "excess_images")) == 9 - n
    with pytest.raises(SystemExit, match="synthesize"):
        _tool("protocol_run").trim_trainset(str(tmp_path / "port"), n + 1)


def test_schedule_summary_reproduces_the_record():
    """``schedule_summary`` of the protocol of record's epoch log (101
    batches an epoch, resumed at 201) is the committed summary's
    ``schedule``, key for key and value for value."""
    with open(os.path.join(EVIDENCE, "protocol_summary.json")) as f:
        record = json.load(f)
    got = _tool("protocol_run").schedule_summary(
        os.path.join(EVIDENCE, "train_log.jsonl"),
        record["batches_per_epoch"], record["resume_break"])
    assert got == record["schedule"]


# -- the tools end to end on tiny blocks -----------------------------------


def _tiny_victim(root):
    models = importlib.import_module(f"{PORT}.models")
    blocks = models.tiny_test_blocks()
    net = models.build_network(blocks)
    cfg, wts = os.path.join(root, "tiny.cfg"), os.path.join(root,
                                                             "tiny.weights")
    models.write_darknet_cfg(blocks, cfg)
    models.save_darknet_weights(net, models.init_params(net, 0), wts)
    return cfg, wts


@pytest.fixture(scope="module")
def protocol(tmp_path_factory):
    """``protocol_prep.prepare`` (320^2 scenes: the generator's boxes need
    room) and ``protocol_run`` on tiny blocks at 64^2 (the loader scales
    the filtered tiles): 8 train images, 22 epochs resumed at 21, 4
    held-out scenes."""
    root = str(tmp_path_factory.mktemp("protocol"))
    cfg, wts = _tiny_victim(root)
    prep = os.path.join(root, "prep")
    kept = _quiet(_tool("protocol_prep").prepare, prep, cfg, wts, 320, 10,
                  4, 0, "cpu")
    out = os.path.join(root, "run")
    argv = ["--train-set", os.path.join(prep, "train_set"),
            "--gt", os.path.join(prep, "gt"), "--cfgfile", cfg,
            "--weightfile", wts, "--out", out, "--img-size", "64",
            "--patch-size", "16", "--train-images", "8", "--epochs", "22",
            "--resume-break", "21", "--device", "cpu"]
    summary = _quiet(_tool("protocol_run").main, argv)
    return {"root": root, "cfg": cfg, "weights": wts, "prep": prep,
            "kept": kept, "out": out, "summary": summary}


def _keys(d):
    return {k: (_keys(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def test_protocol_run_summary_has_the_record_keys(protocol):
    """The tiny run's ``protocol_summary.json`` has the keys of the
    record's, its schedule counts 22 epochs of one padded b24 batch
    resumed at 21, leg 2's output says so, and both patches' metrics are
    reported."""
    s = protocol["summary"]
    assert protocol["kept"] == (10, 4)
    with open(os.path.join(protocol["out"], "protocol_summary.json")) as f:
        assert json.load(f) == json.loads(json.dumps(s))
    with open(os.path.join(EVIDENCE, "protocol_summary.json")) as f:
        record = json.load(f)
    assert _keys(s) == _keys(record)
    assert (s["epochs"], s["train_images"], s["resume_break"],
            s["batches_per_epoch"], s["seed"]) == (22, 8, 21, 1, 0)
    sch = s["schedule"]
    assert (sch["epochs_run"], sch["first_epoch"], sch["last_epoch"],
            sch["total_steps"], sch["resumed_at"]) == (22, 0, 21, 22, 21)
    assert sch["loss_min"] <= sch["loss_first"]
    assert np.isfinite(sch["loss_last"]) and sch["steps_per_min_steady"] > 0
    assert len(os.listdir(os.path.join(
        protocol["prep"], "train_set", "images"))) == 8
    with open(os.path.join(protocol["out"], "cli.log")) as f:
        log = f.read()
    assert "resumed at epoch 21\n" in log
    with open(os.path.join(protocol["out"], "train",
                           "train_log.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == list(range(22))
    for r in s["results"].values():
        assert len(r["M4_per_class_gap_001"]) == 15
        for k in ("M1_avg_instances_created_04",
                  "M1_avg_instances_created_001", "M2_avg_conf_created_001",
                  "mAP"):
            assert np.isfinite(r[k]), k


def test_protocol_legs_equal_one_uninterrupted_run(protocol, tmp_path):
    """Leg 1 (epochs 0-20) and leg 2 (``--resume``: a fresh trainer and
    store restored from the epoch-20 checkpoint) give the patch, and the
    epoch losses, of one uninterrupted 22-epoch ``train_patch`` run, bit
    for bit."""
    tp = importlib.import_module(f"{PORT}.cli.train_patch")
    train_set = os.path.join(protocol["prep"], "train_set")
    one = str(tmp_path / "one")
    _quiet(tp.main, ["--mode", "paper_obj", "--cfgfile", protocol["cfg"],
                     "--weightfile", protocol["weights"],
                     "--img-dir", os.path.join(train_set, "images"),
                     "--lab-dir", os.path.join(train_set, "yolo-labels"),
                     "--img-size", "64", "--patch-size", "16", "--seed", "0",
                     "--device-store", "--out-dir", one, "--device", "cpu",
                     "--epochs", "22"])
    two = os.path.join(protocol["out"], "train")
    a = np.asarray(Image.open(os.path.join(one, "final_patch.png")))
    b = np.asarray(Image.open(os.path.join(two, "final_patch.png")))
    assert np.array_equal(a, b)

    def losses(d):
        with open(os.path.join(d, "train_log.jsonl")) as f:
            return [(r["epoch"], r["loss"], r["no_obj"], r["tv"], r["lr"])
                    for r in map(json.loads, f)]
    assert losses(one) == losses(two)


def test_protocol_run_refuses_a_break_off_the_checkpoint_grid(tmp_path):
    """Leg 2 resumes from the last checkpoint (every 20 epochs), so
    break - 1 must be a multiple of 20 and the break below --epochs."""
    run = _tool("protocol_run")
    base = ["--train-set", str(tmp_path), "--gt", str(tmp_path),
            "--cfgfile", "x.cfg", "--weightfile", "x.weights",
            "--out", str(tmp_path / "out"), "--device", "cpu"]
    for epochs, brk in ((22, 20), (40, 41), (21, 21)):
        with pytest.raises(SystemExit):
            with contextlib.redirect_stderr(io.StringIO()):
                run.main(base + ["--epochs", str(epochs), "--resume-break",
                                 str(brk)])
    assert not (tmp_path / "out").exists()


def test_plot_history_writes_the_figure(protocol, tmp_path):
    ph = _tool("plot_history")
    run_dir = os.path.join(protocol["out"], "train")
    rows = ph.load_history(os.path.join(run_dir, "train_log.jsonl"))
    assert rows == _repo_tool("plot_history").load_history(
        os.path.join(run_dir, "train_log.jsonl"))
    out = str(tmp_path / "curves.png")
    got = _quiet(ph.main, [run_dir, "-o", out])
    assert got == {"out": out, "epochs": 22}
    img = Image.open(out)
    assert img.format == "PNG" and img.size == (1320, 480)
    with pytest.raises(SystemExit, match="no epochs"):
        open(tmp_path / "empty.jsonl", "w").close()
        ph.main([str(tmp_path / "empty.jsonl")])


def test_soak_on_tiny_blocks(tmp_path):
    """A few soak steps on tiny blocks (CPU, bf16 detector): every loss
    term finite, the patch in [0, 1], the loss falling."""
    cfg, _ = _tiny_victim(str(tmp_path))
    rec = _quiet(_tool("soak").main, ["5", "2", "--cfgfile", cfg,
                                      "--img-size", "64", "--patch-size",
                                      "16", "--device", "cpu"])
    assert (rec["steps"], rec["batch"], rec["img_size"]) == (5, 2, 64)
    assert np.isfinite(rec["loss_first"]) and rec["loss_last"] < \
        rec["loss_first"]
    assert rec["routes"]["stem"] == "conv"


def test_convergence_compare_on_the_mini_victim(tmp_path):
    """One epoch of one b24 batch on the mini victim's pseudo-labeled
    scenes: the table's rows finite, the JSON beside the reference's
    epoch-0 anchors."""
    out = str(tmp_path / "cc.json")
    rec = _quiet(_tool("convergence_compare").main,
                 ["1", "24", "--device", "cpu", "--out", out])
    # the repository tool parses sys.argv at import: read its anchors
    # from its source
    src = os.path.join(REPO, "tools", "convergence_compare.py")
    anchors = [ast.literal_eval(node.value) for node in ast.parse(
        open(src).read()).body if isinstance(node, ast.Assign)
        and getattr(node.targets[0], "id", "") == "REF_EPOCH0"]
    assert rec["reference_epoch0"] == anchors[0]
    assert [r["epoch"] for r in rec["mini"]] == [0]
    assert all(np.isfinite(v) for r in rec["mini"] for v in r.values())
    with open(out) as f:
        assert json.load(f) == rec


def test_attack_quality_orchestration_on_the_mini_victim(tmp_path):
    """``attack_quality --mini`` at a tiny schedule (one b24 step, 3
    held-out scenes): ``summary.json`` with both patches' finite M1 / M2
    and 15 M4 entries; a non-empty ``--out`` is refused without
    ``--force``."""
    aq = _tool("attack_quality")
    out = str(tmp_path / "aq")
    argv = ["--mini", "--train-scenes", "26", "--test-scenes", "3",
            "--epochs", "1", "--out", out, "--device", "cpu"]
    s = _quiet(aq.main, argv)
    assert (s["scale"], s["img"], s["patch"], s["epochs"]) == ("mini", 320,
                                                               112, 1)
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == s
    for r in s["results"].values():
        assert np.isfinite(r["M1_avg_instances_created_04"])
        assert np.isfinite(r["M2_avg_conf_created_001"])
        assert len(r["M4_per_class_gap_001"]) == 15
    with open(os.path.join(out, "cli.log")) as f:
        log = f.read()
    assert log.count("\n=== ") == 7   # 2 filters, 1 train, 2 x (paste, metrics)
    with pytest.raises(SystemExit, match="--force"):
        aq.main(argv)


@pytest.mark.parametrize("tool,argv", [
    ("attack_quality", ["--mini"]),
    ("protocol_prep", ["--mini", "--out", "{tmp}/prep"]),
    ("protocol_run", ["--train-set", "{tmp}", "--gt", "{tmp}", "--cfgfile",
                      "x", "--weightfile", "x", "--out", "{tmp}/run"]),
    ("convergence_compare", []),
    ("soak", ["1", "1"]),
])
def test_tools_default_to_cuda_and_refuse_without_a_card(tool, argv,
                                                          monkeypatch,
                                                          tmp_path):
    """With no visible card each device tool's default ``--device cuda``
    raises before it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a.format(tmp=tmp_path) for a in argv]
    before = sorted(os.listdir(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        _tool(tool).main(argv)
    assert sorted(os.listdir(tmp_path)) == before


@pytest.mark.parametrize("tool,argv,message", [
    ("attack_quality", ["--full"], "{fix}/refparity_full/"
     "yolov3_dota_synth.weights missing — regenerate with make "
     "refparity-full"),
    ("protocol_prep", ["--out", "{tmp}/prep"], "{fix}/refparity_full/"
     "yolov3_dota_synth.weights missing — regenerate with make "
     "refparity-full"),
    ("convergence_compare", ["--full"], "{fix}/refparity_full/"
     "yolov3_dota_synth.weights missing — regenerate with "
     "tools/make_refparity_fixture.py --full"),
])
def test_full_presets_exit_with_the_repo_tools_message(tool, argv, message,
                                                       monkeypatch,
                                                       tmp_path):
    """The full-width presets need ``tests/fixtures/refparity_full``'s
    trained weights, which are not committed: without them each tool
    exits with the repository tool's own message, before any work."""
    mod = _tool(tool)
    fix = str(tmp_path / "fixtures")
    monkeypatch.setattr(mod, "FIXROOT", fix)
    with pytest.raises(SystemExit) as e:
        mod.main([a.format(tmp=tmp_path) for a in argv]
                 + ["--device", "cpu"])
    assert str(e.value) == message.format(fix=fix)
    assert sorted(os.listdir(tmp_path)) == []


# -- the slow twin of tests/test_attack_quality.py -------------------------


@pytest.mark.slow
def test_attack_quality_protocol_mini_on_the_port(tmp_path):
    """``tests/test_attack_quality.py`` through the port: the port's
    scenes and control patch, its CLIs on the CPU. The trained patch must
    create more high-confidence instances (M1@0.4) and add more
    confidence per created instance (M2@0.01) than the random control."""
    scenes, aq = _tool("scenes"), _tool("attack_quality")
    cli = {n: importlib.import_module(f"{PORT}.cli.{n}") for n in (
        "images_filter", "train_patch", "test_patch", "test_patch_metrics")}
    img, patch = 320, 112
    model_args = ["--cfgfile", CFG, "--weightfile", WEIGHTS,
                  "--img-size", str(img), "--fp32", "--device", "cpu"]
    scenes._gen_scenes(str(tmp_path / "raw_train"), 24, 2024, img)
    scenes._gen_scenes(str(tmp_path / "raw_test"), 8, 4048, img)
    for raw, dst in (("raw_train", "train_set"), ("raw_test", "gt")):
        _quiet(cli["images_filter"].main, model_args + [
            "--img-dir", str(tmp_path / raw), "--out-dir",
            str(tmp_path / dst)])
    n_train = len(os.listdir(tmp_path / "train_set" / "images"))
    n_test = len(os.listdir(tmp_path / "gt" / "images"))
    assert n_train >= 24 // 2 and n_test >= 8 // 2, (n_train, n_test)
    _quiet(cli["train_patch"].main, [
        "--mode", "paper_obj", "--cfgfile", CFG, "--weightfile", WEIGHTS,
        "--img-dir", str(tmp_path / "train_set" / "images"),
        "--lab-dir", str(tmp_path / "train_set" / "yolo-labels"),
        "--img-size", str(img), "--patch-size", str(patch),
        "--batch-size", "8", "--epochs", "30", "--seed", "0",
        "--num-workers", "2", "--device", "cpu",
        "--out-dir", str(tmp_path / "run")])
    ctrl = tmp_path / "random_patch.png"
    aq.write_control_patch(str(ctrl), patch)
    reports = {}
    for name, png in (("trained", tmp_path / "run" / "final_patch.png"),
                      ("random", ctrl)):
        _quiet(cli["test_patch"].main, model_args + [
            "--patch", str(png), "--patch-size", str(patch),
            "--img-dir", str(tmp_path / "gt" / "images"),
            "--lab-dir", str(tmp_path / "gt" / "yolo-labels_w_conf"),
            "--out-dir", str(tmp_path / f"attacked_{name}"), "--seed", "0"])
        reports[name] = _quiet(cli["test_patch_metrics"].main, [
            "--pred-dir", str(tmp_path / f"attacked_{name}"),
            "--gt-dir", str(tmp_path / "gt"), "--json"])
    t, r = reports["trained"], reports["random"]
    for rep in (t, r):
        assert np.isfinite(rep["M1_avg_instances_created_04"])
        assert np.isfinite(rep["M1_avg_instances_created_001"])
        assert len(rep["M4_per_class_gap_001"]) == 15
    assert t["M1_avg_instances_created_04"] > \
        r["M1_avg_instances_created_04"], (t, r)
    assert t["M2_avg_conf_created_001"] > r["M2_avg_conf_created_001"], \
        (t, r)
