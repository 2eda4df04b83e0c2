"""The port's root entry points (``<port>/tools/bench.py``, the
counterpart of ``bench.py``, and ``<port>/tools/entry.py``, of
``__graft_entry__.py``) on the CPU, as ``tests/test_bench.py`` and
``tests/test_graft_entry.py`` hold the repository's:

- the bench prints its one JSON record whatever the backend does: the
  record line is found among others, the out-of-process probe reads a
  crash, garbage or a hang as no card, and a dead backend, a crashing
  child or a hung one give the "error" record (value 0.0) without
  raising;
- the bench's recipe (constants, scenes, the label row, lr, warm-up and
  timed steps, seeds, the record's arithmetic) against ``bench.py``'s,
  read as text; ``mfu`` over several cards against the JAX package's
  formula;
- ``entry(device="cpu")``'s heads at full width, and no CPU fallback on
  ``"cuda"``, the dryrun's default too;
- ``dryrun_multichip(2, "cpu")`` in two fresh gloo processes, fed the JAX
  dryrun's weights, initial patch and EOT draws (its key's, rebuilt):
  the loss and the updated patch of the JAX dryrun step on a 2-device
  mesh within 1e-5 relative, both ranks' patches equal;
- ``_assert_layouts`` refusing a replicated batch, rows out of order and
  a patch or optimizer state that differs between ranks;
- ``python -m <port>.tools.entry 4 --device cpu``: 4 gloo ranks, ``4-way
  cpu mesh``; without ``--device`` and without a visible card it raises;
- ``parallel/mesh.py: run_ranks`` stops its processes when it is sent
  SIGTERM.

The card is hidden (``CUDA_VISIBLE_DEVICES=""``) from every process
these tests start that would otherwise look for one.
"""

import ast
import contextlib
import importlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu import train as JT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import (
    build_network as jax_build_network, fold_bn as jax_fold_bn,
    init_params as jax_init_params, tiny_test_blocks as jax_tiny_blocks)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import flops as JF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.parallel.mesh import (
    Mesh, batch_sharding, replicated)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import ops as PO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.parallel import mesh as PMESH
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import flops as PF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.tools import bench as B
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.tools import entry as E
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.tools import step_profile as SP

from test_torch_eot import jax_draws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
H100 = "NVIDIA H100 80GB HBM3"


def _text(name):
    with open(os.path.join(ROOT, name)) as f:
        return f.read()


def _constants(name):
    """The module-level constants of a repository script, read as text."""
    out = {}
    for node in ast.parse(_text(name)).body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                out[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    return out


def _main(monkeypatch, **attrs):
    """``bench.main([])`` with ``attrs`` set on the module: (its return,
    the record its output's last JSON line holds, that output)."""
    monkeypatch.delenv(B._CHILD_SENTINEL, raising=False)
    for k, v in attrs.items():
        monkeypatch.setattr(B, k, v)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = B.main([])
    out = buf.getvalue()
    assert out.strip().splitlines()[-1] == json.dumps(got)
    return got, json.loads(B._extract_json_line(out)), out


def test_extract_json_line_picks_metric_record():
    text = ("# comment\n"
            "{\"not\": \"it\"}\n"
            "{\"metric\": \"m\", \"value\": 1.5, \"unit\": \"u\"}\n")
    assert json.loads(B._extract_json_line(text))["value"] == 1.5
    assert B._extract_json_line("garbage\nnope") == ""
    assert B._extract_json_line("{\"metric\": 1, \"value\": broken\n") == ""


@pytest.mark.parametrize("module", [B, E], ids=["bench", "entry"])
def test_probe_device_count_failure_modes(monkeypatch, module):
    """Each entry point's out-of-process probe (``count_cards``) reads a
    crash, garbage output and a hang as no card, and the last integer
    printed as the count."""
    monkeypatch.setattr(PMESH, "PROBE_CODE", "import sys; sys.exit(3)")
    assert module._probe_device_count() == 0
    monkeypatch.setattr(PMESH, "PROBE_CODE", "print('no devices here')")
    assert module._probe_device_count() == 0
    monkeypatch.setattr(PMESH, "PROBE_CODE",
                        "print('warning: x'); print(4)")
    assert module._probe_device_count() == 4
    monkeypatch.setattr(PMESH, "PROBE_CODE", "import time; time.sleep(600)")
    monkeypatch.setattr(module, "_PROBE_TIMEOUT_S", 2.0)
    assert module._probe_device_count() == 0


def test_probe_finds_no_hidden_card(monkeypatch):
    """The real probe counts no card where none is visible."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert B._probe_device_count() == 0


def test_main_emits_error_json_when_backend_unavailable(monkeypatch):
    """Probe always fails, no backoff: ``main`` still prints a parsable
    record with an error field and returns (exit code 0)."""
    got, rec, out = _main(monkeypatch, _probe_device_count=lambda: 0,
                          _BACKOFF_S=0.0)
    assert rec == got
    assert rec["metric"] == "patch_train_steps_per_min_b8_0dev"
    assert rec["value"] == 0.0 and rec["vs_baseline"] == 0.0
    assert rec["error"] == "device probe failed/timed out"
    assert out.count("# backend unavailable") == B._ATTEMPTS - 1


def test_main_emits_error_json_when_child_hangs(monkeypatch):
    """Probe OK but the bench child hangs: the bounded child timeout turns
    that into the error record, and the child is killed."""
    got, rec, _ = _main(
        monkeypatch, _probe_device_count=lambda: 1, _BACKOFF_S=0.0,
        _CHILD_TIMEOUT_S=1.0, _CHILD_RETRY_TIMEOUT_S=1.0, _ATTEMPTS=2,
        _CHILD_ARGS=("-c", "import time; time.sleep(600)"))
    assert rec["value"] == 0.0
    assert rec["error"] == "bench child timed out after 1s"


def test_main_emits_error_json_when_child_fails(monkeypatch):
    """A child that dies (a kernel that fails to build or launch, a card
    that is gone) gives the error record with its exit code and last
    error line: there is no fallback path."""
    got, rec, _ = _main(
        monkeypatch, _probe_device_count=lambda: 1, _BACKOFF_S=0.0,
        _ATTEMPTS=1, _CHILD_ARGS=(
            "-c", "import sys; print('partial'); "
                  "sys.stderr.write('x\\nRuntimeError: boom\\n'); "
                  "sys.exit(3)"))
    assert rec["value"] == 0.0
    assert rec["error"] == "bench child rc=3: RuntimeError: boom"


def test_bench_child_without_a_card_raises_not_falls_back(monkeypatch):
    """The real child with the card hidden: it refuses the missing card
    (no CPU run), and the parent prints the error record."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    got, rec, _ = _main(monkeypatch, _probe_device_count=lambda: 1,
                        _BACKOFF_S=0.0, _ATTEMPTS=1)
    assert rec["value"] == 0.0
    assert "torch.cuda.is_available() is False" in rec["error"], rec


def test_bench_recipe_matches_bench_py():
    """The port's bench keeps ``bench.py``'s constants, child sentinel,
    attempts and bounds, its step's scenes, label row, lr, warm-up and
    timed steps, its victim's and patch's seeds, and its record."""
    ref = _constants("bench.py")
    for name in ("BATCH", "IMG", "REFERENCE_IMG_PER_S", "_CHILD_SENTINEL",
                 "_ATTEMPTS", "_BACKOFF_S", "_PROBE_TIMEOUT_S",
                 "_CHILD_TIMEOUT_S", "_CHILD_RETRY_TIMEOUT_S"):
        assert getattr(B, name) == ref[name], name
    src = _text("bench.py")
    assert 'METRIC = f"patch_train_steps_per_min_b{BATCH}"' in src
    assert B.METRIC == f"patch_train_steps_per_min_b{ref['BATCH']}"
    row = re.search(r"labels\[:, 0\] = \[([^\]]*)\]", src).group(1)
    assert B.LABEL0 == tuple(float(v) for v in row.split(","))
    assert float(re.search(r"lr = jnp\.float32\(([\d.]+)\)", src).group(1)) \
        == B.LR
    assert re.findall(r"for _ in range\((\d+)\):", src)[0] == str(B.WARMUP)
    assert re.search(r"n_steps = (\d+)", src).group(1) == str(B.STEPS)
    assert "max_labels=252" in src and SP.MAX_LABELS == 252
    assert "patch_size=224" in src and SP.PATCH == 224
    assert 'compute_dtype="bfloat16"' in src
    # the victim from key 1, the patch from key 0, the scenes from
    # default_rng(0): the port's seeds 1 and 0 and the same scenes
    assert "init_params(net, jax.random.PRNGKey(1))" in src
    assert "T.init_train_state(exp, jax.random.PRNGKey(0))" in src
    sp_src = _text(os.path.join(PORT, "tools", "step_profile.py"))
    assert "fold_bn(net, init_params(net, 1))" in sp_src
    assert "generator.manual_seed(0)" in sp_src
    assert "rng = np.random.default_rng(0)" in src
    images, labels = SP.step_inputs(B.BATCH, B.LABEL0)
    want = np.random.default_rng(0).random(
        (ref["BATCH"], ref["IMG"], ref["IMG"], 3), np.float32)
    np.testing.assert_array_equal(images, want)
    want = np.full((ref["BATCH"], 252, 5), 1e-6, np.float32)
    want[:, 0] = B.LABEL0
    np.testing.assert_array_equal(labels, want)
    # the record's arithmetic: steps a minute, img/s over the V100S's
    for dt, n_dev, mfu in ((1.5, 1, 0.05123456), (0.9, 2, None)):
        rec = B.bench_record(dt, 30, n_dev, mfu)
        assert rec == {k: v for k, v in {
            "metric": f"patch_train_steps_per_min_b8_{n_dev}dev",
            "value": round(30 / dt * 60.0, 2), "unit": "steps/min",
            "vs_baseline": round(30 * ref["BATCH"] / dt
                                 / ref["REFERENCE_IMG_PER_S"], 3),
            "ms_per_step": round(dt / 30 * 1e3, 2),
            "mfu": None if mfu is None else round(mfu, 4)}.items()
            if v is not None}
    assert B.bench_record(1.5, 30, 1)["vs_baseline"] == 8.333


def test_bench_ranks_split_the_batch():
    assert [B._ranks(c) for c in range(1, 10)] == [1, 2, 2, 4, 4, 4, 4, 8,
                                                   8]


def test_kernel_launches_reads_and_resets_every_counter():
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused
    assert B.kernel_launches is PO.kernel_launches
    saved = PO.kernel_launches()
    try:
        stem_fused.fused_stem_fwd.save_acts_launches = 7
        assert PO.kernel_launches()["fused_stem_fwd_save_acts"] == 7
        assert set(PO.kernel_launches(reset=True).values()) == {0}
        assert stem_fused.fused_stem_fwd.save_acts_launches == 0
    finally:
        for name, (mod, fn, attr) in PO.LAUNCH_COUNTERS.items():
            wrapper = getattr(importlib.import_module(
                f"{PORT}.ops.{mod}"), fn)
            setattr(wrapper, attr, saved[name])


@pytest.mark.parametrize("n_devices", [1, 2, 4])
def test_mfu_matches_the_jax_formula(monkeypatch, n_devices):
    """The port's ``mfu`` over ``n_devices`` cards equals the JAX
    package's (given the H100's peak): each card's share of the global
    batch's FLOPs over its peak."""
    monkeypatch.setattr(JF, "peak_flops_bf16",
                        lambda kind: 989e12 if kind == H100 else None)
    blocks = PM.yolov3_blocks()
    pnet, jnet = PM.build_network(blocks), jax_build_network(blocks)
    got = PF.mfu(0.05, 8, pnet, H100, n_devices=n_devices)
    want = JF.mfu(0.05, 8, jnet, H100, n_devices=n_devices)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(
        PF.mfu(0.05, 8, pnet, H100) / n_devices, rel=1e-12)
    assert PF.mfu(0.05, 8, pnet, "NVIDIA H100 PCIe", n_devices) is None
    assert PF.mfu(0.0, 8, pnet, H100, n_devices) is None


def test_entry_heads_on_cpu():
    """``entry(device="cpu")``: the full-width bf16 victim's three raw
    heads on the zero image (the conv walk: the CPU takes no stem kernel,
    as the ``Detector`` there)."""
    fn, args = E.entry(device="cpu")
    (x,) = args
    assert tuple(x.shape) == (1, 608, 608, 3) and x.dtype == torch.float32
    assert not x.any()
    assert fn.model.compute_dtype == torch.bfloat16
    heads = fn(*args)
    assert [tuple(h.shape) for h in heads] == [
        (1, 19, 19, 60), (1, 38, 38, 60), (1, 76, 76, 60)]
    assert all(h.dtype == torch.float32 and torch.isfinite(h).all()
               for h in heads)
    assert PM.last_routes() == {"stem": "conv", "res152": "conv"}


def test_entry_points_refuse_missing_cuda(monkeypatch):
    """With no visible card, ``entry()`` and ``dryrun_multichip(n)`` (its
    default device is "cuda") raise: neither moves to the CPU. With a
    card but fewer than n, the dryrun raises before it starts a rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        E.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        E.dryrun_multichip(2, "cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        E.dryrun_multichip(2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(E, "_probe_device_count", lambda: 1)
    monkeypatch.setattr(E, "_launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(RuntimeError, match="needs 2 cards, the probe "
                                           "found 1"):
        E.dryrun_multichip(2)


def _jax_inputs(n):
    """The inputs of ``__graft_entry__.py``'s dryrun step on n devices:
    its victim's net and folded params, its initial state and patch, and
    the draws its step's key makes (rebuilt as the port's ``EOTDraws``)."""
    exp = JT.ExperimentConfig(
        name="dryrun", img_size=64, patch_size=16, batch_size=2 * n,
        max_labels=8, compute_dtype="float32")
    net = jax_build_network(jax_tiny_blocks(width=64, height=64))
    params = jax_fold_bn(net, jax_init_params(net, jax.random.PRNGKey(1)))
    state = JT.init_train_state(exp, jax.random.PRNGKey(0))
    draws = jax_draws(jax.random.split(state.key)[1], 2 * n, 16,
                      JE.EOTConfig(img_size=64))
    return exp, net, params, state, np.asarray(state.patch).copy(), draws


def _jax_dryrun(n, inputs_path):
    """``__graft_entry__.py``'s dryrun step on an n-device mesh. Its
    weights, initial patch and draws go to ``inputs_path`` first (the
    port's dryrun's ``inputs.pt``); returns (initial patch, loss, updated
    patch)."""
    exp, net, params, state, p0, draws = _jax_inputs(n)
    torch.save({"params": PM.params_from_jax(params),
                "patch": torch.from_numpy(p0),
                "draws": dict(vars(draws))}, inputs_path + ".tmp")
    os.replace(inputs_path + ".tmp", inputs_path)
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    rep, data = replicated(mesh), batch_sharding(mesh)
    step = JT.make_train_step(net, exp, mesh=mesh)
    rng = np.random.default_rng(0)
    images = rng.random((2 * n, 64, 64, 3), np.float32)
    labels = np.full((2 * n, 8, 5), 1e-6, np.float32)
    labels[:, 0] = [0, 0.5, 0.5, 0.2, 0.3]
    state, aux = step(jax.device_put(state, rep),
                      jax.device_put(params, rep),
                      jax.device_put(images, data),
                      jax.device_put(labels, data), jnp.float32(0.03))
    return p0, float(aux["loss"]), np.asarray(state.patch)


# the JAX dryrun as ``__graft_entry__.py`` runs it on the CPU: n virtual
# devices, backend optimization level 0 (its compile in half the time,
# the same numerics), in a process of its own that hands the port's ranks
# its inputs before it compiles its step
JAX_DRYRUN = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from test_torch_entry_points import _jax_dryrun
p0, loss, patch = _jax_dryrun(int(sys.argv[1]), sys.argv[2])
np.savez(sys.argv[3], p0=p0, loss=loss, patch=patch)
"""


def test_dryrun_two_gloo_ranks_match_the_jax_dryrun(tmp_path, capsys):
    """``dryrun_multichip(2, "cpu")`` fed the JAX dryrun's weights,
    initial patch and draws: the loss and the updated patch of the JAX
    step on a 2-device mesh within 1e-5 relative, the two ranks' patches
    and optimizer states equal, and the line naming a 2-way cpu mesh."""
    inputs = tmp_path / "inputs.pt"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2 "
                         "--xla_backend_optimization_level=0",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
                   [ROOT, os.path.join(ROOT, "tests")]))
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_DRYRUN, "2", str(inputs),
         str(tmp_path / "jax.npz")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while not inputs.exists():
            assert jax_proc.poll() is None, jax_proc.communicate()[0][-3000:]
            assert time.monotonic() < deadline, "no inputs from the JAX step"
            time.sleep(0.2)
        rec = E.dryrun_multichip(2, "cpu", workdir=str(tmp_path))
        jax_out = jax_proc.communicate(timeout=300)[0]
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, jax_out[-3000:]
    ref = np.load(tmp_path / "jax.npz")
    p0 = torch.load(inputs, weights_only=True)["patch"].numpy()
    np.testing.assert_array_equal(ref["p0"], p0)
    jloss, jpatch = float(ref["loss"]), ref["patch"]
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == rec["line"]
    assert line.startswith("dryrun_multichip(2): ok, 2-way cpu mesh, "
                           "2-img shards, loss=")
    assert (rec["platform"], rec["n"], rec["shard_rows"]) == ("cpu", 2, 2)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in (0, 1)]
    for r, res in enumerate(ranks):
        assert res["loss"] == pytest.approx(jloss, rel=1e-5), r
        np.testing.assert_allclose(res["patch"].numpy(), jpatch, rtol=1e-5,
                                   atol=0, err_msg=f"rank{r}")
    assert torch.equal(ranks[0]["patch"], ranks[1]["patch"])
    for k, v in ranks[0]["opt"].items():
        assert torch.equal(v, ranks[1]["opt"][k]), k
    assert rec["loss"] == ranks[0]["loss"]
    assert not np.array_equal(jpatch, p0)


def _views(n=2, batch=4):
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.random((batch, 8, 8, 3), np.float32))
    state = [torch.from_numpy(rng.random((4, 4, 3), np.float32)),
             torch.ones(4, 4, 3), torch.tensor(1.0)]
    k = batch // n
    views = [{"rows": (r * k, (r + 1) * k), "images": images[r * k:(r + 1) * k],
              "state": [t.clone() for t in state]} for r in range(n)]
    return views, images


def _replicated_batch(views, images):
    for v in views:
        v["rows"], v["images"] = (0, len(images)), images


def _replicated_rows(views, images):
    # the right row counts, but every rank holds the first rows
    for v in views:
        v["images"] = images[:len(v["images"])]


def _rows_out_of_order(views, images):
    views.reverse()


def _patch_differs(views, images):
    views[1]["state"][0][0, 0, 0] += 1e-7


def _opt_state_differs(views, images):
    views[1]["state"][2] = torch.tensor(2.0)


def _a_rank_missing(views, images):
    views.pop()


@pytest.mark.parametrize("spoil", [
    _replicated_batch, _replicated_rows, _rows_out_of_order, _patch_differs,
    _opt_state_differs, _a_rank_missing])
def test_assert_layouts_is_a_real_check(spoil):
    """``_assert_layouts`` passes the dryrun's layout and raises on a
    replicated batch (whole or as repeated rows), rows out of rank order,
    a patch or optimizer state that differs between ranks, or a missing
    rank."""
    views, images = _views()
    E._assert_layouts(views, 2, 4, images)
    spoil(views, images)
    with pytest.raises(AssertionError):
        E._assert_layouts(views, 2, 4, images)


def _user_env():
    """A user's environment: none of the JAX package's platform variables
    nor the dryrun's child sentinel, and no visible card."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", E._CHILD_SENTINEL)}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_dryrun_multichip_4_on_the_cpu_as_a_user_runs_it():
    """``python -m <port>.tools.entry 4 --device cpu`` exactly as a user
    runs it (a fresh interpreter, no conftest): 4 gloo ranks on the CPU,
    named in the line."""
    out = subprocess.run([sys.executable, "-m", f"{PORT}.tools.entry", "4",
                          "--device", "cpu"], cwd=ROOT, env=_user_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert re.fullmatch(r"dryrun_multichip\(4\): ok, 4-way cpu mesh, "
                        r"2-img shards, loss=\d+\.\d{4}",
                        out.stdout.strip().splitlines()[-1]), out.stdout


def test_dryrun_multichip_cli_defaults_to_the_card(monkeypatch, capsys):
    """``python -m <port>.tools.entry 2`` (``main(["2"])``) with no
    ``--device`` and no visible card raises and prints no line: it does
    not move to the CPU."""
    monkeypatch.delenv(E._CHILD_SENTINEL, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(E, "_launch", lambda *a: pytest.fail("launched"))
    with pytest.raises(RuntimeError, match="is_available"):
        E.main(["2"])
    assert "dryrun_multichip(2)" not in capsys.readouterr().out


def test_child_env_drops_the_launcher_and_jax_variables(monkeypatch):
    for k in PMESH.ENV + ("JAX_PLATFORMS", "XLA_FLAGS"):
        monkeypatch.setenv(k, "x")
    monkeypatch.setenv("KEEP_ME", "1")
    env = PMESH.child_env(EXTRA="2")
    assert not set(env) & set(PMESH.ENV + ("JAX_PLATFORMS", "XLA_FLAGS"))
    assert (env["KEEP_ME"], env["EXTRA"]) == ("1", "2")


# a process that runs ``run_ranks`` on one child, which writes its pid to
# argv[1] and sleeps
RUN_RANKS_PARENT = r"""
import sys
from {port}.parallel.mesh import child_env, run_ranks
run_ranks(("-c", "import os, sys, time; "
                 "open(sys.argv[1] + '.tmp', 'w').write(str(os.getpid())); "
                 "os.replace(sys.argv[1] + '.tmp', sys.argv[1]); "
                 "time.sleep(600)", sys.argv[1]), 1, child_env(), 600)
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_run_ranks_stops_its_children_on_sigterm(tmp_path):
    """A SIGTERM to a process waiting in ``run_ranks`` ends it, and its
    child with it: nothing it started holds on."""
    pid_file = tmp_path / "child.pid"
    parent = subprocess.Popen(
        [sys.executable, "-c", RUN_RANKS_PARENT.format(port=PORT),
         str(pid_file)], cwd=ROOT, env=_user_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while not pid_file.exists():
            assert parent.poll() is None, parent.communicate()[0][-3000:]
            assert time.monotonic() < deadline, "the child never started"
            time.sleep(0.1)
        child = int(pid_file.read_text())
        assert _alive(child)
        parent.send_signal(signal.SIGTERM)
        assert parent.wait(timeout=60) == 128 + signal.SIGTERM
        deadline = time.monotonic() + 30
        while _alive(child) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not _alive(child), f"child {child} outlived its parent"
    finally:
        parent.kill()
        parent.wait()
