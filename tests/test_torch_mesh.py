"""The port's data parallelism (``parallel/mesh.py``, ``mesh=`` on the
trainer) on the CPU: two ``gloo`` processes, started as
``tests/test_distributed.py`` starts its workers, train on a global batch
of 4 with weights ``[1, 1, 1, 0]`` (rank 0 holds two real rows, rank 1
one real row and the padding), for each recipe whose batch means differ
(``creation_colorful``, and ``det_creation`` and ``clsconf_creation``,
which also gather a per-sample detection score):

- two ``PatchTrainer`` steps and one store epoch (7 tiles: the second
  batch is padded the same way); each rank's loss parts and patch equal
  the one-process run's within 1e-6 (the gradient is summed in another
  order), and the two ranks' patches equal each other bit for bit;
- one step of ``make_train_step(mesh=)`` fed the JAX step's draws (its
  EOT key's, rebuilt as ``tests/test_torch_train.py`` does) on the padded
  batch: each rank's global loss parts, summed gradient and updated patch
  against the JAX package's one-process step, at
  ``tests/test_torch_train.py``'s tolerances (loss parts rtol 1e-5, the
  gradient 1e-4 relative L2, the patch 1e-5 where the gradient is not
  tiny).

The victim is the tiny test network with params made by the JAX package
(``params_from_jax``), float32. Also the mesh helpers' semantics, in both
processes and without a process group."""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data.assets import load_printable_colors
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import darknet as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import config as JC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import trainer as JT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.parallel import mesh as PMesh

from test_torch_eot import jax_draws, synthetic_labels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")

RECIPES = ("creation_colorful", "det_creation", "clsconf_creation")
EXP = dict(name="tiny", img_size=64, patch_size=16, batch_size=4,
           max_labels=8, compute_dtype="float32", max_epochs=1)
LR = 0.03
DRAWS = ("contrast", "brightness", "noise", "ux", "uy", "angle")

# the runs both sides make: run(mesh) and jax_step(mesh) on each rank,
# run(None) in one process
SCENARIO = r"""
import numpy as np
import torch
from PORT import models as PM
from PORT.attack import eot as PE
from PORT.data import dataset as PD
from PORT.parallel import mesh as PMesh
from PORT.train import config as PC
from PORT.train import optim as PO
from PORT.train import trainer as PT


def _exp(recipe):
    return PC.ExperimentConfig(loss_recipe=recipe, **EXP)


def run(mesh, params_path, data_dir, recipe):
    params = torch.load(params_path, weights_only=True)
    net = PM.build_network(PM.tiny_test_blocks())
    exp = _exp(recipe)
    tr = PT.PatchTrainer(exp, net, params, seed=3, device="cpu",
                         log=lambda s: None, mesh=mesh)
    ds = PD.DotaDataset(data_dir + "/img", data_dir + "/lab", max_labels=8,
                        img_size=64)
    imgs, labs = (np.stack(a) for a in zip(*(ds[i] for i in range(7))))
    w = np.array([1, 1, 1, 0], np.float32)
    out = {}
    with torch.enable_grad():
        for i in range(2):
            aux = tr.step(imgs[i:i + 4], labs[i:i + 4], w)
            out[f"step{i}"] = np.array([float(aux[k]) for k in PT.LOSS_KEYS])
        out["patch_steps"] = tr.patch_numpy()
        stats = tr.run_epoch_store(PD.DeviceStore(ds, device="cpu",
                                                  num_workers=2), 0)
    out["store"] = np.array([stats[k] for k in PT.LOSS_KEYS])
    out["store_batches"] = np.array(stats["num_batches"])
    out["patch_store"] = tr.patch_numpy()
    return out


def jax_step(mesh, params_path, ref_path, recipe):
    # one step of make_train_step(mesh=) on this rank's rows of the JAX
    # step's batch, weights and draws: the loss parts, the summed
    # gradient and the updated patch
    params = torch.load(params_path, weights_only=True)
    net = PM.build_network(PM.tiny_test_blocks())
    model = PM.Darknet(net, params, torch.float32, device="cpu")
    step = PT.make_train_step(model, _exp(recipe), mesh=mesh)
    ref = np.load(ref_path)
    rows = PMesh.batch_sharding(mesh, len(ref["weights"]))
    draws = PE.EOTDraws(**{k: torch.from_numpy(ref["draw_" + k])
                           for k in DRAWS})
    patch = torch.from_numpy(ref["p0"].copy()).requires_grad_(True)
    opt = PO.make_optimizer(patch, LR)
    aux = step(patch, opt, torch.from_numpy(ref["images"][rows]),
               torch.from_numpy(ref["labels"][rows]), LR,
               PT.local_draws(draws, rows),
               torch.from_numpy(ref["weights"][rows]))
    return {"jax_aux": np.array([float(aux[k]) for k in PT.LOSS_KEYS]),
            "jax_grad": patch.grad.numpy().copy(),
            "jax_patch": patch.detach().numpy().copy()}
""".replace("PORT", PORT)
SCENARIO = f"EXP = {EXP!r}\nLR = {LR!r}\nDRAWS = {DRAWS!r}\n" + SCENARIO

WORKER = SCENARIO + r"""
import os
import sys

import torch.distributed as dist
from PORT.parallel import mesh as PMesh

rank = int(os.environ["RANK"])
params_path, data_dir, out_dir = sys.argv[1:4]
assert PMesh.init_distributed("cpu")
assert dist.get_backend() == "gloo"
mesh = PMesh.make_mesh_for_batch(4, "cpu")
assert (mesh.size, mesh.rank, mesh.device.type) == (2, rank, "cpu")
# this rank's contiguous rows, as tensors on the mesh's device
a = np.arange(16, dtype=np.float32).reshape(8, 2)
b = np.arange(8, dtype=np.float32)
sa, sb = PMesh.shard_batch(mesh, a, b)
assert torch.equal(sa, torch.from_numpy(a[4 * rank:4 * rank + 4]))
assert torch.equal(sb, torch.from_numpy(b[4 * rank:4 * rank + 4]))
assert torch.equal(PMesh.shard_batch(mesh, a), sa)
assert PMesh.batch_sharding(mesh, 6) == slice(3 * rank, 3 * rank + 3)
t = torch.full((3,), float(rank + 1))
assert PMesh.replicated(mesh, t) is t and torch.equal(t, torch.ones(3))
assert torch.equal(PMesh.all_reduce_sum(mesh, torch.ones(2)),
                   torch.full((2,), 2.0))
# a batch of 3 splits over one rank: rank 1 is left out
m3 = PMesh.make_mesh_for_batch(3, "cpu")
assert m3.size == 1 and m3.member == (rank == 0) and not m3.distributed
for recipe in RECIPES:
    out = run(mesh, params_path, data_dir, recipe)
    out.update(jax_step(mesh, params_path,
                        os.path.join(out_dir, f"jax_{recipe}.npz"), recipe))
    np.savez(os.path.join(out_dir, f"rank{rank}_{recipe}.npz"), **out)
dist.destroy_process_group()
print(f"rank{rank} ok", flush=True)
""".replace("PORT", PORT).replace("RECIPES", repr(RECIPES))


def _write_tiles(root, n):
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(42)
    for i in range(n):
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)
                        ).save(img_dir / f"t{i}.png")
        (lab_dir / f"t{i}.txt").write_text(
            f"{i % 15} 0.5 0.5 0.3 0.3\n" if i % 3 else "")


def _jax_step(jnet, jparams, recipe, path):
    """The JAX package's one-process step on a padded global batch of 4
    (the fourth row repeats the first with weight 0): its inputs and the
    draws rebuilt from its EOT key go to ``path`` for the ranks; returns
    its loss parts, gradient and updated patch."""
    jexp = JC.ExperimentConfig(loss_recipe=recipe, **EXP)
    rng = np.random.default_rng(5)
    p0 = rng.random((16, 16, 3), dtype=np.float32)
    images = rng.random((3, 64, 64, 3), dtype=np.float32)
    labels = synthetic_labels(rng, 3, max_labels=8)
    images = np.concatenate([images, images[:1]])
    labels = np.concatenate([labels, labels[:1]])
    weights = np.array([1, 1, 1, 0], np.float32)
    ji, jl, jw = (jnp.asarray(a) for a in (images, labels, weights))
    state = JT.init_train_state(jexp, jax.random.PRNGKey(3),
                                patch=jnp.asarray(p0))
    sub = jax.random.split(state.key)[1]
    new_state, jaux = JT.make_train_step(jnet, jexp)(
        state, jparams, ji, jl, jnp.float32(LR), jw)
    jloss = JT.make_loss_fn(jnet, jexp, load_printable_colors())
    jgrad = np.asarray(jax.grad(lambda p: jloss(
        p, jparams, ji, jl, jw, sub)[0])(jnp.asarray(p0)))
    draws = jax_draws(sub, 4, 16, JE.EOTConfig(img_size=64))
    np.savez(path, p0=p0, images=images, labels=labels, weights=weights,
             **{f"draw_{k}": getattr(draws, k).numpy() for k in DRAWS})
    return {"aux": np.array([float(jaux[k]) for k in JT.LOSS_KEYS]),
            "grad": jgrad, "patch": np.asarray(new_state.patch)}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The scenario on two gloo ranks, in one process, and the JAX step:
    {recipe: (per-rank outputs, one-process outputs, the JAX step)}."""
    tmp = tmp_path_factory.mktemp("mesh")
    blocks = PM.tiny_test_blocks()
    jnet = JM.build_network(blocks)
    jparams = JM.fold_bn(jnet, JM.init_params(jnet, jax.random.PRNGKey(11)))
    params_path = str(tmp / "params.pt")
    torch.save(PM.params_from_jax(jparams), params_path)
    _write_tiles(tmp / "data", 7)
    jax_ref = {r: _jax_step(jnet, jparams, r, tmp / f"jax_{r}.npz")
               for r in RECIPES}
    script = tmp / "worker.py"
    script.write_text(WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, str(script), params_path, str(tmp / "data"),
         str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)})
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank{r} failed:\n{out[-3000:]}"
        assert f"rank{r} ok" in out, out[-1500:]
    ns = {}
    exec(SCENARIO, ns)
    return {recipe: ([dict(np.load(tmp / f"rank{r}_{recipe}.npz"))
                      for r in (0, 1)],
                     ns["run"](None, params_path, str(tmp / "data"), recipe),
                     jax_ref[recipe])
            for recipe in RECIPES}


@pytest.mark.parametrize("key", ["step0", "step1", "patch_steps", "store",
                                 "patch_store"])
@pytest.mark.parametrize("recipe", RECIPES)
def test_two_ranks_equal_one_process(two_ranks, recipe, key):
    """Each rank's loss parts (global values) and patch equal the
    one-process run's, after the steps and after the store epoch."""
    ranks, ref, _ = two_ranks[recipe]
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[key], ref[key], rtol=0, atol=1e-6,
                                   err_msg=f"rank{r} {key}")


@pytest.mark.parametrize("recipe", RECIPES)
def test_two_ranks_hold_one_patch(two_ranks, recipe):
    """The ranks' patches equal each other bit for bit (the summed
    gradient and the update are the same on both), and the store epoch
    ran the padded plan's 2 batches."""
    ranks, ref, _ = two_ranks[recipe]
    for key in ("patch_steps", "patch_store", "jax_patch"):
        np.testing.assert_array_equal(ranks[0][key], ranks[1][key])
    assert int(ranks[0]["store_batches"]) == int(ref["store_batches"]) == 2
    assert not np.array_equal(ref["patch_steps"], ref["patch_store"])


@pytest.mark.parametrize("recipe", RECIPES)
def test_two_ranks_match_the_jax_step(two_ranks, recipe):
    """Each rank's step on its rows of the JAX step's padded batch and
    draws gives the JAX package's one-process step: the global loss parts
    (the det score's mean too, for the det recipes), the gradient summed
    over the ranks, and the updated patch."""
    ranks, _, jref = two_ranks[recipe]
    big = np.abs(jref["grad"]) > 1e-3 * np.abs(jref["grad"]).max()
    assert big.mean() > 0.5
    if recipe != "creation_colorful":
        assert jref["aux"][list(JT.LOSS_KEYS).index("det")] > 0
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out["jax_aux"], jref["aux"], rtol=1e-5,
                                   atol=1e-7, err_msg=f"rank{r}")
        rel = (np.linalg.norm(out["jax_grad"] - jref["grad"])
               / np.linalg.norm(jref["grad"]))
        assert rel <= 1e-4, (r, rel)
        got = out["jax_patch"]
        assert got.min() >= 0.0 and got.max() <= 1.0
        np.testing.assert_allclose(got[big], jref["patch"][big], rtol=0,
                                   atol=1e-5, err_msg=f"rank{r}")


def test_mesh_without_a_process_group(monkeypatch):
    """Without the launcher's variables ``init_distributed`` does nothing
    and returns False; the meshes are then one process on the device
    asked for, and the helpers pass arrays through whole."""
    for k in PMesh.ENV:
        monkeypatch.delenv(k, raising=False)
    assert not PMesh.init_distributed("cpu")
    assert not torch.distributed.is_initialized()
    mesh = PMesh.make_mesh_for_batch(3, "cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.member and not mesh.distributed
    assert mesh == PMesh.make_mesh("cpu")
    a = np.ones((8, 4), np.float32)
    b = np.zeros((8,), np.float32)
    sa, sb = PMesh.shard_batch(mesh, a, b)
    assert sa.shape == (8, 4) and sb.shape == (8,)
    assert PMesh.shard_batch(mesh, a).shape == (8, 4)
    t = torch.arange(3.0)
    assert PMesh.replicated(mesh, t) is t
    assert torch.equal(PMesh.all_reduce_sum(mesh, t), torch.arange(3.0))
    with pytest.raises(ValueError, match="split"):
        PMesh.batch_sharding(PMesh.Mesh(None, 2, 0, mesh.device), 5)


def test_mesh_refuses_missing_cuda(monkeypatch):
    """The default device is the card: with none visible, a mesh and the
    launcher's group on ``"cuda"`` raise instead of taking the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        PMesh.make_mesh()
    for k, v in zip(PMesh.ENV, ("0", "1", "0", "127.0.0.1", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="cuda"):
        PMesh.init_distributed()
    assert not torch.distributed.is_initialized()
