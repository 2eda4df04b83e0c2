"""The port's patch-training step against the JAX package's, at float32
on the CPU, and its trainer's host logic.

One whole step of ``paper_obj`` on the full-width YOLOv3 at 64^2 (batch 2,
patch 24): EOT from draws rebuilt from the JAX step's key, the victim with
its stem on the fused route (the plain K1 with masks and the plain K2 here)
against the JAX package's XLA conv walk, the losses, the gradient w.r.t.
the patch alone and the amsgrad update with its clip.

Tolerances: loss parts rtol 1e-5 (float32 sums in other orders over 75
convs); the patch gradient relative L2 1e-4; the updated patch 1e-5 where
the gradient is not tiny (the first amsgrad step moves each pixel by
about lr * sign(g), so a pixel whose gradient is ~0 may move either way on
the two sides)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.attack import eot as JE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data.assets import load_printable_colors
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import flops as JF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import config as JC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.train import trainer as JT
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.attack import eot as PE
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data import SyntheticData
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import flops as PF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.ops import stem_fused as SF
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import config as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import optim as PO
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import trainer as PT

from test_torch_eot import jax_draws, synthetic_labels


@pytest.fixture(autouse=True)
def _grad_enabled():
    """Autograd on for every test here, whatever grad mode an earlier
    test in the same process left behind."""
    with torch.enable_grad():
        yield

KEYS = ("loss", "nps", "tv", "no_obj", "no_cls", "colorful", "det")
IMG, PATCH = 64, 24


def _exp(cfg, **kw):
    kw = {"img_size": IMG, "patch_size": PATCH, "batch_size": 2,
          "compute_dtype": "float32", **kw}
    return cfg.get_experiment("paper_obj", **kw)


def _victim(blocks, seed=1):
    net = PM.build_network(blocks)
    jnet = JT.darknet.build_network(blocks)
    jparams = JT.darknet.fold_bn(
        jnet, JT.darknet.init_params(jnet, jax.random.PRNGKey(seed)))
    model = PM.Darknet(net, PM.params_from_jax(jparams), torch.float32,
                       device="cpu")
    return jnet, jparams, model


def _batch(rng, b):
    images = rng.random((b, IMG, IMG, 3), dtype=np.float32)
    labels = synthetic_labels(rng, b)
    return images, labels


@pytest.fixture(scope="module")
def yolov3():
    return _victim(PM.yolov3_blocks(width=IMG, height=IMG))


@pytest.fixture(scope="module")
def jax_steps(yolov3):
    """The JAX step per ``padded``, computed once: (inputs, the JAX step's
    loss parts and updated patch, jax.grad of the loss w.r.t. the patch,
    and the port's draws rebuilt from the step's EOT key)."""
    jnet, jparams, _ = yolov3
    cache = {}

    def get(padded):
        if padded in cache:
            return cache[padded]
        jexp = _exp(JC)
        rng = np.random.default_rng(0)
        p0 = rng.random((PATCH, PATCH, 3), dtype=np.float32)
        images, labels = _batch(rng, 2)
        weights = None
        if padded:
            # a third sample repeats the first with weight 0
            images = np.concatenate([images, images[:1]])
            labels = np.concatenate([labels, labels[:1]])
            weights = np.array([1, 1, 0], np.float32)
        b = images.shape[0]
        jw = None if weights is None else jnp.asarray(weights)
        # JAX: one jitted step; its EOT key is the first split of the
        # state's
        state = JT.init_train_state(jexp, jax.random.PRNGKey(3),
                                    patch=jnp.asarray(p0))
        sub = jax.random.split(state.key)[1]
        jstep = JT.make_train_step(jnet, jexp)
        new_state, jaux = jstep(state, jparams, jnp.asarray(images),
                                jnp.asarray(labels), jnp.float32(0.03), jw)
        jloss = JT.make_loss_fn(jnet, jexp, load_printable_colors())
        jgrad = np.asarray(jax.grad(lambda p: jloss(
            p, jparams, jnp.asarray(images), jnp.asarray(labels), jw,
            sub)[0])(jnp.asarray(p0)))
        draws = jax_draws(sub, b, PATCH, JE.EOTConfig(img_size=IMG))
        cache[padded] = dict(p0=p0, images=images, labels=labels,
                             weights=weights, jaux=jaux,
                             patch=np.asarray(new_state.patch), jgrad=jgrad,
                             draws=draws)
        return cache[padded]
    return get


def _check_against_jax(ref, paux, pgrad, patch):
    for k in KEYS:
        np.testing.assert_allclose(float(paux[k]), float(ref["jaux"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    jgrad = ref["jgrad"]
    rel = np.linalg.norm(pgrad - jgrad) / np.linalg.norm(jgrad)
    assert rel <= 1e-4, rel
    got = patch.detach().numpy()
    assert got.min() >= 0.0 and got.max() <= 1.0
    big = np.abs(jgrad) > 1e-3 * np.abs(jgrad).max()
    assert big.mean() > 0.5
    np.testing.assert_allclose(got[big], ref["patch"][big], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("padded", [False, True])
def test_train_step_matches_jax(yolov3, jax_steps, padded):
    _, _, model = yolov3
    pexp = _exp(PC)
    ref = jax_steps(padded)
    images, labels = ref["images"], ref["labels"]
    pw = (None if ref["weights"] is None
          else torch.from_numpy(ref["weights"]))

    # the port, fed the same draws
    draws = ref["draws"]
    patch = torch.from_numpy(ref["p0"].copy()).requires_grad_(True)
    opt = PO.make_optimizer(patch, 0.03)
    n = (SF.fused_stem_fwd.launches, SF.fused_stem_fwd.save_acts_launches)
    loss_fn = PT.make_loss_fn(model, pexp)
    total, _ = loss_fn(patch, torch.from_numpy(images),
                       torch.from_numpy(labels), pw, draws)
    assert PM.last_routes()["stem"] == "fused"
    # plain versions on the CPU
    assert (SF.fused_stem_fwd.launches,
            SF.fused_stem_fwd.save_acts_launches) == n
    pgrad = torch.autograd.grad(total, patch)[0].numpy()
    step = PT.make_train_step(model, pexp)
    paux = step(patch, opt, torch.from_numpy(images),
                torch.from_numpy(labels), 0.03, draws, pw)
    _check_against_jax(ref, paux, pgrad, patch)


def _check_trainer_route(yolov3, jax_steps, routes, **kw):
    """One ``PatchTrainer`` step on the route ``kw`` (its step function,
    fed the JAX step's draws) against the JAX step on the XLA walk."""
    jnet, jparams, _ = yolov3
    ref = jax_steps(False)
    pexp = _exp(PC)
    tr = PT.PatchTrainer(pexp, PM.build_network(PM.yolov3_blocks(
        width=IMG, height=IMG)), PM.params_from_jax(jparams), device="cpu",
        log=lambda s: None, **kw)
    with torch.no_grad():
        tr.patch.copy_(torch.from_numpy(ref["p0"]))
    images, labels = (torch.from_numpy(ref[k]) for k in ("images", "labels"))
    loss_fn = PT.make_loss_fn(tr.model, pexp, **kw)
    total, _ = loss_fn(tr.patch, images, labels, None, ref["draws"])
    pgrad = torch.autograd.grad(total, tr.patch)[0].numpy()
    paux = tr.step_fn(tr.patch, tr.optimizer, images, labels, 0.03,
                      ref["draws"])
    assert tuple(PM.last_routes().values()) == routes
    _check_against_jax(ref, paux, pgrad, tr.patch)


@pytest.mark.parametrize("fused_stem,planar_stem,res152,routes", [
    (True, False, "fused", ("fused", "fused")),
    (False, True, "planar", ("planar", "planar"))])
def test_patch_trainer_kernel_routes_match_jax(yolov3, jax_steps, fused_stem,
                                               planar_stem, res152, routes):
    """One ``PatchTrainer`` step (its step function, fed the JAX step's
    draws) with the 152^2 stage on its kernel routes (the plain versions
    here) against the JAX step on the XLA walk: the same loss parts,
    patch gradient and update as the fused-stem route."""
    _check_trainer_route(yolov3, jax_steps, routes, fused_stem=fused_stem,
                         planar_stem=planar_stem, res152=res152)


@pytest.mark.parametrize("stem_remat,res152,routes", [
    (True, None, ("fused", "conv")), (False, "c12", ("c12", "c12"))])
def test_patch_trainer_remat_and_c12_routes_match_jax(yolov3, jax_steps,
                                                      stem_remat, res152,
                                                      routes):
    """One ``PatchTrainer`` step on the recomputing stem backward (K5) and
    on the conv12-widened route (K6c), the plain versions here, against
    the JAX step on the XLA walk, as the other kernel routes."""
    _check_trainer_route(yolov3, jax_steps, routes, res152=res152,
                         stem_remat=stem_remat)


def test_padded_batch_changes_nothing(yolov3):
    """Zero-weight padding rows leave the loss parts and the gradient as
    the unpadded batch's (the port alone, on the fused route)."""
    _, _, model = yolov3
    exp = _exp(PC)
    rng = np.random.default_rng(1)
    p0 = rng.random((PATCH, PATCH, 3), dtype=np.float32)
    images, labels = _batch(rng, 2)
    draws3 = PE.draw_eot(torch.Generator().manual_seed(0), 3, PATCH,
                         PT.eot_config(exp))
    draws2 = PE.EOTDraws(**{k: v[:2] for k, v in vars(draws3).items()})
    loss_fn = PT.make_loss_fn(model, exp)
    out = []
    for imgs, labs, w, d in (
            (images, labels, None, draws2),
            (np.concatenate([images, images[1:]]),
             np.concatenate([labels, labels[1:]]),
             torch.tensor([1.0, 1.0, 0.0]), draws3)):
        patch = torch.from_numpy(p0.copy()).requires_grad_(True)
        total, aux = loss_fn(patch, torch.from_numpy(imgs),
                             torch.from_numpy(labs), w, d)
        out.append(({k: float(v) for k, v in aux.items()},
                    torch.autograd.grad(total, patch)[0].numpy()))
    (a2, g2), (a3, g3) = out
    for k in KEYS:
        np.testing.assert_allclose(a3[k], a2[k], rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    assert np.linalg.norm(g3 - g2) <= 1e-6 * np.linalg.norm(g2)


@pytest.fixture(scope="module")
def tiny():
    return _victim(PM.tiny_test_blocks())


@pytest.mark.parametrize("recipe", PC.LOSS_RECIPES)
def test_every_recipe_matches_jax(tiny, recipe):
    """Every loss recipe's parts and total, forward, on the tiny victim
    (its stem takes the conv route on both sides)."""
    jnet, jparams, model = tiny
    jexp = _exp(JC, loss_recipe=recipe, loss_target="obj*cls")
    pexp = _exp(PC, loss_recipe=recipe, loss_target="obj*cls")
    rng = np.random.default_rng(2)
    p0 = rng.random((PATCH, PATCH, 3), dtype=np.float32)
    images, labels = _batch(rng, 2)
    key = jax.random.PRNGKey(5)
    _, jaux = JT.make_loss_fn(jnet, jexp, load_printable_colors())(
        jnp.asarray(p0), jparams, jnp.asarray(images), jnp.asarray(labels),
        None, key)
    draws = jax_draws(key, 2, PATCH, JE.EOTConfig(img_size=IMG))
    with torch.no_grad():
        _, paux = PT.make_loss_fn(model, pexp)(
            torch.from_numpy(p0), torch.from_numpy(images),
            torch.from_numpy(labels), None, draws)
    for k in KEYS:
        np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_trainer_epoch_log_checkpoint_and_resume(tiny, tmp_path):
    """A padded final batch, the JSONL log, and a checkpoint whose restore
    brings back the patch, optimizer, schedule, generator and epoch: the
    resumed trainer's next epoch equals the uninterrupted one's."""
    jnet, jparams, _ = tiny
    exp = _exp(PC, batch_size=3, checkpoint_every=1)
    net = PM.build_network(PM.tiny_test_blocks())
    params = PM.params_from_jax(jparams)
    data = SyntheticData(5, IMG, exp.max_labels)

    def batches(epoch):
        # 5 samples in batches of 3: the second is padded
        return [data.batch(3, 10 * epoch), data.batch(2, 10 * epoch + 1)]

    def trainer(d):
        return PT.PatchTrainer(exp, net, params, seed=4, checkpoint_dir=d,
                               log=lambda s: None, device="cpu")

    a = trainer(str(tmp_path / "a"))
    a.train(batches, epochs=1)
    assert a.history[0]["num_batches"] == 2
    b = trainer(str(tmp_path / "a"))
    assert not torch.equal(b.patch, a.patch)
    assert b.restore_checkpoint() == 0
    assert torch.equal(b.patch, a.patch)
    assert torch.equal(b.generator.get_state(), a.generator.get_state())
    assert b.scheduler.state_dict() == a.scheduler.state_dict()
    a.train(batches, epochs=1, start_epoch=1)
    b.train(batches, epochs=1, start_epoch=1)
    assert torch.equal(b.patch, a.patch)
    st_a, st_b = a.optimizer.state_dict(), b.optimizer.state_dict()
    for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq", "step"):
        assert torch.equal(st_a["state"][0][k], st_b["state"][0][k]), k
    with open(tmp_path / "a" / "train_log.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1, 1]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert os.path.exists(tmp_path / "a" / "1_patch.png")


def test_train_cli_runs_on_the_cpu_when_asked(tmp_path):
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.cli import train_patch
    cfg = tmp_path / "tiny.cfg"
    PM.write_darknet_cfg(PM.tiny_test_blocks(), str(cfg))
    out = tmp_path / "run"
    tr = train_patch.main(["--cfgfile", str(cfg), "--img-size", "64",
                           "--patch-size", "16", "--batch-size", "2",
                           "--epochs", "1", "--synthetic", "3",
                           "--out-dir", str(out), "--device", "cpu"])
    assert tr.device.type == "cpu" and len(tr.history) == 1
    assert os.path.exists(out / "final_patch.png")
    tr = train_patch.main(["--cfgfile", str(cfg), "--img-size", "64",
                           "--patch-size", "16", "--batch-size", "2",
                           "--epochs", "2", "--synthetic", "3", "--resume",
                           "--out-dir", str(out), "--device", "cpu"])
    assert [h["epoch"] for h in tr.history] == [1]


@pytest.mark.parametrize("size", [64, 608])
def test_train_step_flops_match_jax(size):
    blocks = PM.yolov3_blocks(width=size, height=size)
    assert PF.train_step_flops_per_image(PM.build_network(blocks)) == \
        JF.train_step_flops_per_image(JT.darknet.build_network(blocks))
    assert PF.peak_flops_bf16("NVIDIA H100 80GB HBM3") == 989e12
    assert PF.peak_flops_bf16("NVIDIA H100 PCIe") is None


def test_patch_png_and_mse_match_jax(tmp_path):
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.utils import checkpoint as JCK
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.utils import checkpoint as PCK
    rng = np.random.default_rng(6)
    a, b = (rng.random((12, 12, 3), dtype=np.float32) for _ in range(2))
    PCK.save_patch_png(torch.from_numpy(a), str(tmp_path / "pa.png"))
    PCK.save_patch_png(b, str(tmp_path / "pb.png"))
    JCK.save_patch_png(a, str(tmp_path / "ja.png"))
    JCK.save_patch_png(b, str(tmp_path / "jb.png"))
    np.testing.assert_array_equal(PCK.load_patch_png(str(tmp_path / "pa.png")),
                                  JCK.load_patch_png(str(tmp_path / "ja.png")))
    assert PCK.load_patch_png(str(tmp_path / "pa.png"), 6).shape == (6, 6, 3)
    assert PCK.patch_png_mse(str(tmp_path / "pa.png"),
                             str(tmp_path / "pb.png")) == \
        JCK.patch_png_mse(str(tmp_path / "ja.png"), str(tmp_path / "jb.png"))


def test_train_step_differentiates_under_no_grad(tiny):
    """A caller's ``torch.no_grad()`` does not stop the step: the patch
    moves exactly as it does with grad enabled."""
    _, _, model = tiny
    exp = _exp(PC)
    rng = np.random.default_rng(7)
    p0 = rng.random((PATCH, PATCH, 3), dtype=np.float32)
    images, labels = (torch.from_numpy(a) for a in _batch(rng, 2))
    draws = PE.draw_eot(torch.Generator().manual_seed(1), 2, PATCH,
                        PT.eot_config(exp))
    step = PT.make_train_step(model, exp)
    out = []
    for grad_mode in (True, False):
        patch = torch.from_numpy(p0.copy()).requires_grad_(True)
        opt = PO.make_optimizer(patch, 0.03)
        with torch.set_grad_enabled(grad_mode):
            step(patch, opt, images, labels, 0.03, draws)
        out.append(patch.detach().clone())
    assert not torch.equal(out[0], torch.from_numpy(p0))
    assert torch.equal(out[0], out[1])
