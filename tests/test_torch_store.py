"""The port's device-resident epoch on the CPU: ``DeviceStore`` against the
JAX package's, the epoch program (``PatchTrainer.run_epoch_store``)
against the per-step path on the same batches, ``train_store`` with a
checkpoint and a resume, and the training CLI's file-backed loader and
``--device-store`` flag.

The victim is the tiny test network with params made by the JAX package
(``params_from_jax``), float32. On the CPU the store path is the per-step path
bit for bit (the same batch values, draws and ops), so the patches and the
single-step loss parts are held equal; the epoch means, averaged on the
host by numpy on one side and by torch on the other, keep the JAX
package's own store test's loss tolerance (rtol 2e-5,
``tests/test_train.py::test_store_epoch_matches_per_step_path``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.data import dataset as JD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu.models import darknet as JM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import models as PM
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.data import dataset as PD
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import config as PC
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.train import trainer as PT


@pytest.fixture(autouse=True)
def _grad_enabled():
    with torch.enable_grad():
        yield


def _exp(**kw):
    base = dict(name="tiny", img_size=64, patch_size=16, batch_size=4,
                max_labels=8, compute_dtype="float32", max_epochs=2,
                checkpoint_every=1)
    base.update(kw)
    return PC.ExperimentConfig(**base)


@pytest.fixture(scope="module")
def tiny():
    blocks = PM.tiny_test_blocks()
    jnet = JM.build_network(blocks)
    jparams = JM.fold_bn(jnet, JM.init_params(jnet, jax.random.PRNGKey(11)))
    return PM.build_network(blocks), PM.params_from_jax(jparams)


def _write_tiles(root, n, img_size=64):
    """``n`` random PNG tiles and their label files (every third empty),
    as the JAX package's store test writes them."""
    img_dir, lab_dir = root / "img", root / "lab"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir()
    rng = np.random.default_rng(42)
    for i in range(n):
        Image.fromarray(
            (rng.random((img_size, img_size, 3)) * 255).astype(np.uint8)
        ).save(img_dir / f"t{i}.png")
        (lab_dir / f"t{i}.txt").write_text(
            f"{i % 15} 0.5 0.5 0.3 0.3\n" if i % 3 else "")
    return str(img_dir), str(lab_dir)


def _dataset(root, n):
    return PD.DotaDataset(*_write_tiles(root, n), max_labels=8, img_size=64)


def _trainer(tiny, exp, seed, **kw):
    net, params = tiny
    return PT.PatchTrainer(exp, net, params, seed=seed, device="cpu",
                           log=lambda s: None, **kw)


def test_device_store_equals_jax_store(tmp_path):
    """The port's ``DeviceStore(device="cpu")`` holds the JAX package's
    ``DeviceStore`` arrays exactly, on the same 10 tile files."""
    img_dir, lab_dir = _write_tiles(tmp_path, 10)
    jstore = JD.DeviceStore(JD.DotaDataset(img_dir, lab_dir, max_labels=8,
                                           img_size=64), num_workers=2)
    pstore = PD.DeviceStore(PD.DotaDataset(img_dir, lab_dir, max_labels=8,
                                           img_size=64), device="cpu",
                            num_workers=2)
    assert pstore.images.dtype == torch.uint8
    assert pstore.images.device.type == "cpu"
    assert (pstore.n, len(pstore), pstore.img_size) == (10, 10, 64)
    np.testing.assert_array_equal(pstore.images.numpy(),
                                  np.asarray(jstore.images))
    np.testing.assert_array_equal(pstore.labels.numpy(),
                                  np.asarray(jstore.labels))
    assert pstore.labels.dtype == torch.float32


def test_device_store_refuses_missing_cuda(tmp_path, monkeypatch):
    """With no card, ``DeviceStore`` (default ``device="cuda"``) raises
    before it decodes a tile."""
    ds = _dataset(tmp_path, 2)
    decoded = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(ds, "__getitem__", lambda i: decoded.append(i))
    with pytest.raises(RuntimeError, match="cuda"):
        PD.DeviceStore(ds)
    assert not decoded


def test_store_epoch_matches_per_step_path(tmp_path, tiny):
    """Two epochs of ``run_epoch_store`` walk ``run_epoch``'s trajectory
    when the per-step path is fed the same ``epoch_plan`` rows (its final
    batch unpadded: it pads with the same tiling rule itself): 3 batches
    an epoch, the third partial, the same loss means, the same patch."""
    exp = _exp()
    ds = _dataset(tmp_path, 10)
    store = PD.DeviceStore(ds, device="cpu", num_workers=2)
    imgs, labs = (np.stack(a) for a in zip(*(ds[i] for i in range(10))))
    t_step = _trainer(tiny, exp, 3)
    t_store = _trainer(tiny, exp, 3)
    assert torch.equal(t_step.patch, t_store.patch)
    for epoch in range(2):
        idx, w = PD.epoch_plan(10, 4, epoch, seed=3)
        batches = [(imgs[r[m.astype(bool)]], labs[r[m.astype(bool)]])
                   for r, m in zip(idx, w)]
        s_step = t_step.run_epoch(batches, epoch)
        s_store = t_store.run_epoch_store(store, epoch)
        assert s_step["num_batches"] == s_store["num_batches"] == 3
        for k in PT.LOSS_KEYS:
            np.testing.assert_allclose(s_store[k], s_step[k], rtol=2e-5,
                                       atol=1e-7, err_msg=k)
    assert torch.equal(t_store.patch, t_step.patch)
    assert torch.equal(t_store.generator.get_state(),
                       t_step.generator.get_state())
    assert t_store.optimizer.state_dict()["state"][0]["step"] == 6


def test_epoch_fn_gathers_the_per_step_batch(tmp_path, tiny):
    """One step of the epoch program on a full batch equals one per-step
    ``PatchTrainer.step`` on the same rows: the store's uint8 rows divided
    by 255 are the loader's float32 batch bit for bit, and so are the
    loss parts and the updated patch."""
    exp = _exp()
    ds = _dataset(tmp_path, 6)
    store = PD.DeviceStore(ds, device="cpu", num_workers=2)
    rows = np.array([4, 1, 5, 2], np.int32)
    imgs, labs = (np.stack(a) for a in zip(*(ds[i] for i in rows)))
    got, got_labels = PT.store_batch(store.images, store.labels,
                                     torch.from_numpy(rows))
    assert torch.equal(got, torch.from_numpy(imgs))
    assert torch.equal(got_labels, torch.from_numpy(labs))
    a, b = _trainer(tiny, exp, 5), _trainer(tiny, exp, 5)
    aux = a.step(imgs, labs, np.ones(4, np.float32))
    epoch_fn = PT.make_epoch_scan_fn(b.model, exp)
    means = epoch_fn(b.patch, b.optimizer, b.generator, store.images,
                     store.labels, torch.from_numpy(rows)[None],
                     torch.ones(1, 4), a.scheduler.lr)
    assert list(means) == list(PT.LOSS_KEYS)
    for k in PT.LOSS_KEYS:
        assert torch.equal(means[k], aux[k]), k
    assert torch.equal(b.patch, a.patch)


def test_store_train_resume(tmp_path, tiny):
    """``train_store`` with checkpoints: a run stopped after two epochs and
    resumed from its checkpoint runs the third epoch as the uninterrupted
    run does (the plan is seeded by ``(seed, epoch)``; patch, optimizer,
    schedule and generator come back), and the JSONL log has every
    epoch."""
    exp = _exp(max_epochs=3)
    store = PD.DeviceStore(_dataset(tmp_path, 8), device="cpu",
                           num_workers=2)
    ck = str(tmp_path / "run")
    full = _trainer(tiny, exp, 9)
    full.train_store(store, epochs=3)
    t1 = _trainer(tiny, exp, 9, checkpoint_dir=ck)
    t1.train_store(store, epochs=2)
    t2 = _trainer(tiny, exp, 9, checkpoint_dir=ck)
    start = t2.restore_checkpoint() + 1
    assert start == 2
    assert torch.equal(t2.patch, t1.patch)
    patch, hist = t2.train_store(store, epochs=1, start_epoch=start)
    assert [h["epoch"] for h in hist] == [2]
    assert hist[0]["num_batches"] == 2
    assert np.isfinite(hist[0]["loss"])
    assert (patch >= 0).all() and (patch <= 1).all()
    np.testing.assert_array_equal(patch, full.patch_numpy())
    with open(os.path.join(ck, "train_log.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1, 2]
    assert os.path.exists(os.path.join(ck, "2_patch.png"))


def _cli(tmp_path, *extra):
    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.cli import train_patch
    cfg = tmp_path / "tiny.cfg"
    PM.write_darknet_cfg(PM.tiny_test_blocks(), str(cfg))
    img_dir, lab_dir = _write_tiles(tmp_path / "data", 5)
    return train_patch.main([
        "--cfgfile", str(cfg), "--img-size", "64", "--patch-size", "16",
        "--batch-size", "2", "--epochs", "1", "--img-dir", img_dir,
        "--lab-dir", lab_dir, "--num-workers", "2",
        "--out-dir", str(tmp_path / "run"), "--device", "cpu", *extra])


def test_train_cli_drops_the_partial_batch(tmp_path):
    """The file-backed loader drops the partial final batch, as the JAX
    package's CLI does (``drop_last=True``): 5 tiles at batch 2 are 2
    steps an epoch, not 3."""
    tr = _cli(tmp_path)
    assert tr.history[0]["num_batches"] == 2
    with open(tmp_path / "run" / "history.json") as f:
        assert json.load(f)[0]["num_batches"] == 2


def test_train_cli_device_store(tmp_path, capsys):
    """``--device-store`` trains over the whole store, the partial final
    batch padded (5 tiles at batch 2: 3 steps), and reports the store's
    size and the time it took to become resident."""
    tr = _cli(tmp_path, "--device-store")
    assert tr.history[0]["num_batches"] == 3
    assert np.isfinite(tr.history[0]["loss"])
    out = capsys.readouterr().out
    assert "device store:" in out and "resident in" in out
    assert os.path.exists(tmp_path / "run" / "final_patch.png")
