"""Patch-optimization trainer (the JAX package's ``train/trainer.py``).

One training step, as the reference's loop body:

    draws  = draw_eot(generator, ...)                  # the EOT's randomness
    loss   = total_loss(patch, images, labels, draws)  # EOT -> detector -> losses
    grad   = d loss / d patch                          # input-only backward
    patch <- clip(amsgrad(patch, grad, lr), 0, 1)

The victim runs in the compute dtype (bfloat16 by default) with its stem
on the fused kernels (``Darknet(fused_stem=True)``: K1 with saved masks
forward, K2 backward on a card, their plain versions on the CPU); its
weights are buffers, so autograd differentiates the patch alone. The other
kernel routes are options, off by default as in the JAX package:
``planar_stem`` (the per-layer planar stem, tried after the fused one),
``res152`` ("fused" or "planar": layers 6-11 after a kernel stem; "c12":
layers 0-12 on the planar-out stem and the conv12-widened unit, K6c) and
``stem_remat`` (the fused stem's backward recomputes its masks, K5,
instead of keeping them across the step). Host-side
epoch logic (plateau LR schedule, JSONL log, checkpoints) mirrors the JAX
package's; a padded final batch carries zero weights, so its loss and
gradient equal the unpadded batch's.

Two data paths, as in the JAX package: ``train`` steps through host
batches (numpy from ``BatchLoader``, copied to the card each step), and
``train_store`` runs each epoch over a ``data.DeviceStore`` through the
epoch program (``make_epoch_scan_fn``): the batches are gathered on the
card and the only host traffic is the ~10 KB plan and one fetch of the
seven loss means an epoch.

``mesh=`` (``parallel.mesh``, one process per card) makes the step data
parallel with the single-process semantics over the global batch: every
rank draws the global batch's EOT draws and keeps its rows, the batch
means run over the gathered per-sample values (global weight sum), the
patch-only terms count once (on rank 0), and the patch gradient is
summed over the ranks before the update, so every rank holds the same
patch. Without a mesh, or with one of size 1, nothing of this runs.

``PatchTrainer(device=)`` defaults to ``"cuda"`` and raises where there is
no card; the CPU is taken only when asked for.

Each step runs under the spans of ``utils/profiling.py`` (``span``), which
record only while a profiler is on: ``train.step``, and inside it
``train.inputs`` (``store_batch`` and ``draw_eot``, or the host -> card
copy of ``PatchTrainer.step``), ``train.eot`` (``apply_eot_patch``),
``train.victim_fwd``, ``train.loss`` (``extract_cell_scores`` through
the total), ``train.backward`` and ``train.update`` (the gradient's
all-reduce, amsgrad and the clip; ``zero_grad(set_to_none=True)``, which
launches nothing, stays first in the step, outside it, so that the
patch's gradient outlives the step). While a profiler is on,
``make_loss_fn`` also hooks the EOT composite (``cut``), so that the
records split ``train.backward`` where the gradient reaches the victim's
input: ``train.victim_bwd`` before, ``train.eot_bwd`` after. The
patch-only terms (nps, tv, colorfulness) are built after the victim, so
autograd runs their few small kernels first, inside ``train.victim_bwd``.
With no profiler on, no hook is registered and each span is one flag
read.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..attack.eot import EOTConfig, EOTDraws, apply_eot_patch, draw_eot
from ..attack.losses import (
    colorfulness, creation_cls_ce_loss, creation_obj_loss,
    extract_cell_scores, max_combined_prob, max_prob_extract, nps_loss,
    total_variation, weighted_mean,
)
from ..data.assets import load_printable_colors
from ..data.dataset import epoch_plan
from ..models import darknet
from ..models.darknet_cfg import yolov3_blocks
from ..models.weights import load_darknet_weights
from ..ops import _cuda
from ..parallel.mesh import (Mesh, all_reduce_sum, batch_sharding,
                             gather_rows, replicated)
from ..utils.profiling import cut, recording, span
from .config import ExperimentConfig, combine_loss_target
from .optim import amsgrad_step, make_optimizer

LOSS_KEYS = ("loss", "nps", "tv", "no_obj", "no_cls", "colorful", "det")


class ReduceLROnPlateau:
    """Host-side plateau LR schedule with torch semantics (mode='min',
    factor=0.1, patience=50, rel threshold 1e-4)."""

    def __init__(self, lr: float, factor: float = 0.1, patience: int = 50,
                 threshold: float = 1e-4, min_lr: float = 0.0):
        self.lr = lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> Dict[str, float]:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: Dict[str, float]) -> None:
        self.lr = float(d["lr"])
        self.best = float(d["best"])
        self.num_bad = int(d["num_bad"])


def compute_dtype(exp: ExperimentConfig) -> torch.dtype:
    return torch.bfloat16 if exp.compute_dtype == "bfloat16" else torch.float32


def eot_config(exp: ExperimentConfig) -> EOTConfig:
    warp_dtype = (exp.compute_dtype if exp.warp_dtype == "compute"
                  else exp.warp_dtype)
    return EOTConfig(img_size=exp.img_size, scale_factor=exp.scale_factor,
                     do_rotate=exp.do_rotate, photometric=exp.photometric,
                     warp_method=exp.warp_method,
                     warp_dtype=(None if warp_dtype == "float32"
                                 else warp_dtype))


def init_patch(exp: ExperimentConfig, generator: torch.Generator,
               kind: str = "random") -> torch.Tensor:
    """'random' U(0,1) or 'gray' 0.5 start, float32 on the generator's
    device."""
    shape = (exp.patch_size, exp.patch_size, 3)
    if kind == "gray":
        return torch.full(shape, 0.5, device=generator.device)
    return torch.rand(shape, generator=generator, device=generator.device)


def build_victim(exp: ExperimentConfig, seed: int = 1
                 ) -> Tuple[darknet.Network, darknet.Params]:
    """Victim detector: from cfgfile or the built-in yolov3-dota spec;
    weights from a darknet file or random init from ``seed``; BN folded."""
    if exp.cfgfile:
        net = darknet.network_from_cfg(exp.cfgfile)
    else:
        net = darknet.build_network(yolov3_blocks(
            num_classes=exp.num_classes, width=exp.img_size,
            height=exp.img_size))
    if exp.weightfile:
        params, _ = load_darknet_weights(net, exp.weightfile)
    else:
        params = darknet.init_params(net, seed)
    return net, darknet.fold_bn(net, params)


def make_loss_fn(model: darknet.Darknet, exp: ExperimentConfig,
                 printable_colors: Optional[np.ndarray] = None,
                 fused_stem: bool = True, planar_stem: bool = False,
                 res152: Optional[str] = None,
                 stem_remat: bool = False, mesh: Optional[Mesh] = None
                 ) -> Callable:
    """``loss_fn(patch, images, labels, weights, draws) -> (total, aux)``
    for the recipe ``exp.loss_recipe``; ``aux`` holds the LOSS_KEYS. The
    route flags go to the victim's forward (``Darknet.forward``). With a
    distributed ``mesh`` the inputs are this rank's rows, and ``total``
    and ``aux`` are the global batch's (module docstring)."""
    if printable_colors is None:
        printable_colors = load_printable_colors()
    cfg = eot_config(exp)
    combiner = combine_loss_target(exp.loss_target)
    dev = next(model.buffers()).device
    colors = torch.as_tensor(printable_colors, dtype=torch.float32,
                             device=dev)
    recipe = exp.loss_recipe
    with_det = recipe in ("det_creation", "clsconf_creation")
    distributed = mesh is not None and mesh.distributed

    def loss_fn(patch, images, labels, weights, draws):
        with span("train.eot"):
            patched, centers = apply_eot_patch(patch, images, labels,
                                               draws, cfg)
        if recording() and patched.requires_grad:
            patched.register_hook(cut)
        with span("train.victim_fwd"):
            heads = model(patched, fused_stem=fused_stem,
                          planar_stem=planar_stem, res152=res152,
                          stem_remat=stem_remat)
        with span("train.loss"):
            return losses(patch, heads, centers, weights)

    def losses(patch, heads, centers, weights):
        cell_obj, cell_cls = extract_cell_scores(
            heads, centers, exp.img_size, exp.num_classes,
            swap_xy=exp.cell_swap_xy)
        det_sample = None
        if recipe == "det_creation":
            det_sample = max_combined_prob(
                heads, exp.target_id, combiner, exp.num_classes,
                sigmoid_mode=True)
        elif recipe == "clsconf_creation":
            _, det_sample = max_prob_extract(
                heads, exp.target_id, exp.num_classes, sigmoid_mode=True)
        if distributed:
            # the batch means over the global batch; the patch-only
            # terms differentiate on rank 0 alone
            if weights is None:
                weights = torch.ones(cell_obj.shape[0], device=dev)
            parts = (cell_obj, cell_cls, weights) + (
                (det_sample,) if with_det else ())
            cell_obj, cell_cls, weights, *rest = gather_rows(mesh, *parts)
            det_sample = rest[0] if with_det else None
            if mesh.rank != 0:
                patch = patch.detach()
        no_obj = creation_obj_loss(cell_obj, weights)
        no_cls = creation_cls_ce_loss(cell_cls, exp.target_id, weights)
        nps = nps_loss(patch, colors) * exp.nps_factor
        tv = total_variation(patch) * exp.tv_factor
        tv_floored = torch.clamp(tv, min=exp.tv_floor)
        colorful = colorfulness(patch)
        det = torch.zeros((), device=patch.device)

        if recipe == "creation_colorful":
            total = nps + tv_floored + no_obj + colorful + no_cls
        elif recipe == "creation_ce":
            total = nps + tv_floored + no_obj + no_cls
        elif recipe == "untargeted_obj":
            total = nps + tv_floored + no_obj
        elif with_det:
            det = weighted_mean(det_sample, weights)
            total = det + nps + tv_floored + no_obj + no_cls
        else:
            raise ValueError(f"unknown loss recipe {recipe!r}")

        aux = {"loss": total, "nps": nps, "tv": tv, "no_obj": no_obj,
               "no_cls": no_cls, "colorful": colorful, "det": det}
        return total, aux

    return loss_fn


def make_train_step(model: darknet.Darknet, exp: ExperimentConfig,
                    printable_colors: Optional[np.ndarray] = None,
                    fused_stem: bool = True, planar_stem: bool = False,
                    res152: Optional[str] = None,
                    stem_remat: bool = False,
                    mesh: Optional[Mesh] = None) -> Callable:
    """``step(patch, optimizer, images, labels, lr, draws, weights=None)
    -> aux``: the gradient of the loss w.r.t. the patch alone, the
    amsgrad update at ``lr``, the clip to [0, 1] (in place on ``patch``).
    ``weights`` [B] (1 real / 0 padding) makes a padded batch exact. With
    a distributed ``mesh`` the batch, weights and draws are this rank's
    rows and the gradient is summed over the ranks before the update."""
    loss_fn = make_loss_fn(model, exp, printable_colors, fused_stem,
                           planar_stem, res152, stem_remat, mesh=mesh)
    distributed = mesh is not None and mesh.distributed

    def step(patch, optimizer, images, labels, lr, draws, weights=None):
        optimizer.zero_grad(set_to_none=True)
        # the step differentiates whatever grad mode its caller is in
        with torch.enable_grad():
            total, aux = loss_fn(patch, images, labels, weights, draws)
            with span("train.backward",
                      split=("train.victim_bwd", "train.eot_bwd")):
                total.backward()
        with span("train.update"):
            if distributed:
                all_reduce_sum(mesh, patch.grad)
            amsgrad_step(optimizer, patch, lr)
        return {k: v.detach() for k, v in aux.items()}

    return step


def local_draws(draws: EOTDraws, rows: slice) -> EOTDraws:
    """The rows ``rows`` of every draw of a batch."""
    return EOTDraws(**{k: v[rows] for k, v in vars(draws).items()})


def store_batch(store_images: torch.Tensor, store_labels: torch.Tensor,
                ib: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows ``ib`` of a device store, gathered on its device: uint8
    images become float32 by a true division by 255, as the loader's
    numpy division (a Python scalar divisor would make CUDA multiply by
    its reciprocal, an ulp off), so the batch equals the loader's bit for
    bit."""
    images = torch.index_select(store_images, 0, ib)
    if images.dtype == torch.uint8:
        images = images.float() / torch.full((), 255.0,
                                             device=images.device)
    return images, torch.index_select(store_labels, 0, ib)


def make_epoch_scan_fn(model: darknet.Darknet, exp: ExperimentConfig,
                       printable_colors: Optional[np.ndarray] = None,
                       fused_stem: bool = True, planar_stem: bool = False,
                       res152: Optional[str] = None,
                       stem_remat: bool = False,
                       mesh: Optional[Mesh] = None) -> Callable:
    """The whole-epoch program over a device-resident trainset
    (``data.DeviceStore``):

        ``epoch_fn(patch, optimizer, generator, store_images,
                   store_labels, idx [K, B], weights [K, B], lr) -> means``

    A loop over the K rows of the plan (``data.epoch_plan``, on the
    device), each step with no host sync: the batch gathered from the
    store on the device (uint8 -> float32 / 255), the step's EOT draws
    from ``generator`` in the per-step path's order, then the same loss,
    backward through the patch alone, amsgrad update at ``lr`` and clip
    as ``make_train_step``. So on the same batch content it walks the
    per-step path's trajectory. ``means`` are the loss parts (LOSS_KEYS)
    averaged over the K steps, as device scalars. With a distributed
    ``mesh`` every rank holds the whole store and takes its columns of
    ``idx``."""
    step = make_train_step(model, exp, printable_colors, fused_stem,
                           planar_stem, res152, stem_remat, mesh=mesh)
    cfg = eot_config(exp)
    distributed = mesh is not None and mesh.distributed

    def epoch_fn(patch, optimizer, generator, store_images, store_labels,
                 idx, weights, lr):
        b = idx.shape[1]
        rows = batch_sharding(mesh, b) if distributed else slice(None)
        aux = []
        for ib, wb in zip(idx[:, rows], weights[:, rows]):
            with span("train.step"):
                with span("train.inputs"):
                    images, labels = store_batch(store_images,
                                                 store_labels, ib)
                    draws = draw_eot(generator, b, exp.patch_size, cfg)
                aux.append(step(patch, optimizer, images, labels, lr,
                                local_draws(draws, rows), wb))
        stacked = torch.stack([torch.stack([a[k] for k in LOSS_KEYS])
                               for a in aux])
        return dict(zip(LOSS_KEYS, stacked.mean(dim=0)))

    return epoch_fn


class PatchTrainer:
    """End-to-end patch optimization on one device, or data parallel on
    one card per process with ``mesh=``.

        trainer = PatchTrainer(get_experiment("paper_obj"))
        patch, history = trainer.train(make_batches)
        patch, history = trainer.train_store(DeviceStore(dataset))

    ``fused_stem``, ``planar_stem``, ``res152`` and ``stem_remat`` pick
    the victim's kernel routes (``make_train_step``). With a mesh the
    trainer runs on the mesh's device, takes global batches and keeps its
    rank's rows of each; every rank is seeded alike, so their patches,
    optimizer states and EOT generators stay equal, and only rank 0
    writes the log and the checkpoints.
    """

    def __init__(self, exp: ExperimentConfig,
                 net: Optional[darknet.Network] = None,
                 params: Optional[darknet.Params] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 log: Callable[[str], None] = print, device="cuda",
                 fused_stem: bool = True, planar_stem: bool = False,
                 res152: Optional[str] = None, stem_remat: bool = False,
                 mesh: Optional[Mesh] = None):
        self.device = _cuda.resolve_device(device)
        if mesh is None:
            mesh = Mesh.single(self.device)
        else:
            if not mesh.member:
                raise ValueError("this process is not a rank of the mesh")
            if mesh.device.type != self.device.type:
                raise ValueError(f"device {device!r} is not the mesh's "
                                 f"{mesh.device}")
            self.device = mesh.device
        self.mesh = mesh
        self.exp = exp
        if exp.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        if net is None or params is None:
            net, params = build_victim(exp, seed + 1)
        self.net = net
        self.model = darknet.Darknet(net, params, compute_dtype(exp),
                                     device=self.device).eval()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.patch = init_patch(exp, self.generator).requires_grad_(True)
        replicated(mesh, self.patch.data)
        self.optimizer = make_optimizer(self.patch, exp.learning_rate)
        self.scheduler = ReduceLROnPlateau(
            exp.learning_rate, factor=exp.plateau_factor,
            patience=exp.plateau_patience)
        self.routes = dict(fused_stem=fused_stem, planar_stem=planar_stem,
                           res152=res152, stem_remat=stem_remat)
        self.step_fn = make_train_step(self.model, exp, mesh=mesh,
                                       **self.routes)
        self._epoch_fn: Optional[Callable] = None
        self.eot_cfg = eot_config(exp)
        self.checkpoint_dir = checkpoint_dir
        self.log = log
        self.seed = seed
        self.history: List[Dict[str, float]] = []

    @property
    def is_main(self) -> bool:
        """Rank 0 of the mesh (the one process without one)."""
        return self.mesh.rank == 0

    def _to_device(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype, non_blocking=True)

    def step(self, images, labels, weights=None) -> Dict[str, torch.Tensor]:
        """One training step on a (global) batch, numpy or tensors;
        returns the loss parts as device scalars (no host sync)."""
        b = images.shape[0]
        with span("train.step"):
            with span("train.inputs"):
                draws = draw_eot(self.generator, b, self.exp.patch_size,
                                 self.eot_cfg)
                if self.mesh.distributed:
                    rows = batch_sharding(self.mesh, b)
                    images, labels, draws = (images[rows], labels[rows],
                                             local_draws(draws, rows))
                    if weights is not None:
                        weights = weights[rows]
                images = self._to_device(images)
                labels = self._to_device(labels)
                if weights is not None:
                    weights = self._to_device(weights)
            return self.step_fn(self.patch, self.optimizer, images, labels,
                                self.scheduler.lr, draws, weights)

    # -- single epoch ------------------------------------------------------

    def run_epoch(self, batches: Iterable, epoch: int) -> Dict[str, float]:
        aux_log: List[Dict[str, torch.Tensor]] = []
        t0 = time.time()
        for images, labels in batches:
            weights = None
            n_real = images.shape[0]
            if n_real < self.exp.batch_size:
                # pad the final batch by tiling real samples; zero
                # weights make its loss and gradient the unpadded batch's
                target = self.exp.batch_size
                fill = np.arange(target - n_real) % n_real
                images = np.concatenate([images, images[fill]])
                labels = np.concatenate([labels, labels[fill]])
                weights = np.concatenate(
                    [np.ones(n_real, np.float32),
                     np.zeros(target - n_real, np.float32)])
            aux_log.append(self.step(images, labels, weights))
        if aux_log:
            # one device->host transfer for the epoch's loss parts
            stacked = torch.stack([torch.stack([a[k] for k in LOSS_KEYS])
                                   for a in aux_log]).float().cpu().numpy()
            means = stacked.mean(axis=0)
            stats = {k: float(means[i]) for i, k in enumerate(LOSS_KEYS)}
        else:
            stats = {k: 0.0 for k in LOSS_KEYS}
        stats["epoch_time"] = time.time() - t0
        stats["epoch"] = epoch
        stats["num_batches"] = max(len(aux_log), 1)
        return stats

    # -- device-store epoch ------------------------------------------------

    def run_epoch_store(self, store, epoch: int,
                        drop_last: bool = False) -> Dict[str, float]:
        """One epoch over a ``data.DeviceStore`` through the epoch
        program: the plan (``epoch_plan``, seeded by ``(seed, epoch)``)
        goes to the device once, the steps run with no host sync, and the
        seven loss means come back in one fetch."""
        if self._epoch_fn is None:
            self._epoch_fn = make_epoch_scan_fn(self.model, self.exp,
                                                mesh=self.mesh,
                                                **self.routes)
        idx, weights = epoch_plan(store.n, self.exp.batch_size, epoch,
                                  seed=self.seed, drop_last=drop_last)
        t0 = time.time()
        means = self._epoch_fn(
            self.patch, self.optimizer, self.generator, store.images,
            store.labels, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(weights).to(self.device), self.scheduler.lr)
        vals = torch.stack(list(means.values())).cpu().tolist()
        stats = dict(zip(means, vals))
        stats["epoch_time"] = time.time() - t0
        stats["epoch"] = epoch
        stats["num_batches"] = int(idx.shape[0])
        return stats

    # -- full training -----------------------------------------------------

    def train(self, make_batches: Callable[[int], Iterable],
              epochs: Optional[int] = None,
              start_epoch: int = 0) -> Tuple[np.ndarray, List[Dict]]:
        """``make_batches(epoch)`` yields (images, labels) numpy batches.
        ``start_epoch`` offsets epoch labels/checkpoints after a resume."""
        return self._fit(lambda epoch: self.run_epoch(make_batches(epoch),
                                                      epoch),
                         epochs, start_epoch)

    def train_store(self, store, epochs: Optional[int] = None,
                    start_epoch: int = 0, drop_last: bool = False
                    ) -> Tuple[np.ndarray, List[Dict]]:
        """``train()`` over a ``data.DeviceStore``: the same epoch loop
        (plateau schedule, JSONL log, checkpoints), each epoch through
        ``run_epoch_store``."""
        return self._fit(lambda epoch: self.run_epoch_store(store, epoch,
                                                            drop_last),
                         epochs, start_epoch)

    def _fit(self, run: Callable[[int], Dict[str, float]],
             epochs: Optional[int], start_epoch: int
             ) -> Tuple[np.ndarray, List[Dict]]:
        epochs = epochs if epochs is not None else self.exp.max_epochs
        for epoch in range(start_epoch, start_epoch + epochs):
            stats = run(epoch)
            self.scheduler.step(stats["loss"])
            stats["lr"] = self.scheduler.lr
            self.history.append(stats)
            if not self.is_main:
                continue
            self._log_jsonl(stats)
            self.log(
                f"epoch {epoch}: loss {stats['loss']:.4f} "
                f"(no_obj {stats['no_obj']:.4f} no_cls {stats['no_cls']:.4f} "
                f"tv {stats['tv']:.4f} nps {stats['nps']:.2e} "
                f"colorful {stats['colorful']:.4f}) "
                f"lr {stats['lr']:.4g} time {stats['epoch_time']:.1f}s")
            if (self.checkpoint_dir
                    and epoch % self.exp.checkpoint_every == 0):
                self.save_checkpoint(epoch)
        return self.patch_numpy(), self.history

    def patch_numpy(self) -> np.ndarray:
        """A copy of the patch (on the CPU ``.numpy()`` would alias the
        live patch, which later steps move)."""
        return self.patch.detach().cpu().numpy().copy()

    def _log_jsonl(self, stats: Dict[str, float]) -> None:
        """Append epoch stats to <checkpoint_dir>/train_log.jsonl."""
        if not self.checkpoint_dir:
            return
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        with open(os.path.join(self.checkpoint_dir,
                               "train_log.jsonl"), "a") as f:
            f.write(json.dumps(stats) + "\n")

    # -- checkpointing -----------------------------------------------------

    CHECKPOINT = "ckpt.pt"

    def save_checkpoint(self, epoch: int) -> None:
        from ..utils.checkpoint import (patch_png_mse, save_checkpoint,
                                        save_patch_png)
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        png = os.path.join(self.checkpoint_dir, f"{epoch}_patch.png")
        save_patch_png(self.patch, png)
        save_checkpoint(
            os.path.join(self.checkpoint_dir, self.CHECKPOINT),
            {"patch": self.patch, "optimizer": self.optimizer.state_dict(),
             "scheduler": self.scheduler.state_dict(),
             "generator": self.generator.get_state(), "epoch": epoch})
        prev = os.path.join(self.checkpoint_dir,
                            f"{epoch - self.exp.checkpoint_every}_patch.png")
        if epoch > 0 and os.path.exists(prev):
            self.log(f"adjacent-patch MSE: {patch_png_mse(prev, png):.3e}")

    def restore_checkpoint(self) -> int:
        """Bring back patch, optimizer, scheduler, generator state; returns
        the checkpoint's epoch."""
        from ..utils.checkpoint import load_checkpoint
        ck = load_checkpoint(os.path.join(self.checkpoint_dir,
                                          self.CHECKPOINT))
        with torch.no_grad():
            self.patch.copy_(ck["patch"].to(self.device))
        self.optimizer.load_state_dict(ck["optimizer"])
        self.scheduler.load_state_dict(ck["scheduler"])
        self.generator.set_state(ck["generator"])
        return int(ck["epoch"])
