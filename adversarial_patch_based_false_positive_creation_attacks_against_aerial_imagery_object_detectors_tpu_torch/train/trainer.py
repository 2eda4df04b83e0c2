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
``planar_stem`` (the per-layer planar stem, tried after the fused one) and
``res152`` ("fused" or "planar": layers 6-11 after a kernel stem). Host-side
epoch logic (plateau LR schedule, JSONL log, checkpoints) mirrors the JAX
package's; a padded final batch carries zero weights, so its loss and
gradient equal the unpadded batch's.

``PatchTrainer(device=)`` defaults to ``"cuda"`` and raises where there is
no card; the CPU is taken only when asked for.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..attack.eot import EOTConfig, apply_eot_patch, draw_eot
from ..attack.losses import (
    colorfulness, creation_cls_ce_loss, creation_obj_loss,
    extract_cell_scores, max_combined_prob, max_prob_extract, nps_loss,
    total_variation, weighted_mean,
)
from ..data.assets import load_printable_colors
from ..models import darknet
from ..models.darknet_cfg import yolov3_blocks
from ..models.weights import load_darknet_weights
from ..ops import _cuda
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
                 res152: Optional[str] = None) -> Callable:
    """``loss_fn(patch, images, labels, weights, draws) -> (total, aux)``
    for the recipe ``exp.loss_recipe``; ``aux`` holds the LOSS_KEYS. The
    route flags go to the victim's forward (``Darknet.forward``)."""
    if printable_colors is None:
        printable_colors = load_printable_colors()
    cfg = eot_config(exp)
    combiner = combine_loss_target(exp.loss_target)
    dev = next(model.buffers()).device
    colors = torch.as_tensor(printable_colors, dtype=torch.float32,
                             device=dev)

    def loss_fn(patch, images, labels, weights, draws):
        patched, centers = apply_eot_patch(patch, images, labels, draws,
                                           cfg)
        heads = model(patched, fused_stem=fused_stem,
                      planar_stem=planar_stem, res152=res152)
        cell_obj, cell_cls = extract_cell_scores(
            heads, centers, exp.img_size, exp.num_classes,
            swap_xy=exp.cell_swap_xy)
        no_obj = creation_obj_loss(cell_obj, weights)
        no_cls = creation_cls_ce_loss(cell_cls, exp.target_id, weights)
        nps = nps_loss(patch, colors) * exp.nps_factor
        tv = total_variation(patch) * exp.tv_factor
        tv_floored = torch.clamp(tv, min=exp.tv_floor)
        colorful = colorfulness(patch)
        det = torch.zeros((), device=patch.device)

        recipe = exp.loss_recipe
        if recipe == "creation_colorful":
            total = nps + tv_floored + no_obj + colorful + no_cls
        elif recipe == "creation_ce":
            total = nps + tv_floored + no_obj + no_cls
        elif recipe == "untargeted_obj":
            total = nps + tv_floored + no_obj
        elif recipe == "det_creation":
            det = weighted_mean(max_combined_prob(
                heads, exp.target_id, combiner, exp.num_classes,
                sigmoid_mode=True), weights)
            total = det + nps + tv_floored + no_obj + no_cls
        elif recipe == "clsconf_creation":
            _, max_cls = max_prob_extract(
                heads, exp.target_id, exp.num_classes, sigmoid_mode=True)
            det = weighted_mean(max_cls, weights)
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
                    res152: Optional[str] = None) -> Callable:
    """``step(patch, optimizer, images, labels, lr, draws, weights=None)
    -> aux``: the gradient of the loss w.r.t. the patch alone, the
    amsgrad update at ``lr``, the clip to [0, 1] (in place on ``patch``).
    ``weights`` [B] (1 real / 0 padding) makes a padded batch exact."""
    loss_fn = make_loss_fn(model, exp, printable_colors, fused_stem,
                           planar_stem, res152)

    def step(patch, optimizer, images, labels, lr, draws, weights=None):
        optimizer.zero_grad(set_to_none=True)
        # the step differentiates whatever grad mode its caller is in
        with torch.enable_grad():
            total, aux = loss_fn(patch, images, labels, weights, draws)
            total.backward()
        amsgrad_step(optimizer, patch, lr)
        return {k: v.detach() for k, v in aux.items()}

    return step


class PatchTrainer:
    """End-to-end patch optimization on one device.

        trainer = PatchTrainer(get_experiment("paper_obj"))
        patch, history = trainer.train(make_batches)

    ``fused_stem``, ``planar_stem`` and ``res152`` pick the victim's
    kernel routes (``make_train_step``).
    """

    def __init__(self, exp: ExperimentConfig,
                 net: Optional[darknet.Network] = None,
                 params: Optional[darknet.Params] = None, seed: int = 0,
                 checkpoint_dir: Optional[str] = None,
                 log: Callable[[str], None] = print, device="cuda",
                 fused_stem: bool = True, planar_stem: bool = False,
                 res152: Optional[str] = None):
        self.device = _cuda.resolve_device(device)
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
        self.optimizer = make_optimizer(self.patch, exp.learning_rate)
        self.scheduler = ReduceLROnPlateau(
            exp.learning_rate, factor=exp.plateau_factor,
            patience=exp.plateau_patience)
        self.step_fn = make_train_step(self.model, exp,
                                       fused_stem=fused_stem,
                                       planar_stem=planar_stem,
                                       res152=res152)
        self.eot_cfg = eot_config(exp)
        self.checkpoint_dir = checkpoint_dir
        self.log = log
        self.seed = seed
        self.history: List[Dict[str, float]] = []

    def _to_device(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device, dtype, non_blocking=True)

    def step(self, images, labels, weights=None) -> Dict[str, torch.Tensor]:
        """One training step on a batch (numpy or tensors); returns the
        loss parts as device scalars (no host sync)."""
        images = self._to_device(images)
        labels = self._to_device(labels)
        if weights is not None:
            weights = self._to_device(weights)
        draws = draw_eot(self.generator, images.shape[0],
                         self.exp.patch_size, self.eot_cfg)
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

    # -- full training -----------------------------------------------------

    def train(self, make_batches: Callable[[int], Iterable],
              epochs: Optional[int] = None,
              start_epoch: int = 0) -> Tuple[np.ndarray, List[Dict]]:
        """``make_batches(epoch)`` yields (images, labels) numpy batches.
        ``start_epoch`` offsets epoch labels/checkpoints after a resume."""
        epochs = epochs if epochs is not None else self.exp.max_epochs
        for epoch in range(start_epoch, start_epoch + epochs):
            stats = self.run_epoch(make_batches(epoch), epoch)
            self.scheduler.step(stats["loss"])
            stats["lr"] = self.scheduler.lr
            self.history.append(stats)
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
        return self.patch.detach().cpu().numpy()

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
