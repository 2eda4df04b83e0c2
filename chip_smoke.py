#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Build the kernels of ``<port>/csrc`` (one nvcc per source, in
   parallel) and print the build time and the ``-Xptxas -v`` lines.
2. Hold each kernel of the serving path against its plain PyTorch
   version on the card at the serving shapes (batch 8, 608^2, bfloat16;
   the fused stem also in float32) and time kernel, plain version and,
   where one exists, a single PyTorch call computing the same function.
3. Serve: the full-width YOLOv3 (75 convs, 608^2, 15 classes, random
   weights from a seed) as a bfloat16 Detector on the card, driven
   through a DetectionService (16 requests from 4 threads) and its HTTP
   handler (2 PNG posts); every kernel must have launched there. Then
   the heads through the kernels are held against the same model with
   the plain stem, and throughput and request latency are measured over
   2,048 requests from 8 threads (several seconds of service).
4. Goldens: the reference's own detections for the mini (320^2) and
   slim (608^2, 75 convs) victims, at conf 0.4 and 0.2, must match the
   port's float32 Detector on the card 1-1 within 1e-3.
5. Training kernels at the training shapes (batch 24, 608^2, bfloat16):
   K1 with ``save_acts`` (y5 and the int8 sign masks), K2 on the same
   masks (also float32) and K3a at the cotangent g5's shape (both of its
   variants), each against its plain version and timed as in phase 2.
6. Training (the second main path; counted launches): the training CLI
   in-process, ``paper_obj`` on the full-width YOLOv3 with random weights
   over 48 synthetic tiles (one epoch of 2 steps at batch 24), then warm-up
   and 20 timed steps of its ``PatchTrainer`` on device-resident batches
   (ms/step by CUDA events, steps/min, mfu, peak memory), the same steps
   with the stem on the cuDNN conv walk for comparison, and patch-
   gradient checks at batch 4: float32 kernels against the float32 conv
   walk (TF32 off) through the stem alone, and through the whole victim
   against the walk carrying the kernels' own y5 forward (both at 1e-4
   relative L2); bfloat16 kernels against the bfloat16 plain-stem route,
   within twice that route's own distance from float32.

The last two lines are the kernels JSON object and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed before them. Exits non-zero, printing no result, without a card
or without the port beside this script.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
JAX_PKG = PORT[:-len("_torch")]
SEED = 0
BATCH, SIZE = 8, 608
TRAIN_BATCH, PATCH, TIMED_STEPS = 24, 224, 20
# the kernels each main path must launch (entry names of the kernels line)
SERVE_PATH = ("to_planar", "fused_stem_fwd", "from_planar")
TRAIN_PATH = ("to_planar", "fused_stem_fwd_save_acts", "from_planar",
              "to_planar_g5", "fused_stem_bwd_saved")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def image_bytes(t, w: int, c: int) -> int:
    """Bytes of a planar [B, H, C', Wl] tensor's first ``c`` channels at
    its ``w`` image lanes: what a kernel must read of an input (its border
    and padding lanes and padding channels are known zeros). Outputs count
    whole (``nbytes``): the layout needs their zero lanes written."""
    return t.shape[0] * t.shape[1] * c * w * t.element_size()


def counters() -> dict:
    """Every kernel's launch count: entry name -> (wrapper, attribute).
    Each wrapper adds one to the attribute where it launches that kernel,
    and nowhere else."""
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    return {"to_planar": (PC.to_planar, "launches"),
            "to_planar_g5": (PC.to_planar, "tiled_launches"),
            "fused_stem_fwd": (SF.fused_stem_fwd, "launches"),
            "fused_stem_fwd_save_acts": (SF.fused_stem_fwd,
                                         "save_acts_launches"),
            "from_planar": (PC.from_planar, "launches"),
            "fused_stem_bwd_saved": (SF.fused_stem_bwd_saved, "launches")}


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stem_flops(b: int, h: int) -> float:
    """Multiply-adds x 2 of stem convs 0,1,2,3,5 on their real outputs."""
    h1, h5 = h // 2, h // 4
    macs = (h * h * 32 * 27 + h1 * h1 * 64 * 288 + h1 * h1 * 32 * 64
            + h1 * h1 * 64 * 288 + h5 * h5 * 128 * 576)
    return 2.0 * b * macs


def match_count(ours, ref, atol=1e-3) -> int:
    """Greedy 1-1 matching of 7-column rows within atol."""
    ours = np.asarray(ours, np.float32).reshape(-1, 7)
    ref = np.asarray(ref, np.float32).reshape(-1, 7)
    if len(ref) == 0 or len(ours) == 0:
        return 0
    used = np.zeros(len(ref), bool)
    matched = 0
    for row in ours:
        d = np.abs(ref - row).max(axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= atol:
            used[j] = True
            matched += 1
    return matched


def import_port(name: str):
    import importlib
    return importlib.import_module(f"{PORT}.{name}")


def k2_read_bytes(acts, g5p) -> int:
    """K2's input bytes: the masks, y5 and g5 at their image lanes and
    real channels."""
    y5, *masks = acts
    h1, h5 = masks[0].shape[1] // 2, y5.shape[1]
    return (sum(image_bytes(m, h1, m.shape[2]) for m in masks)
            + image_bytes(y5, h5, 128) + image_bytes(g5p, h5, 128))


def training_kernels(dev, sp, sbp, card) -> list:
    """Phase 5: K1 save_acts, K2 and K3a (g5) against their plain versions
    at batch 24, 608^2, bfloat16 (K2 also float32); returns their entries
    of the kernels line (launches filled in by the training phase)."""
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    _cuda = import_port("ops._cuda")
    bf16 = torch.bfloat16
    b, h, h1, h5 = TRAIN_BATCH, SIZE, SIZE // 2, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    x = torch.rand(b, h, h, 3, generator=gen, device=dev).to(bf16)
    xe, xo = SF.split_phases(x)
    wlh, wl5 = xe.shape[-1], 256
    out = []

    # K1 with save_acts: dirty the blocks its outputs will reuse first
    torch.full((b, h5, 128, wl5), float("nan"), dtype=bf16, device=dev)
    for rows, c in ((h, 32), (h, 32), (h1, 64), (h1, 32), (h1, 64)):
        torch.full((b, rows, c, wlh), 7, dtype=torch.int8, device=dev)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    torch.cuda.synchronize()
    want = SF.fused_stem_fwd_plain(xe, xo, sp, save_acts=True)
    y5 = acts[0]
    assert torch.equal(y5, SF.fused_stem_fwd(xe, xo, sp)), \
        "save_acts changed y5"
    scale = want[0].float().abs().max().item()
    e = (y5.float() - want[0].float()).abs()
    err, mean_err = e.max().item(), e.mean().item()
    tol = 2.0 ** -6 * scale
    assert err <= tol and mean_err <= 1e-4 * scale, (err, mean_err, scale)
    # masks: the same gates but for sign flips of |pre-activation| ~ 0
    # (summation order), and every border and padding lane zero
    n_mask = sum(m.numel() for m in acts[1:])
    flips = [int((g != w).sum().item()) for g, w in zip(acts[1:], want[1:])]
    assert sum(flips) <= 1e-5 * n_mask, (flips, n_mask)
    for m in acts[1:]:
        assert not m[..., 0].any() and not m[..., h1 + 1:].any()
    b_ms, b_by = bound(2 * image_bytes(xe, h1, 3) + nbytes(*acts),
                       stem_flops(b, h), bf16)
    out.append({
        "name": "fused_stem_fwd_save_acts", "route": "cuda",
        "source": f"{PORT}/csrc/stem_fused.cu",
        "replaces": f"{JAX_PKG}/ops/stem_fused.py:645",
        "launches": 0, "max_abs_err": err, "tol": tol,
        "mean_abs_err": mean_err, "mask_flips": flips,
        "mask_elements": n_mask, "shape": list(xe.shape),
        "dtype": "bfloat16",
        "ms": time_ms(lambda: SF.fused_stem_fwd(xe, xo, sp, save_acts=True),
                      5),
        "plain_ms": time_ms(lambda: SF.fused_stem_fwd_plain(
            xe, xo, sp, save_acts=True), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    del want

    # K3a at the cotangent's shape: the tiled transpose (the wrapper's
    # choice for C >= 32) and the one-thread-per-element variant
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
    g5p = PC.to_planar(g5)
    plain = PC.to_planar_plain(g5)
    assert torch.equal(g5p, plain), "to_planar (g5) differs"
    assert torch.equal(PC._to_planar_launch(g5, None, 1, 0, False), plain)
    b_ms, b_by = bound(nbytes(g5, g5p), 0.0, bf16)
    view = g5.permute(0, 1, 3, 2)
    out.append({
        "name": "to_planar_g5", "route": "cuda",
        "source": f"{PORT}/csrc/planar.cu",
        "replaces": f"{JAX_PKG}/ops/planar_conv.py:124",
        "launches": 0, "max_abs_err": 0.0, "tol": 0.0,
        "shape": list(g5.shape), "dtype": "bfloat16",
        "ms": time_ms(lambda: PC.to_planar(g5)),
        "ms_per_element_variant": time_ms(
            lambda: PC._to_planar_launch(g5, None, 1, 0, False)),
        "plain_ms": time_ms(lambda: PC.to_planar_plain(g5)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.nn.functional.pad(
            view, (1, wl5 - h5 - 1)))})
    del plain

    # K2 on the kernel's own masks: the plain version reads the same
    # gates, so only summation order (and the bf16 roundings it flips)
    # separates them: two bf16 ulps of the output scale
    torch.full((b, h, 8, wlh), float("nan"), dtype=bf16, device=dev)
    got = SF.fused_stem_bwd_saved(acts, g5p, sbp)
    torch.cuda.synchronize()
    want = SF.fused_stem_bwd_saved_plain(acts, g5p, sbp)
    errs, means, tols = [], [], []
    for gk, wk in zip(got, want):
        scale = wk.float().abs().max().item()
        e = (gk.float() - wk.float()).abs()
        errs.append(e.max().item())
        means.append(e.mean().item())
        tols.append(2.0 ** -6 * scale)
        assert errs[-1] <= tols[-1] and means[-1] <= 1e-4 * scale, \
            (errs[-1], means[-1], scale)
        assert not gk[..., 0].any() and not gk[..., h1 + 1:].any()
        assert not gk[:, :, 3:].any()
    b_ms, b_by = bound(k2_read_bytes(acts, g5p) + nbytes(*got),
                       stem_flops(b, h), bf16)
    k2 = {
        "name": "fused_stem_bwd_saved", "route": "cuda",
        "source": f"{PORT}/csrc/stem_bwd.cu",
        "replaces": f"{JAX_PKG}/ops/stem_fused.py:1027",
        "launches": 0, "max_abs_err": max(errs), "tol": min(tols),
        "mean_abs_err": max(means), "shape": list(got[0].shape),
        "dtype": "bfloat16",
        "ms": time_ms(lambda: SF.fused_stem_bwd_saved(acts, g5p, sbp), 5),
        "plain_ms": time_ms(
            lambda: SF.fused_stem_bwd_saved_plain(acts, g5p, sbp), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    del got, want
    # float32: its own masks from the float32 K1, tolerance 2e-5 of scale
    sp32 = [(w.float(), bias) for w, bias in sp]
    sbp32 = SF.stem_bwd_params(sp32)
    xe32, xo32 = xe.float(), xo.float()
    acts32 = SF.fused_stem_fwd(xe32, xo32, sp32, save_acts=True)
    g5p32 = g5p.float()
    got = SF.fused_stem_bwd_saved(acts32, g5p32, sbp32)
    torch.cuda.synchronize()
    want = SF.fused_stem_bwd_saved_plain(acts32, g5p32, sbp32)
    err32 = 0.0
    for gk, wk in zip(got, want):
        scale = wk.abs().max().item()
        err = (gk - wk).abs().max().item()
        assert err <= 2e-5 * scale, (err, scale)
        err32 = max(err32, err / scale)
    b_ms, b_by = bound(k2_read_bytes(acts32, g5p32) + nbytes(*got),
                       stem_flops(b, h), torch.float32)
    k2["f32"] = {
        "max_rel_err": err32, "tol_rel": 2e-5,
        "ms": time_ms(
            lambda: SF.fused_stem_bwd_saved(acts32, g5p32, sbp32), 3),
        "plain_ms": time_ms(
            lambda: SF.fused_stem_bwd_saved_plain(acts32, g5p32, sbp32), 2),
        "bound_ms": b_ms, "bound_by": b_by}
    out.append(k2)
    del got, want, acts32, acts
    for k in out:
        log(f"[train-kernel] {k['name']}: err {k['max_abs_err']:.3g} "
            f"(tol {k['tol']:.3g}), {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}) ({card})")
    log(f"[train-kernel] K1 mask flips {out[0]['mask_flips']} of "
        f"{n_mask}; K3a per-element variant "
        f"{out[1]['ms_per_element_variant']:.4f} ms; K2 f32 "
        f"{json.dumps(k2['f32'])}")
    return out


class PlainStem(torch.autograd.Function):
    """The fused stem on its plain versions (K1 with masks, K2), for the
    bfloat16 gradient check: the route the kernels must reproduce."""

    @staticmethod
    def forward(ctx, x, sp, sbp):
        PC = import_port("ops.planar_conv")
        SF = import_port("ops.stem_fused")
        xe, xo = PC.to_planar_plain(x, 8, 2, 0), PC.to_planar_plain(x, 8, 2, 1)
        acts = SF.fused_stem_fwd_plain(xe, xo, sp, save_acts=True)
        ctx.save_for_backward(*acts)
        ctx.sbp = sbp
        return PC.from_planar_plain(acts[0], x.shape[1] // 4, 128)

    @staticmethod
    def backward(ctx, g5):
        PC = import_port("ops.planar_conv")
        SF = import_port("ops.stem_fused")
        acts = ctx.saved_tensors
        g5p = PC.to_planar_plain(g5.to(acts[0].dtype).contiguous())
        gxe, gxo = SF.fused_stem_bwd_saved_plain(acts, g5p, ctx.sbp)
        return SF.merge_phases(gxe, gxo, acts[1].shape[1] // 2, 3), None, None


def stem_conv_walk(x, sp):
    """Layers 0-5 as cuDNN convs (float32, the caller turns TF32 off):
    NHWC x -> NHWC y5, the reference of the stem-level gradient check."""
    def conv(u, w, b, s):
        y = torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1), b, s,
                                       (w.shape[0] - 1) // 2)
        return torch.where(y > 0, y, 0.1 * y)
    v = x.permute(0, 3, 1, 2)
    y1 = conv(conv(v, *sp[0], 1), *sp[1], 2)
    y3 = conv(conv(y1, *sp[2], 1), *sp[3], 1)
    return conv(y3 + y1, *sp[4], 2).permute(0, 2, 3, 1)


@contextlib.contextmanager
def plain_stem(SF):
    """Route ``Darknet``'s fused stem through ``PlainStem`` (the kernels'
    plain versions) while inside."""
    orig = SF.fused_stem
    SF.fused_stem = lambda x, sp, sbp=None: PlainStem.apply(x, sp, sbp)
    try:
        yield
    finally:
        SF.fused_stem = orig


def training(dev, card) -> dict:
    """Phase 6: the training CLI and its PatchTrainer at full width, with
    counted launches, timing, the conv-walk comparison and the gradient
    checks. Returns the training record; its ``launches`` are each
    kernel's over the CLI epoch, warm-up and timed steps."""
    PT = import_port("train.trainer")
    PE = import_port("attack.eot")
    PO = import_port("train.optim")
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    _cuda = import_port("ops._cuda")
    darknet = import_port("models.darknet")
    flops = import_port("models.flops")
    cli = import_port("cli.train_patch")
    SyntheticData = import_port("data").SyntheticData
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    rec = {}
    try:
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--mode", "paper_obj", "--synthetic", "48",
                            "--batch-size", str(TRAIN_BATCH), "--img-size",
                            str(SIZE), "--patch-size", str(PATCH),
                            "--epochs", "1", "--out-dir", out_dir,
                            "--device", dev.type])
        torch.cuda.synchronize()
        rec["cli_epoch_s"] = time.perf_counter() - t0
        exp = trainer.exp
        assert (exp.img_size, exp.patch_size, exp.batch_size,
                exp.compute_dtype) == (SIZE, PATCH, TRAIN_BATCH, "bfloat16")
        assert len(darknet.conv_specs(trainer.net)) == 75
        hist = trainer.history
        n_steps = 48 // TRAIN_BATCH
        assert len(hist) == 1 and hist[0]["num_batches"] == n_steps
        assert all(np.isfinite(hist[0][k]) for k in
                   ("loss", "no_obj", "no_cls", "tv", "nps", "colorful"))
        assert os.path.exists(os.path.join(out_dir, "final_patch.png"))
        assert os.path.exists(os.path.join(out_dir, "train_log.jsonl"))
        data = SyntheticData(48, SIZE, exp.max_labels, seed=SEED + 7)
        staged = [tuple(torch.from_numpy(a).to(dev) for a in
                        data.batch(TRAIN_BATCH, i)) for i in range(2)]
        p_start = trainer.patch.detach().clone()
        for i in range(3):
            trainer.step(*staged[i % 2])
        n_steps += 3
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(TIMED_STEPS):
            aux = trainer.step(*staged[i % 2])
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        n_steps += TIMED_STEPS
        launches = read_counts()
        route = darknet.last_routes()["stem"]
        ms = start.elapsed_time(end) / TIMED_STEPS
        rec.update({
            "steps_counted": n_steps, "launches": launches,
            "launches_per_step": {k: v / n_steps
                                  for k, v in launches.items()},
            "stem_route": route, "ms_per_step": ms,
            "host_ms_per_step": host_s / TIMED_STEPS * 1e3,
            "steps_per_min": 60e3 / ms,
            "mfu": flops.mfu(ms / 1e3, TRAIN_BATCH, trainer.net,
                             torch.cuda.get_device_name(0)),
            "train_step_gflop": flops.train_step_flops_per_image(
                trainer.net) * TRAIN_BATCH / 1e9,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": {k: float(v) for k, v in aux.items()}})
        assert route == "fused", route
        for k in TRAIN_PATH:
            assert launches[k] > 0, f"kernel {k} did not launch in training"
        assert all(np.isfinite(v) for v in rec["loss"].values()), rec["loss"]
        patch = trainer.patch.detach()
        assert not torch.equal(patch, p_start), "the patch did not move"
        assert patch.min().item() >= 0.0 and patch.max().item() <= 1.0

        # the same steps with the stem on the cuDNN conv walk (information)
        walk = PT.make_train_step(trainer.model, exp, fused_stem=False)
        pw = patch.clone().requires_grad_(True)
        opt = PO.make_optimizer(pw, exp.learning_rate)
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)

        def walk_step(i):
            draws = PE.draw_eot(gen, TRAIN_BATCH, exp.patch_size,
                                trainer.eot_cfg)
            walk(pw, opt, *staged[i % 2], exp.learning_rate, draws)

        for i in range(3):
            walk_step(i)
        assert darknet.last_routes()["stem"] == "conv"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        for i in range(TIMED_STEPS):
            walk_step(i)
        end.record()
        torch.cuda.synchronize()
        wms = start.elapsed_time(end) / TIMED_STEPS
        rec["conv_walk"] = {
            "ms_per_step": wms, "steps_per_min": 60e3 / wms,
            "mfu": flops.mfu(wms / 1e3, TRAIN_BATCH, trainer.net,
                             torch.cuda.get_device_name(0)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del walk, pw, opt

        # where a fused step's time goes (CUDA events, batch 24): the EOT
        # forward + backward, and the victim forward alone and forward +
        # input backward, on each stem route
        images, labels = staged[0]
        draws = PE.draw_eot(gen, TRAIN_BATCH, exp.patch_size,
                            trainer.eot_cfg)
        p = patch.clone().requires_grad_(True)

        def eot():
            patched, _ = PE.apply_eot_patch(p, images, labels, draws,
                                            trainer.eot_cfg)
            return torch.autograd.grad(patched.float().sum(), p)

        with torch.no_grad():
            x_in, _ = PE.apply_eot_patch(patch, images, labels, draws,
                                         trainer.eot_cfg)
        x_req = x_in.detach().requires_grad_(True)

        def victim(fused, backward):
            def run():
                if not backward:
                    with torch.no_grad():
                        return trainer.model(x_in, fused_stem=fused)
                heads = trainer.model(x_req, fused_stem=fused)
                return torch.autograd.grad(sum(hd.sum() for hd in heads),
                                           x_req)
            return run

        rec["breakdown_ms"] = {
            "eot_fwd_bwd": time_ms(eot, 5, 2),
            "victim_fwd_fused": time_ms(victim(True, False), 5, 2),
            "victim_fwd_bwd_fused": time_ms(victim(True, True), 5, 2),
            "victim_fwd_conv": time_ms(victim(False, False), 5, 2),
            "victim_fwd_bwd_conv": time_ms(victim(False, True), 5, 2)}
        del p, x_in, x_req

        # patch gradients at batch 4. The random-weight heads reach ~1e5,
        # so the sigmoided creation losses are flat there and their
        # gradient would not reach the stem: the checks differentiate fixed
        # random projections instead, through the same EOT and kernels.
        net, params = PT.build_victim(exp, 1)   # the CLI's victim (seed 0)
        exp32 = dataclasses.replace(exp, compute_dtype="float32")
        cfg32 = PT.eot_config(exp32)
        m32 = darknet.Darknet(net, params, torch.float32, device=dev).eval()
        imgs, labs = staged[0][0][:4], staged[0][1][:4]
        nb = imgs.shape[0]
        draws = PE.draw_eot(torch.Generator(device=dev).manual_seed(9), nb,
                            exp.patch_size, trainer.eot_cfg)
        draws32 = PE.draw_eot(torch.Generator(device=dev).manual_seed(9),
                              nb, exp.patch_size, cfg32)
        rgen = torch.Generator(device=dev).manual_seed(10)
        projs = {}

        def grad(fwd, cfg, d, key):
            """d(projection of fwd(patched)) / d patch, TF32 off."""
            p = patch.clone().requires_grad_(True)
            with _cuda.no_tf32():
                patched, _ = PE.apply_eot_patch(p, imgs, labs, d, cfg)
                outs = fwd(patched)
                if key not in projs:
                    projs[key] = [torch.randn(o.shape, generator=rgen,
                                              device=dev)
                                  / o.detach().abs().max() for o in outs]
                loss = sum((o * r).sum() for o, r in zip(outs, projs[key]))
                return torch.autograd.grad(loss, p)[0]

        def rel(a, b):
            return ((a - b).norm() / b.norm()).item()

        def heads(model, fused, route):
            def fwd(x):
                out = model(x, fused_stem=fused)
                assert darknet.last_routes()["stem"] == route
                return out
            return fwd

        # (1) the stem alone, float32: y5 through K3a, K1 (save_acts), K3b
        # and back through K3a, K2, against cuDNN convs of the same weights
        sp32, sbp32 = m32.stem_params(), m32.stem_bwd_params()
        g_stem_k = grad(lambda x: [SF.fused_stem(x.contiguous(), sp32,
                                                 sbp32)], cfg32, draws32,
                        "y5")
        g_stem_w = grad(lambda x: [stem_conv_walk(x, sp32)], cfg32, draws32,
                        "y5")
        rel_stem = rel(g_stem_k, g_stem_w)
        # (2) the whole victim, float32. The kernels' y5 differs from the
        # walk's by summation order; downstream, a leaky gate whose
        # pre-activation sits within that difference of 0 flips, and in a
        # random-weight victim whose heads reach 1e5 a few flips move the
        # gradient. So the kernel route is held (at 1e-4) against the walk
        # carrying the kernels' own y5 forward (straight through: the
        # downstream values are the kernel route's, the stem's backward is
        # the walk's). Recorded beside it: the kernel and plain routes
        # against the walk itself, each stem's y5 against the walk's, and
        # the walk with noise of the kernels' y5 difference added to y5.
        with torch.no_grad(), _cuda.no_tf32():
            x_eot, _ = PE.apply_eot_patch(patch, imgs, labs, draws32, cfg32)
            y5w = stem_conv_walk(x_eot, sp32)
            y5s = {"kernel": SF.fused_stem(x_eot.contiguous(), sp32),
                   "plain": PC.from_planar_plain(SF.fused_stem_fwd_plain(
                       *[PC.to_planar_plain(x_eot, 8, 2, o) for o in (0, 1)],
                       sp32), SIZE // 4, 128)}
            y5_diff = {f"f32_y5_{k}_vs_walk_{stat}": fn(v - y5w).item()
                       for k, v in y5s.items()
                       for stat, fn in (("std", torch.std),
                                        ("max", lambda d: d.abs().max()),
                                        ("unequal_frac", lambda d: (
                                            d != 0).float().mean()))}
            sigma = (y5s["kernel"] - y5w).std()
            noise = torch.randn(y5w.shape, generator=rgen,
                                device=dev) * sigma
            del y5s

        def walk_from_y5(model, y5):
            v = y5.permute(0, 3, 1, 2)
            return model.walk(v, 6, {5: v})

        def walk_on_kernel_y5(x):
            y5 = stem_conv_walk(x, sp32)
            with torch.no_grad():
                y5k = SF.fused_stem(x.contiguous(), sp32)
            return walk_from_y5(m32, y5k + (y5 - y5.detach()))

        g32w = grad(heads(m32, False, "conv"), cfg32, draws32, "heads")
        g32k = grad(heads(m32, True, "fused"), cfg32, draws32, "heads")
        g32s = grad(walk_on_kernel_y5, cfg32, draws32, "heads")
        g32n = grad(lambda x: walk_from_y5(
            m32, stem_conv_walk(x, sp32) + noise), cfg32, draws32, "heads")
        rel32s = rel(g32k, g32s)
        rel32, rel32n = rel(g32k, g32w), rel(g32n, g32w)
        with plain_stem(SF):
            rel32p = rel(grad(heads(m32, True, "fused"), cfg32, draws32,
                              "heads"), g32w)
        del m32
        # (3) bfloat16: the kernels vs the plain-stem route, both against
        # the float32 walk
        g16k = grad(heads(trainer.model, True, "fused"), trainer.eot_cfg,
                    draws, "heads")
        with plain_stem(SF):
            g16p = grad(heads(trainer.model, True, "fused"),
                        trainer.eot_cfg, draws, "heads")
        d_kp = (g16k - g16p).norm().item()
        d_p32 = (g16p - g32w).norm().item()
        rec["grad_check"] = {
            "batch": nb, "f32_stem_rel_l2": rel_stem, "f32_stem_tol": 1e-4,
            "f32_heads_kernel_vs_walk_on_kernel_y5_rel_l2": rel32s,
            "f32_heads_tol": 1e-4,
            "f32_heads_kernel_vs_walk_rel_l2": rel32,
            "f32_heads_plain_vs_walk_rel_l2": rel32p,
            "f32_heads_noisy_y5_vs_walk_rel_l2": rel32n, **y5_diff,
            "bf16_kernel_vs_plain_l2": d_kp,
            "bf16_plain_vs_f32_l2": d_p32,
            "bf16_kernel_vs_plain_max": (g16k - g16p).abs().max().item(),
            "bf16_plain_vs_f32_max": (g16p - g32w).abs().max().item(),
            "grad_l2": g32w.norm().item()}
        log(f"[train] grad check {json.dumps(rec['grad_check'])}")
        assert g_stem_w.norm().item() > 0 and g32w.norm().item() > 0
        assert rel_stem <= 1e-4, rel_stem
        assert rel32s <= 1e-4, rel32s
        assert d_kp <= 2 * d_p32, (d_kp, d_p32)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    log(f"[train] {json.dumps(rec)} ({card})")
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import importlib
    port = importlib.import_module(PORT)
    from PIL import Image
    from http.server import ThreadingHTTPServer
    _cuda = importlib.import_module(f"{PORT}.ops._cuda")
    PC = importlib.import_module(f"{PORT}.ops.planar_conv")
    SF = importlib.import_module(f"{PORT}.ops.stem_fused")
    darknet = importlib.import_module(f"{PORT}.models.darknet")
    serve = importlib.import_module(f"{PORT}.cli.serve")
    M, E = port.models, port.evals
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    info = _cuda.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, v in info.items():
        log(f"[build] {name}: {v['seconds']:.1f} s")
        for line in v["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"    {line.strip()}")

    # -- model and main-path inputs ------------------------------------
    net = M.build_network(M.yolov3_blocks(width=SIZE, height=SIZE))
    assert len(M.conv_specs(net)) == 75
    params = M.init_params(net, SEED)
    det = E.Detector(net, params, img_size=SIZE,
                     compute_dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(SEED)
    tiles = rng.integers(0, 256, (16, SIZE, SIZE, 3), dtype=np.uint8)
    x8 = (torch.from_numpy(tiles[:BATCH]).to(dev).float() / 255.0).to(
        torch.bfloat16).contiguous()
    sp = det.model.stem_params()

    # -- 2. kernels vs plain versions at the serving shapes ------------
    kernels = []
    x8c = x8.contiguous()
    # K3a to_planar (one phase of split_phases)
    got = PC.to_planar(x8c, 8, 2, 0)
    want = PC.to_planar_plain(x8c, 8, 2, 0)
    err = (got.float() - want.float()).abs().max().item()
    assert err == 0.0, f"to_planar differs from its plain version: {err}"
    assert torch.equal(PC._to_planar_launch(x8c, 8, 2, 0, True), want)
    pads = (1, got.shape[-1] - SIZE // 2 - 1, 0, 5)
    # the bytes one launch must move: the phase's half of the NHWC input
    # (every second column) read once, the planar output written once
    b_ms, b_by = bound(nbytes(x8c) // 2 + nbytes(got), 0.0, torch.bfloat16)
    kernels.append({
        "name": "to_planar", "route": "cuda",
        "source": f"{PORT}/csrc/planar.cu",
        "replaces": f"{JAX_PKG}/ops/planar_conv.py:124",
        "launches": 0, "max_abs_err": err, "tol": 0.0,
        "shape": list(x8c.shape), "dtype": "bfloat16",
        "ms": time_ms(lambda: PC.to_planar(x8c, 8, 2, 0)),
        # the tiled transpose the wrapper takes for C >= 32, at C = 3
        "ms_tiled_variant": time_ms(
            lambda: PC._to_planar_launch(x8c, 8, 2, 0, True)),
        "plain_ms": time_ms(lambda: PC.to_planar_plain(x8c, 8, 2, 0)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: torch.nn.functional.pad(
            x8c[:, :, 0::2].permute(0, 1, 3, 2), pads))})
    # K1 fused_stem_fwd, bf16 (serving) and f32
    xe, xo = SF.split_phases(x8c)
    y5_shape = (BATCH, SIZE // 4, 128, 256)
    # dirty the block the output will reuse: the kernel writes every lane
    torch.full(y5_shape, float("nan"), dtype=torch.bfloat16, device=dev)
    y5k = SF.fused_stem_fwd(xe, xo, sp)
    torch.cuda.synchronize()
    y5p = SF.fused_stem_fwd_plain(xe, xo, sp)
    scale = y5p.float().abs().max().item()
    e = (y5k.float() - y5p.float()).abs()
    err, mean_err = e.max().item(), e.mean().item()
    # summation order may flip a bf16 rounding of an intermediate: allow
    # two bf16 ulps of the output scale, and a tiny mean
    tol = 2.0 ** -6 * scale
    assert err <= tol and mean_err <= 1e-4 * scale, (err, mean_err, scale)
    assert not y5k[..., 0].any() and not y5k[..., SIZE // 4 + 1:].any()
    b_ms, b_by = bound(2 * image_bytes(xe, SIZE // 2, 3) + nbytes(y5k),
                       stem_flops(BATCH, SIZE), torch.bfloat16)
    k1 = {
        "name": "fused_stem_fwd", "route": "cuda",
        "source": f"{PORT}/csrc/stem_fused.cu",
        "replaces": f"{JAX_PKG}/ops/stem_fused.py:645",
        "launches": 0, "max_abs_err": err,
        "tol": tol, "mean_abs_err": mean_err, "shape": list(xe.shape),
        "dtype": "bfloat16",
        "ms": time_ms(lambda: SF.fused_stem_fwd(xe, xo, sp), 10),
        "plain_ms": time_ms(lambda: SF.fused_stem_fwd_plain(xe, xo, sp),
                            10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "gflop": stem_flops(BATCH, SIZE) / 1e9}
    sp32 = [(w.float(), b) for w, b in sp]
    xe32, xo32 = xe.float(), xo.float()
    torch.full(y5_shape, float("nan"), device=dev)
    y5k = SF.fused_stem_fwd(xe32, xo32, sp32)
    torch.cuda.synchronize()
    y5p = SF.fused_stem_fwd_plain(xe32, xo32, sp32)
    scale = y5p.abs().max().item()
    err = (y5k - y5p).abs().max().item()
    tol = 2e-5 * scale   # float32 summation order over five convs
    assert err <= tol, (err, scale)
    assert not y5k[..., 0].any() and not y5k[..., SIZE // 4 + 1:].any()
    b_ms, b_by = bound(2 * image_bytes(xe32, SIZE // 2, 3) + nbytes(y5k),
                       stem_flops(BATCH, SIZE), torch.float32)
    k1["f32"] = {
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(lambda: SF.fused_stem_fwd(xe32, xo32, sp32), 5),
        "plain_ms": time_ms(
            lambda: SF.fused_stem_fwd_plain(xe32, xo32, sp32), 5),
        "bound_ms": b_ms, "bound_by": b_by}
    kernels.append(k1)
    # K3b from_planar (stem output y5 -> NHWC)
    y5 = SF.fused_stem_fwd(xe, xo, sp)
    got = PC.from_planar(y5, SIZE // 4, 128)
    want = PC.from_planar_plain(y5, SIZE // 4, 128)
    err = (got.float() - want.float()).abs().max().item()
    assert err == 0.0, f"from_planar differs from its plain version: {err}"
    # the bytes the function must move: the image lanes of y5's 128
    # channels read once (not its border and padding lanes), the NHWC
    # output written once
    b_ms, b_by = bound(2 * nbytes(got), 0.0, torch.bfloat16)
    view = y5[:, :, :128, 1:SIZE // 4 + 1].permute(0, 1, 3, 2)
    kernels.append({
        "name": "from_planar", "route": "cuda",
        "source": f"{PORT}/csrc/planar.cu",
        "replaces": f"{JAX_PKG}/ops/planar_conv.py:170",
        "launches": 0, "max_abs_err": err,
        "tol": 0.0, "shape": list(y5.shape), "dtype": "bfloat16",
        "ms": time_ms(lambda: PC.from_planar(y5, SIZE // 4, 128)),
        "plain_ms": time_ms(lambda: PC.from_planar_plain(y5, SIZE // 4,
                                                          128)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: view.contiguous())})
    for k in kernels:
        log(f"[kernel] {k['name']}: err {k['max_abs_err']:.3g} "
            f"(tol {k['tol']:.3g}), {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}) ({card})")

    # -- 3. serving (the main path; counted launches) ------------------
    reset_counts()
    t0 = time.perf_counter()
    dets, valid, sat = det.detect_batch_device(tiles[:BATCH], 0.4, 0.4)
    torch.cuda.synchronize()
    log(f"[serve] first batch {time.perf_counter() - t0:.2f} s, stem "
        f"route {darknet.last_routes()['stem']}")
    assert darknet.last_routes()["stem"] == "fused"
    assert tuple(dets.shape) == (BATCH, 300, 7)
    svc = E.DetectionService(det, max_batch=BATCH, window_ms=5.0,
                             conf_thresh=0.4, nms_thresh=0.4,
                             wire_dtype=np.uint8)
    lat = []

    def submit(img):
        t = time.perf_counter()
        rows = svc.submit(img, timeout=300)
        lat.append(time.perf_counter() - t)
        return rows

    with svc:
        with ThreadPoolExecutor(4) as pool:
            answers = list(pool.map(submit, list(tiles)))
        assert len(answers) == 16
        assert all(a.ndim == 2 and a.shape[1] == 7 for a in answers)
        server = ThreadingHTTPServer(
            ("127.0.0.1", 0), serve.make_handler(
                svc, port.data.load_class_names(), SIZE))
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        try:
            http_counts = []
            for i in range(2):
                buf = io.BytesIO()
                Image.fromarray(tiles[i]).save(buf, format="PNG")
                req = urllib.request.Request(
                    f"http://127.0.0.1:{server.server_address[1]}/detect",
                    data=buf.getvalue())
                with urllib.request.urlopen(req, timeout=300) as r:
                    assert r.status == 200
                    out = json.loads(r.read())
                assert out["count"] == len(out["detections"])
                http_counts.append(out["count"])
        finally:
            server.shutdown()
            server.server_close()
            th.join(timeout=30)
    launches = read_counts()
    log(f"[serve] 16 service answers (rows {[len(a) for a in answers]}), "
        f"HTTP counts {http_counts}, batches {svc.stats.batches}, "
        f"saturated {svc.stats.saturated}; launches {launches}")
    for k in SERVE_PATH:
        assert launches[k] > 0, f"kernel {k} did not launch while serving"
    for k in kernels:
        k["launches"] = launches[k["name"]]

    # heads through the kernels vs the same model with the plain stem
    with torch.inference_mode():
        heads_k = det.model(x8, fused_stem=True)
        xe, xo = PC.to_planar_plain(x8, 8, 2, 0), PC.to_planar_plain(
            x8, 8, 2, 1)
        y5 = PC.from_planar_plain(SF.fused_stem_fwd_plain(xe, xo, sp),
                                  SIZE // 4, 128).permute(0, 3, 1, 2)
        heads_p = det.model.walk(y5, 6, {5: y5})
        # the same model in float32 (TF32 off), through the conv walk and
        # through the float32 kernels
        m32 = darknet.Darknet(net, params, torch.float32, device=dev)
        heads_32 = m32(x8.float(), fused_stem=False)
        heads_32k = m32(x8.float(), fused_stem=True)
        del m32
    for hk, hp, h32, h32k in zip(heads_k, heads_p, heads_32, heads_32k):
        assert bool(torch.isfinite(hk).all())
        err = (hk - hp).abs()
        ref = (hp - h32).abs()
        err32 = (h32k - h32).abs().max().item()
        scale = h32.abs().max().item()
        log(f"[serve] head {tuple(hk.shape)}: bf16 kernel vs plain stem "
            f"max|err| {err.max().item():.4g} mean|err| "
            f"{err.mean().item():.4g}; bf16 vs float32 max "
            f"{ref.max().item():.4g} mean {ref.mean().item():.4g}; "
            f"float32 kernel vs conv walk max|err| {err32:.4g}; scale "
            f"{scale:.4g}")
        # bf16 tolerance: once two bf16 runs differ in one bit, their
        # later roundings are independent, so the kernel route and the
        # plain route differ by about sqrt(2) times the bf16 route's own
        # error against float32; allow 2x
        assert err.max().item() <= 2 * ref.max().item()
        assert err.mean().item() <= 2 * ref.mean().item()
        # float32: summation order only (1e-4 of the head scale, as the
        # CPU test against the JAX package)
        assert err32 <= 1e-4 * scale

    # throughput and latency: 2,048 requests from 8 closed-loop threads
    # (several seconds, 256 batches), after warmup
    lat.clear()
    svc = E.DetectionService(det, max_batch=BATCH, window_ms=5.0,
                             conf_thresh=0.4, nms_thresh=0.4,
                             wire_dtype=np.uint8)
    n_req = 2048
    reqs = [tiles[i % 16] for i in range(n_req)]
    with svc:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(submit, reqs))
        wall = time.perf_counter() - t0
    p50, p99 = np.percentile(np.asarray(lat) * 1e3, [50, 99])
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: det.model(x8, fused_stem=True), 10)
        stem_ms = time_ms(lambda: SF.fused_stem(x8, sp), 10)
        h2d_ms = time_ms(lambda: torch.from_numpy(tiles[:BATCH]).to(dev),
                         10)
        heads = det.model(x8, fused_stem=True)
        decode_ms = time_ms(lambda: E.detect.decode_all_heads(
            heads, det.anchor_groups, (SIZE, SIZE), 15), 10)
        boxes, obj, cls_conf, _ = det._fields(x8)
        score = torch.where(obj * cls_conf > 0.4, obj,
                            torch.zeros_like(obj))
        # the Jacobi passes read one boolean back each, so this is
        # device time plus the host round trips between passes
        nms_ms = time_ms(lambda: E.detect.greedy_nms_device_batch(
            boxes, score, 0.4, 300), 5)
    t0 = time.perf_counter()
    for _ in range(5):
        d, v, s = det.detect_batch_device(tiles[:BATCH], 0.4, 0.4)
        v.cpu()
    batch_ms = (time.perf_counter() - t0) / 5 * 1e3
    serving = {"img_per_s": n_req / wall, "requests": n_req,
               "threads": 8, "wall_s": wall,
               "p50_ms": float(p50), "p99_ms": float(p99),
               "batches": svc.stats.batches,
               "detect_batch_device_ms": batch_ms,
               "forward_ms": fwd_ms, "stem_ms": stem_ms, "h2d_ms": h2d_ms,
               "decode_ms": decode_ms, "nms_ms": nms_ms,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"[serve] {json.dumps(serving)} ({card})")

    # -- 4. reference goldens through the float32 Detector -------------
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    for d, name in (("refparity", "mini_yolov3_dota"),
                    ("refparity_slim", "yolov3_dota_slim")):
        with open(os.path.join(fixtures, d, "golden_boxes.json")) as f:
            golden = json.load(f)
        gnet = M.network_from_cfg(os.path.join(fixtures, d, f"{name}.cfg"))
        gparams, _ = M.load_darknet_weights(
            gnet, os.path.join(fixtures, d, f"{name}.weights"))
        gdet = E.Detector(gnet, gparams, img_size=golden["img_size"],
                          num_classes=golden["num_classes"],
                          compute_dtype=torch.float32, device=dev)
        for key, conf in (("conf04", 0.4), ("conf02", 0.2)):
            n = 0
            for tile, entry in golden["tiles"].items():
                img = np.asarray(Image.open(os.path.join(
                    fixtures, d, tile)).convert("RGB"), np.float32) / 255.0
                ours = gdet.detect(img, conf, golden["nms_thresh"])
                ref = entry[key]
                assert len(ours) == len(ref), (d, tile, key, len(ours),
                                               len(ref))
                assert match_count(ours, ref) == len(ref), (d, tile, key)
                n += len(ref)
            log(f"[golden] {d} {key}: {n} boxes match 1-1 within 1e-3")

    # -- 5. training kernels at the training shapes --------------------
    train_kernels = training_kernels(dev, sp, det.model.stem_bwd_params(),
                                     card)
    del det, svc
    torch.cuda.empty_cache()

    # -- 6. training (the second main path; counted launches) ----------
    rec = training(dev, card)
    for k in train_kernels:
        k["launches"] = rec["launches"][k["name"]]
    kernels += train_kernels
    for k in kernels:
        k["train_launches_per_step"] = rec["launches_per_step"][k["name"]]

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
