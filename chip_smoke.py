#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. Build the kernels of ``<port>/csrc`` (one nvcc per source, in
   parallel) and print the build time and the ``-Xptxas -v`` lines; then
   count the tensor-core instructions (``cuobjdump -sass``: HMMA, HGMMA)
   of each bfloat16 K1, K2, K5, K8a (with and without ``save_acts``),
   K8b, K6a (with and without ``save``), K6b and K6c kernel and of every
   bfloat16 K4 instantiation (1x1, 3x3 s1, 3x3 s2 and the k3t2 adjoint,
   each block width), with its registers, shared memory, blocks per
   multiprocessor and spilled bytes, and fail if one has none, if one
   spills, or if one of the wgmma kernels (K1, K2, K5, K8b, K6a, K6a
   ``save``, K6b, K6c, K4) has an HMMA, no HGMMA or neither a TMA load
   nor a bulk copy; the same
   resource records (static shared
   memory) for the layout kernels K3a and K3b, each form and dtype, and
   for K7 (the network form at k = 1..8 and the rank-counting form, each
   dtype), none of which may spill.
2. Hold each kernel of the serving path against its plain PyTorch
   version on the card at the serving shapes (batch 8, 608^2, bfloat16;
   the fused stem and the layout kernels also in float32) and time
   kernel, plain version and, where one exists, a single PyTorch call
   computing the same function (for K1, the stem on cuDNN:
   ``stem_conv_walk``): ``split_phases`` (K3a, both column phases in one
   launch) bit for bit against two ``to_planar_plain`` calls, beside the
   bound of both phases and two ``F.pad`` calls; K3a's step-1 narrow form
   at the planar stem's input; K3b of y5. Each layout kernel writes once
   into output blocks filled with NaN and once into the wrapper's own;
   the layout kernels and their library calls are also timed by their
   calls' device time (a CUDA graph of 20 calls replayed between two
   CUDA events), which leaves out host-launch gaps.
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
   masks (also float32), K3a's tiled form at the cotangent g5's shape and
   at gp12's, ``split_phases`` and K3b of y5 (the layout kernels bit for
   bit, also float32), each against its plain version and timed as in
   phase 2,
   K1 and K2 beside the stem on cuDNN (forward; input backward); then
   K5, the recomputing stem backward (bfloat16 and float32), against K2
   on K1's masks of the same x (bit for bit: K5 recomputes them with K1's
   arithmetic and runs K2's chain) and the plain chain on those masks,
   and its own plain version (which recomputes the masks in cuDNN's
   order: checked where no gate flipped). The wgmma stem kernels (K1,
   K2, K5, K8b) are timed by device time at b8 and b24 and their b24
   cycles split by category (a ``-DAPFP_PROFILE`` build).
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
7. Planar-route and stage kernels at full width (b24 608^2 unless said):
   K4 (the generic planar conv) at the five stem convs' forward (bfloat16
   at b24, float32 at b8), the five backward convs of the planar stem (the
   two stride-2 adjoints as the k3t2 variant on the unexpanded cotangent;
   gate, res) and the 152^2 stage's four convs forward and backward, K3b's
   narrow form at the planar stem's input cotangent (beside the tiled
   form at the same shape, timed as the reason for a narrow form); K6a
   with and without its masks and K6b, bfloat16 and float32; K6c (the
   stage backward widened by conv12's dgrad), bfloat16 and float32. Each
   against its plain version (bfloat16 K6a's y11 and masks also against
   the planar stage route's, K4 x 4: equal bit for bit), timed beside its
   bound and a cuDNN yardstick (K4: the conv alone,
   ``F.conv_transpose2d`` for k3t2; K6:
   the stage's four convs on the conv walk, forward and forward +
   backward; K6c: that plus conv12's dgrad on cuDNN); K4's and the four
   K6 rows' cycle splits (``[k4-split]``, ``[k6-split]`` lines: the
   ``-DAPFP_PROFILE`` builds) and the K6 rows' device times.
8. Training on the other routes (counted launches): ``PatchTrainer`` with
   ``res152="fused"`` (routes fused/fused: one K6a ``save`` and one K6b a
   step) and a train step with ``fused_stem=False, planar_stem=True,
   res152="planar"`` (only K4 in layers 0-11: 6 1x1, 8 3x3 s1, 2 3x3 s2
   and 2 k3t2 a step, and no ``expand2_planar``), each with warm-up and
   timed steps; then float32 patch-gradient checks at batch 4 (the planar stem
   and each stage route against cuDNN convs, the c12 stage against the
   cuDNN walk carrying its leaky gates through layer 12, and each whole
   route against the walk carrying that route's own y11 forward, all at
   1e-4 relative L2) and the bfloat16 readings against the plain route.
   Then the same for ``PatchTrainer(stem_remat=True)`` (K1 without masks
   and K5 a step) and ``PatchTrainer(res152="c12")`` (K1 ``save_acts``,
   K6a ``save``, K6c and K2 a step), with peak memory, beside the default
   route's under the same conditions; their float32 checks: remat against
   the default fused route, c12 against the walk carrying the route's
   forward and gates through layer 12. Then one serving batch
   (b8) with ``res152="fused"`` (K6a without masks, the forward alone,
   which training never launches) and one with ``res152="c12"``.

9. The experimental package (``<port>/experimental/``; counted launches):
   K7, the median (a register-resident selection network for k <= 8,
   rank counting above), bit for bit against its plain version in float32
   and bfloat16 (k 1, 3, 4, 7, 8 and 9; ties, +-0, +-inf, NaN windows on
   both sides of the -inf limit; into NaN-filled blocks), at the EOT
   smoother's shape also against the shipped forward and a ``kthvalue``
   yardstick, timed beside its operations bound, at a 608^2 scene and at
   k 9; K8a (with and without
   ``save_acts``) and K8b, the batch-on-lanes stem, at b24 608^2 bfloat16
   and float32 against their plain versions and against K1 / K2 on the
   same x (bfloat16: K8a's y5 and signs and K8b's gx equal K1's and
   K2's bit for bit); then the package's entry points at full width: K7
   on the patch (the k 7 network form, counted apart), b24 victim forward + input backward steps with layers 0-5 on
   ``fused_stem_batched`` (one K8a ``save_acts`` and one K8b a step, no K1
   or K2), a forward without grad (K8a alone) and a b8 packed-stem forward;
   the A/B against the shipped fused stem (layout glue apart), the float32
   b4 patch-gradient check against the walk carrying the route's own y5
   forward and gates (1e-4 relative L2), and the packed route's float32
   heads against the conv walk (1e-4 of the head scale).
9b. The EOT warp's kernel pair (``eot_warp_kernels``; also alone with
   ``python3 chip_smoke.py --warp``) against the plain warp at b24, 224 ->
   608^2 and 416^2, bfloat16 and float32: errors, each kernel's time
   beside its byte bound, the pair through autograd beside the plain
   warp, peak memory; its entries carry phase 6's training launches.

10. The device-store training path (counted launches): the training CLI
    with ``--device-store`` over 58 synthetic 608^2 PNG tiles (2 epochs of
    3 b24 steps, each epoch's last batch padded with zero weights), each
    of the default training kernels (split_phases, K1 ``save_acts``, K3b,
    the tiled K3a of g5, K2) launched once a step and nothing else, and
    the per-step CLI (``BatchLoader``, partial batch dropped: 2 steps) on
    the same files; the first store step held against the per-step path
    on the same rows (the gathered float32 batch bit for bit; the loss
    parts within 1e-3 relative in bfloat16 and float32; the float32 patch
    gradient within 1e-4 relative L2, TF32 off); the two paths' pace over
    192 tiles (8 b24 steps an epoch, CUDA events): the store epoch's ms
    per step beside the per-step path's first step and its running steps,
    with what the per-step path adds: one batch's PNG decode and its host
    -> device copy. The tiles are smooth random fields with pixel noise,
    whose PNGs compress about as photographs do; not DOTA imagery.
11. Data parallelism: a one-rank NCCL process group through
    ``init_distributed`` (``WORLD_SIZE=1``, a local ``MASTER_ADDR``), its
    collectives on card tensors, and 3 default b24 steps of a
    ``PatchTrainer`` given the mesh, equal bit for bit to the meshless
    trainer's (a size-1 mesh runs the meshless code: this shows the group
    and the default path, not the cross-rank step); with two cards or
    more, also the training CLI as two NCCL processes against it in one
    (one card alone prints that the check needs two).
12. A profiler trace (``utils.profiling.trace``) of 5 default b24 steps
    after warm-up: the device's busy share over the traced steps, its
    time by category (``tools/step_profile``'s attribution), the 10
    device operations that take the most time, the longest idle gaps.
13. The evaluation path (counted launches): the native host library built
    (``utils/native.py``: the run fails if g++ cannot build it); the full-
    width YOLOv3 (random weights, bf16) written as .cfg + .weights and
    driven through the eval CLIs in-process over 16 ``smooth_tile``s:
    ``images_filter`` (conf 0.01, b8), ``test_patch`` (a seeded 224
    patch, ``--save-images``), ``test_patch_metrics --json``,
    ``clean_img_pre`` (conf 0.2), ``paste_patch`` in both modes (EOT
    placement from finite labels, one box a tile: its first composite,
    computed again in float32, must be finite, the CLI's PNG its
    quantization and different from the source inside the pasted box)
    and
    ``dataset_tools stats``; one label file per kept image, every report
    value finite but the M2s that are NaN or inf by definition; img/s of
    ``images_filter`` and ``test_patch``, the latter's per-image time
    split into placement, composite and detection (host clock and CUDA
    events); K3a ``split_phases``, K1 and K3b launched. Then the trained
    slim victim on its three tiles, float32, on the card and on the CPU
    (``images_filter`` -> ``test_patch`` -> ``test_patch_metrics``, both
    placing from the CPU run's labels): placements and half-edges equal,
    labels equal up to NMS tie order within 1e-3, M1 and the counts
    equal, the other report floats within 1e-3; K3a, K4 and K3b
    launched. Then PGD: the slim victim's first image gradient (planar
    stem) against the conv walk carrying the route's leaky gates (1e-4
    relative L2; the plain walk's distance and the gates it flips
    recorded) and the stepped images' sign flips (<= 1e-4); at full
    width, b2, three float32 steps (K1 ``save_acts``, K2, the tiled K3a
    and K3b each once a step) within eps and [0, 1], and its ms a step.
14. The attack-of-record tools (``<port>/tools/``, in this process, each
    CLI leg's time, launches and ``last_routes()`` recorded; counted
    launches): (a) ``attack_quality --mini`` at its defaults (96 train
    and 64 held-out scenes, 150 epochs, b24, patch 112, 320^2): the
    trained patch must beat the random control on M1@0.4 and M2@0.01 (the
    JAX package's criterion), every metric finite, M4 of 15 entries,
    printed beside the JAX package's recorded 150-epoch run; (b) the
    protocol on the trained slim victim (608^2, patch 224):
    ``protocol_prep``'s scenes and ``images_filter``, then
    ``protocol_run`` with 96 images (4 b24 batches an epoch), 42 epochs
    resumed at 21 (leg 2 a fresh trainer and store from the checkpoint)
    and 16 held-out scenes: 42 epochs logged once each, 168 steps, leg 2
    resumed at 21, both patches' metrics finite, K3a, K4 and K3b in the
    eval legs (the slim victim's training takes the conv walk: no kernel);
    (c) ``soak`` at full width, 200 b24 steps on the default route (each
    of K3a ``split_phases``, K1 ``save_acts``, K3b, the tiled K3a and K2
    once a step), its own asserts (every loss term finite, the patch in
    [0, 1], the loss falling) and steps/min; (d) ``convergence_compare``
    at its mini defaults (20 epochs, 96 scenes), every value finite.
15. The measurement tools and the warp A/Bs (``<port>/tools/``, in this
    process, each summary on a line of its own; counted launches): (a)
    ``serving_throughput 2048 8 16 uint8`` (the service counts 2,049
    requests, the warm one included; mean fill <= 8; K3a ``split_phases``,
    K1 and K3b launched); (b)
    ``detector_throughput 16`` (three finite positive rates: the device
    pipeline, end to end with the host NMS, ``detect_batch_device``); (c)
    ``serve_soak`` for 30 s (cut from the tool's 1,800 s; 16 clients, b8,
    uint8: the repository tool's report keys, >= 1 request a second, RSS
    drift recorded); (d) ``perf_breakdown`` at b8 and b24 (finite; at b24
    each default training kernel once a step), its b24 ms/step beside
    phase 6's; (e) ``step_profile 8 10`` (the categories sum to the
    device's merged busy time within 1%; stem-fwd, stem-bwd and layout
    non-zero); (f) ``warp_ab`` and ``warp_dtype_ab`` at their defaults
    (600 steps, 64 held-out scenes, the crafted 64^2 victim, which takes
    no stem kernel in training): every metric finite, and every row's
    M1@0.4 and M2@0.01 more than twice the control's (the untrained
    patch through the same paste warp, which fails that gate), printed
    beside the JAX package's record.
16. The TPU-route A/B micro tools (``<port>/tools/``, in this process,
    each summary on a line of its own; counted launches; CUDA events
    around 20-30 back-to-back calls after a warm-up, rows under 0.05 ms a
    call listed as host-bound): (a) ``stem_ab 8 608`` (the stem on cuDNN
    vs the planar stem, fwd and fwd + bwd, then the planar backward piece
    by piece): every row finite, the chained pieces' last output (through
    K3b's narrow form) equal to ``_stem_bwd``'s on the same inputs bit for
    bit, K4 1x1, 3x3 s1, 3x3 s2 and ``k3t2`` launched; (b) ``stem_fused_ab
    8 608`` (cuDNN vs planar vs fused, fwd and fwd + bwd, remat and
    saved): the b1 bf16 fused forward within 5e-2 of the cuDNN walk, K1,
    K1 ``save_acts``, K2 and K5 launched; (c) ``c12_ab grad``, ``grad
    c12``, ``step 24`` and ``step 24 c12``: each on the route it asked
    for (the tool exits otherwise), finite digests (their gap recorded),
    on c12 K6a ``save`` and K6c once a step, the step ms beside phase 8's;
    (d) ``c12_micro 24`` (K6a ``save``, K6b, K6c and cuDNN's conv12 dgrad
    apart): finite, each beside phase 7's reading of the same kernel; (e)
    ``conv_micro 8`` (the victim's conv geometries, fwd and dgrad on
    cuDNN): finite, every TF/s below the bf16 peak; (f) ``s2dx_poly_ab
    8`` (the stride-2 dgrad: cuDNN vs two polyphase forms): both forms
    within 1e-5 of the float32 adjoint (TF32 off) at all five
    geometries. K1, K1 ``save_acts``, K2, K5, K3a (step 1,
    ``split_phases``, tiled), K3b (tiled, narrow), the four K4 variants,
    K6a ``save``, K6b and K6c are each launched over the phase.
17. The repository's root entry points (``<port>/tools/bench.py``, the
    counterpart of ``bench.py``, and ``<port>/tools/entry.py``, of
    ``__graft_entry__.py``): (a) ``python -m <port>.tools.bench`` as a
    subprocess (``run_ranks``: stopped with what it started on a
    timeout): its last line is the record of
    ``patch_train_steps_per_min_b8_{cards}dev`` with ``value`` > 0, no
    "error", a finite ``ms_per_step`` and ``mfu`` in (0, 1) on an H100
    SXM, and its "# launches" line shows each default training kernel
    launched 33 times (3 warm-up + 30 timed steps) on rank 0; then
    ``bench.main`` in this process with both child timeouts at 1 s and no
    backoff prints the "error" record of a child that timed out. (b)
    ``entry()`` on the card: the three heads' shapes, equal bit for bit to
    the ``Detector``'s forward of the same weights, on the fused stem
    (``last_routes()``), launching K3a ``split_phases``, K1 and K3b once
    each and nothing else. (c) ``dryrun_multichip(min(cards, 4), "cuda")``
    over NCCL (a one-rank group on one card). (d) ``dryrun_multichip(4,
    "cpu")``: 4 gloo ranks, its line says ``4-way cpu mesh``.

Phase 4 also holds the slim victim (stem widths 8/16/8/16/32) on the
planar stem (K4), and once more with ``res152="planar"``, and times its
bfloat16 ``Detector`` forward at b8 (the tensor-core K4 at block widths 1
and 2, each of its five calls held against ``planar_conv_plain`` on the
same inputs). Phase 9 times
the stem on cuDNN at K8's shape as K8's yardstick. The default
routes stay: serving and training take the fused stem and the conv walk
for layers 6-11, and launch no K4, K5, K6 or experimental kernel (K7, K8);
the fused-stage and all-planar routes launch no K5 or K6c.

Each entry of the kernels line carries its launches on the phase 10
store path, the phase 13 eval path, the phase 14 protocol path, the
phase 15 tools path, the phase 16 micro tools path and the phase 17
root entry path (``store_path_launches``, ``eval_path_launches``,
``protocol_path_launches``, ``tools_path_launches``,
``micro_path_launches``, ``entry_path_launches``: the bench child's
counts plus ``entry()``'s call's). The last two lines are the kernels JSON object and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed before them. Exits non-zero, printing no result, without a card
or without the port beside this script.

    python3 chip_smoke.py --k4-ab DIR     # K4, DIR's tree against this one
    python3 chip_smoke.py --stem-ab DIR   # K5, K8b and K2 alike
    python3 chip_smoke.py --k6-ab DIR     # K6a, K6a save, K6b, K6c alike

run the A/Bs of ``ab_turns`` on one card instead: the checkout at DIR (a
parent commit unpacked by ``git archive``) and this one in turns
(parent, this, this, parent).
"""

import contextlib
import dataclasses
import functools
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
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
PORT = ("adversarial_patch_based_false_positive_creation_attacks_against_"
        "aerial_imagery_object_detectors_tpu_torch")
JAX_PKG = PORT[:-len("_torch")]
SEED = 0
BATCH, SIZE = 8, 608
TRAIN_BATCH, PATCH, TIMED_STEPS = 24, 224, 20
# the kernels each main path must launch (entry names of the kernels line)
SERVE_PATH = ("to_planar_phases", "fused_stem_fwd", "from_planar")
TRAIN_PATH = ("to_planar_phases", "fused_stem_fwd_save_acts", "from_planar",
              "to_planar_g5", "fused_stem_bwd_saved")
K4_VARIANTS = ("planar_conv_k1", "planar_conv_k3", "planar_conv_k3s2",
               "planar_conv_k3t2")
K6_KERNELS = ("res152_fused", "res152_fused_save", "res152_fused_grad")
# the remat route's and the c12 route's own kernels (K5, K6c)
NEW_KERNELS = ("fused_stem_bwd", "res152_fused_grad12")
# the experimental package's kernels (K7, K8a alone and with save_acts, K8b)
EXP_KERNELS = ("median_pool_2d_pallas", "median_pool_2d_pallas_network",
               "fused_stem_fwd_b", "fused_stem_fwd_b_save_acts",
               "fused_stem_bwd_b")
ROUTE_STEPS = 20   # timed steps of each of the other routes
# the EOT warp's kernel pair (launched once each a training step on every
# route) and its canvases at b24 from a 224 patch: (side, offset)
EOT_WARP = ("affine_warp_mxu", "affine_warp_mxu_bwd")
WARP_SHAPES = ((608, 192), (416, 96))

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense FLOP/s by type
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


T_START = time.perf_counter()


def log(*a):
    print(*a, flush=True)


def phase(name: str) -> None:
    log(f"[phase] {name} at {time.perf_counter() - T_START:.1f} s")


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


def device_ms(fn, iters=20, warmup=3, reps=3) -> float:
    """Device time of one ``fn()`` without the host's launch path:
    ``iters`` calls captured as one CUDA graph, ``reps`` replays of it
    between two CUDA events, over ``reps * iters``. Unlike ``time_ms`` it
    leaves out the gaps in which the device waits for the host to launch:
    a call whose kernels take tens of microseconds can be bound by its
    host-side launch. The events bracket every kernel of the replays, so
    none can be left out of the sum (a ``torch.profiler`` trace could
    drop one, and read low); what it adds is the graph's own gap between
    kernels, a microsecond or less."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * iters)


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
    and nowhere else. The default package's are ``ops``'
    ``LAUNCH_COUNTERS``; the experimental package's follow."""
    ops = import_port("ops")
    MPL = import_port("experimental.median_pallas")
    SB = import_port("experimental.stem_batched")
    out = {name: (getattr(import_port(f"ops.{mod}"), fn), attr)
           for name, (mod, fn, attr) in ops.LAUNCH_COUNTERS.items()}
    out.update({
        "median_pool_2d_pallas": (MPL.median_pool_2d_pallas, "launches"),
        "median_pool_2d_pallas_network": (MPL.median_pool_2d_pallas,
                                          "network_launches"),
        "fused_stem_fwd_b": (SB.fused_stem_fwd_b, "launches"),
        "fused_stem_fwd_b_save_acts": (SB.fused_stem_fwd_b,
                                       "save_acts_launches"),
        "fused_stem_bwd_b": (SB.fused_stem_bwd_b, "launches")})
    return out


def reset_counts() -> None:
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def bound(bytes_moved: int, flops: float, dtype) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stem_flops(b: int, h: int, conv5: bool = True) -> float:
    """Multiply-adds x 2 of stem convs 0,1,2,3 and (``conv5``) 5 on their
    real outputs."""
    h1, h5 = h // 2, h // 4
    macs = (h * h * 32 * 27 + h1 * h1 * 64 * 288 + h1 * h1 * 32 * 64
            + h1 * h1 * 64 * 288 + (h5 * h5 * 128 * 576 if conv5 else 0))
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


# the bfloat16 kernels that must run on the tensor cores: entry name of the
# kernels line -> its instantiations, each (label, library, its info
# function and arguments, a substring of the kernel's mangled name). K4:
# every (16-deep steps a chunk, channel width) of each variant
# (csrc/planar_conv.cu: wgk::valid)
_K4_KEYS = (("planar_conv_k1", 0, (1, 2, 4), (8, 16, 32, 64)),
            ("planar_conv_k3", 1, (1, 2, 4), (8, 16, 32, 64)),
            ("planar_conv_k3s2", 2, (1,), (8, 16, 32, 64)),
            ("planar_conv_k3t2", 3, (1, 2, 4), (8, 16, 32)))
TC_KERNELS = {
    "fused_stem_fwd": [("", "stem_fused", "apfp_fused_stem_fwd_info", (1, 0),
                        "fused_stem_fwd_wg_kernelILb0E")],
    "fused_stem_fwd_save_acts": [(
        "", "stem_fused", "apfp_fused_stem_fwd_info", (1, 1),
        "fused_stem_fwd_wg_kernelILb1E")],
    "fused_stem_bwd_saved": [("", "stem_bwd", "apfp_fused_stem_bwd_info",
                              (1,), "fused_stem_bwd_wg_kernel")],
    "fused_stem_bwd": [("", "stem_remat", "apfp_fused_stem_remat_info", (1,),
                        "fused_stem_remat_wg_kernel")],
    "fused_stem_fwd_b": [("", "stem_batched", "apfp_fused_stem_fwd_b_info",
                          (1, 0), "fused_stem_fwd_b_wg_kernelILb0E")],
    "fused_stem_fwd_b_save_acts": [(
        "", "stem_batched", "apfp_fused_stem_fwd_b_info", (1, 1),
        "fused_stem_fwd_b_wg_kernelILb1E")],
    "fused_stem_bwd_b": [("", "stem_batched", "apfp_fused_stem_bwd_b_info",
                          (1,), "fused_stem_bwd_b_wg_kernel")],
    "res152_fused": [("", "res_fused", "apfp_res152_fused_info", (1, 0),
                      "res152_fwd_wg_kernelILb0E")],
    "res152_fused_save": [("", "res_fused", "apfp_res152_fused_info", (1, 1),
                           "res152_fwd_wg_kernelILb1E")],
    "res152_fused_grad": [("", "res_fused", "apfp_res152_fused_grad_info",
                           (1, 0), "res152_bwd_wg_kernelILb0E")],
    "res152_fused_grad12": [("", "res_fused", "apfp_res152_fused_grad_info",
                             (1, 1), "res152_bwd_wg_kernelILb1E")],
    **{name: [(f"NS{ns}N{n}", "planar_conv", "apfp_planar_conv_info",
               (variant, ns, n),
               f"planar_conv_wg_kernelILi{variant}ELi{ns}ELi{n}EE")
              for ns in nss for n in ns_n]
       for name, variant, nss, ns_n in _K4_KEYS}}
K4_NAMES = tuple(name for name, *_ in _K4_KEYS)


# the kernels whose bfloat16 instantiation must not spill (every one of
# TC_KERNELS: K1, K1 save_acts, K2, K5, K8a, K8b, K6a, K6a save, K6b, K6c,
# K4), and K7, whose float32 and bfloat16 instantiations (each k of the
# network form, and the rank form) must not either
NO_SPILL = ("fused_stem_fwd", "fused_stem_fwd_save_acts",
            "fused_stem_bwd_saved", "fused_stem_bwd", "fused_stem_fwd_b",
            "fused_stem_fwd_b_save_acts", "fused_stem_bwd_b", "res152_fused",
            "res152_fused_save", "res152_fused_grad", "res152_fused_grad12",
            "median_pool_2d_pallas", *K4_NAMES)
# the kernels built for Hopper's own units (K1, K1 save_acts, K2, K5, K8a,
# K8a save_acts, K8b, K6a, K6a save, K6b, K6c, K4): wgmma and no mma.sync,
# and their weights (K2, K5, K8b: also their boxes; K4: its input) by bulk
# copies or the tensor unit: every kernel of TC_KERNELS
WGMMA_KERNELS = ("fused_stem_fwd", "fused_stem_fwd_save_acts",
                 "fused_stem_bwd_saved", "fused_stem_bwd", "fused_stem_fwd_b",
                 "fused_stem_fwd_b_save_acts", "fused_stem_bwd_b",
                 "res152_fused", "res152_fused_save", "res152_fused_grad",
                 "res152_fused_grad12", *K4_NAMES)
SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "UBLKCP")


def sass_op_counts(_cuda, path: str, ops) -> dict:
    """{kernel's mangled name: {op: count}}: the instructions of ``ops``
    (SASS mnemonics, each counted once a line, the first that matches)
    in every kernel of the library at ``path`` (``cuobjdump -sass``,
    beside ``nvcc``)."""
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        s = line.strip()
        if s.startswith("Function :"):
            fn = s.split(":", 1)[1].strip()
            counts[fn] = dict.fromkeys(ops, 0)
        elif fn is not None:
            for op in ops:
                if f" {op}." in s or f" {op} " in s:
                    counts[fn][op] += 1
                    break
    return counts


def tensor_core_check(_cuda, info) -> dict:
    """Phase 1: the tensor-core instructions (HMMA, HGMMA) and the
    tensor-unit and bulk copies (UTMALDG, UBLKCP) that
    ``cuobjdump -sass`` finds in each bfloat16 kernel instantiation of
    ``TC_KERNELS`` (K1, K1 ``save_acts``, K2, K5, K8a, K8a ``save_acts``,
    K8b, K6a, K6a ``save``, K6b, K6c and every K4 variant, chunk depth and
    channel width) in the built libraries, with ptxas' registers and spill
    bytes (``-Xptxas -v``), its note where it serialized a kernel's wgmmas,
    and the card's own account of registers, dynamic shared memory and
    blocks per multiprocessor (``apfp_*_info``). Fails if one has no
    tensor-core instruction, if one of ``NO_SPILL`` (K1, K2, K5, K8, K6,
    K4) spills, or if one of ``WGMMA_KERNELS`` (all of them) has an HMMA,
    no HGMMA or neither a UTMALDG nor a UBLKCP.
    Returns
    {entry name: record}; an entry of several instantiations holds them
    under ``sass``."""
    import ctypes
    import re
    counts, regs, spills, serial = {}, {}, {}, {}
    libs = {inst[1] for insts in TC_KERNELS.values() for inst in insts}
    for lib in libs:
        counts.update(sass_op_counts(_cuda, info[lib]["path"], SASS_OPS))
        fn = props = None
        for line in info[lib]["log"].splitlines():
            if "wgmma" in line and "serialized" in line:
                # ptxas' performance note: the function's wgmmas wait for
                # each other
                name = line.rsplit("'", 2)[-2] if "'" in line else line
                serial[name] = line.strip()
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif fn is not None and "Used" in line and "registers" in line:
                regs[fn] = line.strip()
            elif "Function properties for" in line:
                props = line.split("Function properties for", 1)[1].strip()
            elif props is not None and "spill stores" in line:
                spills[props] = sum(int(v) for v in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", line))
    out = {}
    for name, insts in TC_KERNELS.items():
        recs = {}
        for label, lib, info_fn, args, key in insts:
            fns = [f for f in counts if key in f]
            assert len(fns) == 1, (name, label, fns)
            c = counts[fns[0]]
            rec = {"hmma": c["HMMA"], "hgmma": c["HGMMA"],
                   "tma_loads": c["UTMALDG"], "bulk_copies": c["UBLKCP"],
                   "ptxas": regs.get(fns[0], ""),
                   "spill_bytes": spills.get(fns[0]),
                   "wgmma_serialized": serial.get(fns[0])}
            buf = (ctypes.c_int * 3)()
            _cuda.check(getattr(_cuda.lib(lib), info_fn)(*args, buf),
                        f"{name} info")
            rec.update(registers=buf[0], dynamic_smem_bytes=buf[1],
                       blocks_per_sm=buf[2])
            what = f"{name} {label}".strip()
            log(f"[sass] {what}: {rec['hmma']} HMMA, {rec['hgmma']} HGMMA, "
                f"{rec['tma_loads']} UTMALDG, {rec['bulk_copies']} UBLKCP; "
                f"{rec['registers']} registers, "
                f"{rec['dynamic_smem_bytes']} bytes of shared memory, "
                f"{rec['blocks_per_sm']} block(s) a multiprocessor, "
                f"{rec['spill_bytes']} bytes spilled; ptxas: "
                f"{rec['ptxas']}"
                + (f"; {rec['wgmma_serialized']}"
                   if rec["wgmma_serialized"] else ""))
            assert rec["hmma"] + rec["hgmma"] > 0, \
                f"{what}: no tensor-core instruction in its SASS"
            assert name not in NO_SPILL or rec["spill_bytes"] == 0, \
                f"{what}: spills {rec['spill_bytes']} bytes"
            if name in WGMMA_KERNELS:
                assert rec["hgmma"] > 0 and rec["hmma"] == 0, \
                    f"{what}: not on wgmma alone"
                assert rec["tma_loads"] + rec["bulk_copies"] > 0, \
                    f"{what}: no TMA or bulk copy"
            recs[label] = rec
        out[name] = recs[""] if list(recs) == [""] else {"sass": recs}
    return out


# the layout kernels (csrc/planar.cu): entry name of the kernels line ->
# (its apfp_planar_info selector, the kernel's mangled-name stem)
LAYOUT_KERNELS = {"to_planar": (0, "to_planar_narrow_kernel"),
                  "to_planar_phases": (0, "to_planar_narrow_kernel"),
                  "to_planar_g5": (1, "to_planar_tiled_kernel"),
                  "from_planar_narrow": (2, "from_planar_narrow_kernel"),
                  "from_planar": (3, "from_planar_tiled_kernel")}


def ptxas_records(log: str) -> dict:
    """{kernel's mangled name: {"ptxas": its "Used N registers" line,
    "stack_bytes", "spill_bytes"}} from a library's ``-Xptxas -v`` log."""
    import re
    recs, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn is not None and "stack frame" in line:
            recs.setdefault(fn, {}).update(
                stack_bytes=int(re.search(r"(\d+) bytes stack", line)[1]),
                spill_bytes=sum(int(v) for v in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", line)))
        elif fn is not None and "Used" in line and "registers" in line:
            recs.setdefault(fn, {})["ptxas"] = line.strip()
    return recs


# K7 is checked at these k: the network form at 1, 3, 4, 7 and 8, the
# rank-counting form at 9
K7_KS = (1, 3, 4, 7, 8, 9)


def median_resources(_cuda, info) -> dict:
    """Phase 1 for K7 (``csrc/median_pool.cu``): for the network form at
    every k of ``NET_KS`` and the rank-counting form, float32 and
    bfloat16, ptxas' registers, stack frame and spill bytes, the card's
    registers, shared memory and blocks per multiprocessor
    (``apfp_median_pool_info``), and the min/max (FMNMX) instructions of
    its SASS beside the ``median_net_minmax`` that the bound counts. Fails
    if one spills (K7 is in ``NO_SPILL``). Returns {"k<k>" (9: the rank
    form): {"bf16": record, "f32": record}}."""
    import ctypes
    MP = import_port("ops.median_pool")
    recs = ptxas_records(info["median_pool"]["log"])
    fmnmx = sass_op_counts(_cuda, info["median_pool"]["path"], ("FMNMX",))
    out = {}
    for k in MP.NET_KS + (9,):
        stem = (f"median_net_kernelI{{}}Li{k}EE" if k in MP.NET_KS
                else "median_rank_kernelI{}EE")
        out[f"k{k}"] = {}
        for label, code, tag in (("bf16", 1, "13__nv_bfloat16"),
                                 ("f32", 0, "f")):
            fns = [f for f in recs if stem.format(tag) in f]
            assert len(fns) == 1, (k, label, fns)
            rec = dict(recs[fns[0]])
            buf = (ctypes.c_int * 3)()
            _cuda.check(_cuda.lib("median_pool").apfp_median_pool_info(
                k, code, buf), f"K7 k {k} info")
            rec.update(registers=buf[0], smem_bytes=buf[1],
                       blocks_per_sm=buf[2],
                       sass_fmnmx=sum(c["FMNMX"] for f, c in fmnmx.items()
                                      if stem.format(tag) in f),
                       minmax_counted=(MP.median_net_minmax(k)
                                       if k in MP.NET_KS else None))
            form = "network" if k in MP.NET_KS else "rank"
            log(f"[k7] {form} form k {k} {label}: {rec['registers']} "
                f"registers, {rec['smem_bytes']} bytes of shared memory, "
                f"{rec['blocks_per_sm']} block(s) a multiprocessor, "
                f"{rec['sass_fmnmx']} FMNMX in its SASS (the bound counts "
                f"{rec['minmax_counted']}), "
                f"{rec['spill_bytes']} bytes spilled, {rec['stack_bytes']} "
                f"bytes of stack; ptxas: {rec['ptxas']}")
            assert "median_pool_2d_pallas" not in NO_SPILL or \
                rec["spill_bytes"] == 0, f"K7 k {k} {label} spills"
            out[f"k{k}"][label] = rec
    return out


def layout_resources(_cuda, info) -> dict:
    """Phase 1 for the layout kernels K3a and K3b (narrow and tiled
    forms, bfloat16 and float32 instantiations): ptxas' registers, stack
    frame and spill bytes and the card's registers, static shared memory
    and blocks per multiprocessor (``apfp_planar_info``). Fails if one
    spills. Returns {entry name: {"bf16": record, "f32": record}}."""
    import ctypes
    recs = ptxas_records(info["planar"]["log"])
    out = {}
    for name, (which, stem) in LAYOUT_KERNELS.items():
        out[name] = {}
        for label, code, tag in (("bf16", 1, "t"), ("f32", 0, "j")):
            fns = [f for f in recs if f"{stem}I{tag}E" in f]
            assert len(fns) == 1, (name, label, fns)
            rec = dict(recs[fns[0]])
            buf = (ctypes.c_int * 3)()
            _cuda.check(_cuda.lib("planar").apfp_planar_info(which, code, buf),
                        f"{name} info")
            rec.update(registers=buf[0], static_smem_bytes=buf[1],
                       blocks_per_sm=buf[2])
            log(f"[layout] {name} {label}: {rec['registers']} registers, "
                f"{rec['static_smem_bytes']} bytes of shared memory, "
                f"{rec['blocks_per_sm']} block(s) a multiprocessor, "
                f"{rec['spill_bytes']} bytes spilled, {rec['stack_bytes']} "
                f"bytes of stack; ptxas: {rec['ptxas']}")
            assert rec["spill_bytes"] == 0, f"{name} {label} spills"
            out[name][label] = rec
    return out


def import_port(name: str):
    import importlib
    return importlib.import_module(f"{PORT}.{name}")


def layout_entry(name: str, line: int, make, shape, library_is: str,
                 sub: bool = False) -> dict:
    """A layout kernel's (K3a, K3b) entry of the kernels line, or with
    ``sub`` the record of one more shape of it: ``make(dtype)`` ->
    (kernel call, the same launch into given output blocks, plain call,
    library call, input bytes). In bfloat16 and float32 the kernel's
    outputs, written into blocks filled with NaN and by the wrapper into
    its own, must equal the plain version's bit for bit; both are timed
    beside the byte bound (inputs at what the function reads, outputs
    whole) and the library call, by CUDA events (``ms``, ``library_ms``)
    and by their device time without host-launch gaps (``device_ms``,
    ``library_device_ms``)."""
    out = {"name": name, "route": "cuda",
           "source": f"{PORT}/csrc/planar.cu",
           "replaces": f"{JAX_PKG}/ops/planar_conv.py:{line}",
           "launches": 0, "shape": list(shape), "dtype": "bfloat16",
           "library_is": library_is}
    for dt in (torch.bfloat16, torch.float32):
        run, into, plain, library, read_bytes = make(dt)
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        nans = tuple(torch.full_like(t, float("nan")) for t in want)
        got = into(nans)
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want) and all(
            g is n for g, n in zip(got, nans)), f"{name}: not in place"
        ran = run()
        ran = ran if isinstance(ran, tuple) else (ran,)
        torch.cuda.synchronize()
        for outs, how in ((got, "into NaN blocks"), (ran, "wrapper")):
            assert len(outs) == len(want) and all(
                torch.equal(g, w) for g, w in zip(outs, want)), \
                f"{name} {dt} ({how}) differs from its plain version"
        b_ms, b_by = bound(read_bytes + nbytes(*got), 0.0, dt)
        t = {"max_abs_err": 0.0, "tol": 0.0, "ms": time_ms(run),
             "plain_ms": time_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": time_ms(library),
             "device_ms": device_ms(run),
             "library_device_ms": device_ms(library)}
        del got, ran, nans, want
        if dt == torch.bfloat16:
            out.update(t)
        else:
            out["f32"] = t
    if not sub:
        return out
    return {k: out[k] for k in ("shape", "max_abs_err", "tol", "ms",
                                "plain_ms", "bound_ms", "bound_by",
                                "library_ms", "library_is", "device_ms",
                                "library_device_ms", "f32")}


def k2_read_bytes(acts, g5p) -> int:
    """K2's input bytes: the masks, y5 and g5 at their image lanes and
    real channels."""
    y5, *masks = acts
    h1, h5 = masks[0].shape[1] // 2, y5.shape[1]
    return (sum(image_bytes(m, h1, m.shape[2]) for m in masks)
            + image_bytes(y5, h5, 128) + image_bytes(g5p, h5, 128))


def wgmma_bitcheck(dev, sp) -> list:
    """The wgmma kernels sum one 16-deep step after another from a zero
    float32 accumulator, as the mma.sync kernels they replaced did; their
    outputs equal those kernels' bit for bit only if a wgmma k16 step
    rounds as an mma.sync one. On the stem's operands
    (conv5's weights in tap order, its first 64 channels; leaky
    activations of the stem's scale, numpy-seeded) at depths 64 and 576:
    ``ops/stem_fused.py: wgmma_bitcheck`` runs both in one launch and
    every bit must agree. Returns a record a depth."""
    SF = import_port("ops.stem_fused")
    rng = np.random.default_rng(SEED + 18)
    w5 = sp[4][0].reshape(576, 128)[:, :64].contiguous()
    recs = []
    for depth in (64, 576):
        a = rng.standard_normal((64, depth))
        a = torch.tensor(np.where(a > 0, a, 0.1 * a), dtype=torch.bfloat16,
                         device=dev)
        d_mma, d_wg = SF.wgmma_bitcheck(a, w5[:depth].contiguous())
        differ = int((d_mma.view(torch.int32)
                      != d_wg.view(torch.int32)).sum().item())
        recs.append({"depth": depth, "outputs": d_mma.numel(),
                     "differing_bits": differ,
                     "max_abs": d_wg.abs().max().item()})
        assert differ == 0, recs[-1]
    return recs


def wgmma_calls(dev, sp, sbp, b: int) -> dict:
    """The bfloat16 wgmma stem kernels at batch b, 608^2, on seeded inputs:
    entry name -> (library, a call). K1 (forward alone and with
    ``save_acts``), K2 on K1's masks, K5 on the same x, y5 and g5, K8b on
    K8a's activations of the same x (its gp5dd from g5 gated by K8a's y5,
    as ``FusedStemBatched.backward`` builds it)."""
    SF = import_port("ops.stem_fused")
    SB = import_port("experimental.stem_batched")
    PC = import_port("ops.planar_conv")
    bf16, h1, h5 = torch.bfloat16, SIZE // 2, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    x = torch.rand(b, SIZE, SIZE, 3, generator=gen, device=dev).to(bf16)
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
    xe, xo = SF.split_phases(x)
    acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
    g5p = PC.to_planar(g5)
    seg = SB._seg(h1)
    bacts = SB.fused_stem_fwd_b(*SB.split_phases_b(x, seg), sp, b,
                                save_acts=True)
    y5n = SB.batched_to_nhwc(bacts[0], b, h5, 128, lane0=1, stride=2)
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols((g5.float() * torch.where(
            y5n > 0, 1.0, 0.1)).to(bf16))), seg)
    return {"fused_stem_fwd": ("stem_fused",
                               lambda: SF.fused_stem_fwd(xe, xo, sp)),
            "fused_stem_fwd_save_acts": ("stem_fused", lambda: SF.
                                         fused_stem_fwd(xe, xo, sp, True)),
            "fused_stem_bwd_saved": ("stem_bwd", lambda: SF.
                                     fused_stem_bwd_saved(acts, g5p, sbp)),
            "fused_stem_bwd": ("stem_remat", lambda: SF.fused_stem_bwd(
                xe, xo, acts[0], g5p, sp, sbp)),
            "fused_stem_bwd_b": ("stem_batched", lambda: SB.
                                 fused_stem_bwd_b(gp5dd, bacts, sbp, b))}


def wgmma_device_times(dev, sp, sbp, b: int) -> dict:
    """Device ms (``device_ms``: a CUDA graph of 20 calls) of the bfloat16
    wgmma stem kernels (``wgmma_calls``: K1 alone and with ``save_acts``,
    K2, K5, K8b) at batch b, 608^2."""
    out = {name: device_ms(fn)
           for name, (_, fn) in wgmma_calls(dev, sp, sbp, b).items()}
    torch.cuda.empty_cache()
    return out


def lap_split(calls: dict, dev_ms: dict, tag: str = "") -> dict:
    """Where calls' kernel time goes (``calls``: entry name -> (library, a
    call)): the libraries rebuilt with ``-DAPFP_PROFILE`` (``ops/_cuda.py:
    profiled``), in which thread 0 of each block (a consumer of the first
    warpgroup) adds the clock64 cycles between its laps to a category
    (``csrc/stem_common.cuh: wg::Lap``: loads, input waits, weight waits,
    MMAs, epilogues, mask stores or conversions, output stores, the
    consumers' barriers), over 3 calls after one. Shares are of the summed
    cycles (categories with none left out); ``split_ms`` applies them to
    the normal build's device time (``dev_ms``, by entry name); the
    profiled build's own time is beside it (the laps cost a little). With
    a ``tag``, a ``[tag]`` line a call. Empties ``calls``."""
    _cuda = import_port("ops._cuda")
    out = {}
    with _cuda.profiled(*sorted({lib for lib, _ in calls.values()})):
        for name, (lib, fn) in calls.items():
            fn()
            torch.cuda.synchronize()
            _cuda.prof_take(lib)
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            cycles = _cuda.prof_take(lib)
            total = sum(cycles.values())
            share = {k: v / total for k, v in cycles.items() if v}
            out[name] = {"share": share,
                         "split_ms": {k: v * dev_ms[name]
                                      for k, v in share.items()},
                         "profiled_dev_ms": device_ms(fn)}
            if tag:
                log(f"[{tag}] {name} b24: dev {dev_ms[name]:.4f} ms; "
                    + json.dumps({k: round(v, 4) for k, v in share.items()})
                    + f"; profiled build {out[name]['profiled_dev_ms']:.4f}"
                    " ms")
    calls.clear()
    torch.cuda.empty_cache()
    return out


def wgmma_split(dev, sp, sbp, dev_ms: dict) -> dict:
    """Where the bfloat16 wgmma stem kernels' time goes at b24 (K1 both
    forms, K2, K5, K8b; ``wgmma_calls``): ``lap_split``."""
    return lap_split(wgmma_calls(dev, sp, sbp, TRAIN_BATCH), dev_ms)


K8A_ROWS = ("fused_stem_fwd_b", "fused_stem_fwd_b_save_acts")
K8A_OUTPUTS = ("y5", "y0e", "y0o", "y1", "y2", "y3")


def k8a_calls(dev, sp, b: int) -> dict:
    """The bfloat16 K8a at batch b, 608^2, on a seeded x (phase 9's seed):
    entry name -> a call, the forward alone and with ``save_acts``."""
    SB = import_port("experimental.stem_batched")
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x = torch.rand(b, SIZE, SIZE, 3, generator=gen, device=dev)
    xe, xo = SB.split_phases_b(x.to(torch.bfloat16), SB._seg(SIZE // 2))
    return {"fused_stem_fwd_b": lambda: SB.fused_stem_fwd_b(xe, xo, sp, b),
            "fused_stem_fwd_b_save_acts": lambda: SB.fused_stem_fwd_b(
                xe, xo, sp, b, save_acts=True)}


def k8a_split(dev, sp, dev_ms: dict) -> dict:
    """Where the bfloat16 K8a's time goes at b24 (``k8a_calls``, both
    forms: the x load, weight waits, MMAs, epilogues, stores, barriers):
    ``lap_split``, a ``[k8a-split]`` line a form."""
    return lap_split({n: ("stem_batched", fn) for n, fn in k8a_calls(
        dev, sp, TRAIN_BATCH).items()}, dev_ms, "k8a-split")


def training_kernels(dev, sp, sbp, card, tc_info) -> tuple:
    """Phase 5: K1 save_acts, K2 and K3a (g5, gp12) against their plain
    versions at batch 24, 608^2, bfloat16 (K2 and K3a also float32), K1
    and K2 beside the stem on cuDNN (``stem_yardstick``), the wgmma k16
    step against mma.sync's bits (``wgmma_bitcheck``), the device times
    of K1 (both forms), K2, K5 and K8b at b8 and b24
    (``wgmma_device_times``) and their b24 split by cycle accounts
    (``wgmma_split``); returns their entries of the kernels line (launches
    filled in by the training phase), with phase 1's tensor-core records,
    and the b24 records of ``split_phases`` and K3b (y5) by entry name,
    with K1's serving device times and split under ``fused_stem_fwd`` and
    ``fused_stem_fwd_split_b24``, K5's and K8b's under ``<name>_dev_ms``
    and ``<name>_split_b24``."""
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
    walk = stem_yardstick(x, sp)
    log(f"[train-kernel] the stem on cuDNN, b24 bfloat16: {json.dumps(walk)} "
        f"({card})")

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
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": walk["fwd_ms"],
        "library_is": "the stem on cuDNN (stem_conv_walk), bfloat16, "
                      "forward, b24 (no masks)",
        **tc_info["fused_stem_fwd_save_acts"]})
    del want

    # K3a's tiled form at the cotangent g5's shape and at gp12's (the c12
    # route's [24, 76, 76, 256] -> [24, 76, 256, 128]); split_phases and
    # K3b (y5) at b24
    def nhwc_at(t):
        def make(dt):
            u = t.to(dt)
            wl = PC._round_up(u.shape[2] + 2, 128)
            view = u.permute(0, 1, 3, 2)
            return (lambda: PC.to_planar(u),
                    lambda o: PC._to_planar_into(u, o[0]),
                    lambda: PC.to_planar_plain(u),
                    lambda: F.pad(view, (1, wl - u.shape[2] - 1)), nbytes(u))
        return make
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
    g5p = PC.to_planar(g5)
    k3a = layout_entry("to_planar_g5", 124, nhwc_at(g5), g5.shape,
                       "F.pad on the transposed view")
    gp12 = torch.randn(b, h5 // 2, h5 // 2, 256, generator=gen, device=dev)
    k3a["gp12"] = layout_entry("to_planar_g5", 124, nhwc_at(gp12),
                               gp12.shape, "F.pad on the transposed view",
                               sub=True)
    del gp12
    out.append(k3a)

    def phases_at(dt):
        u = x.to(dt)
        pads = [(1, wlh - w - 1, 0, 5) for w in (h1, h1)]
        return (lambda: SF.split_phases(u),
                lambda o: PC._to_planar_phases_into(u, *o, 8),
                lambda: (PC.to_planar_plain(u, 8, 2, 0),
                         PC.to_planar_plain(u, 8, 2, 1)),
                lambda: [F.pad(u[:, :, o::2].permute(0, 1, 3, 2), pads[o])
                         for o in (0, 1)], nbytes(u))

    def y5_at(dt):
        y = y5.to(dt)
        view = y[:, :, :128, 1:h5 + 1].permute(0, 1, 3, 2)
        return (lambda: PC.from_planar(y, h5, 128),
                lambda o: PC._from_planar_into(y, o[0], h5, 128),
                lambda: PC.from_planar_plain(y, h5, 128),
                view.contiguous, image_bytes(y, h5, 128))
    b24 = {"to_planar_phases": layout_entry(
               "to_planar_phases", 124, phases_at, x.shape,
               "two F.pad calls on the phases' transposed views", sub=True),
           "from_planar": layout_entry(
               "from_planar", 170, y5_at, y5.shape,
               ".contiguous() of the image-lane view", sub=True)}

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
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": walk["bwd_ms"],
        "library_is": "the stem on cuDNN (stem_conv_walk), bfloat16, input "
                      "backward alone on a retained graph, b24",
        "library_fwd_bwd_ms": walk["fwd_bwd_ms"],
        **tc_info["fused_stem_bwd_saved"]}
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
    # the wgmma kernels: the k16 step's bits, and device times at b8, b24
    bits = wgmma_bitcheck(dev, sp)
    k2["wgmma_bitcheck"] = bits
    log(f"[wgmma] k16 step against mma.sync on the stem's operands: "
        f"{json.dumps(bits)}")
    dev_ms = {b: wgmma_device_times(dev, sp, sbp, b) for b in (8, 24)}
    for k in out:
        if k["name"] in ("fused_stem_fwd_save_acts", "fused_stem_bwd_saved"):
            k["dev_ms"] = {f"b{b}": t[k["name"]] for b, t in dev_ms.items()}
    b24["fused_stem_fwd"] = {f"b{b}": t["fused_stem_fwd"]
                             for b, t in dev_ms.items()}
    split = wgmma_split(dev, sp, sbp, dev_ms[24])
    for k in out:
        if k["name"] in split:
            k["split_b24"] = split[k["name"]]
    b24["fused_stem_fwd_split_b24"] = split["fused_stem_fwd"]
    # K5's and K8b's, for their entries (phases 5 and 9)
    for name in ("fused_stem_bwd", "fused_stem_bwd_b"):
        b24[f"{name}_dev_ms"] = {f"b{b}": t[name] for b, t in dev_ms.items()}
        b24[f"{name}_split_b24"] = split[name]
    for name, rec in split.items():
        log(f"[wgmma] {name} b24 split: "
            f"{json.dumps({k: round(v, 4) for k, v in rec['share'].items()})}"
            f"; profiled build {rec['profiled_dev_ms']:.4f} ms ({card})")
    for name in dev_ms[24]:
        rec = tc_info[name]
        log(f"[wgmma] {name}: dev ms "
            f"{json.dumps({f'b{b}': t[name] for b, t in dev_ms.items()})}; "
            f"{rec['registers']} registers, {rec['dynamic_smem_bytes']} "
            f"bytes of shared memory, {rec['blocks_per_sm']} block(s) a "
            f"multiprocessor ({card})")
    for k in out:
        log(f"[train-kernel] {k['name']}: err {k['max_abs_err']:.3g} "
            f"(tol {k['tol']:.3g}), {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}) ({card})")
    log(f"[train-kernel] K1 mask flips {out[0]['mask_flips']} of "
        f"{n_mask}; K3a gp12 {json.dumps(out[1]['gp12'])}; K2 f32 "
        f"{json.dumps(k2['f32'])}")
    for name, r in b24.items():
        log(f"[train-kernel] {name} b24: {json.dumps(r)} ({card})")
    return out, b24


def flip_zone(acts, plain_acts, h: int, radius: int = 12, extra=None):
    """[B, H, H] bool: the input pixels within ``radius`` of a position
    where the kernel's masks and the plain forward's differ in any channel
    (a gate flipped by summation order; the JAX tests' sign-safe mask), or
    of a pixel set in ``extra`` ([B, H, H] bool), and the number of flipped
    mask elements."""
    SF = import_port("ops.stem_fused")
    PC = import_port("ops.planar_conv")
    h1 = h // 2
    flips = sum(int((k != p).sum().item())
                for k, p in zip(acts[1:], plain_acts[1:]))
    zone = (SF.merge_phases(acts[1], acts[2], h1, 32)
            != SF.merge_phases(plain_acts[1], plain_acts[2], h1, 32)).any(-1)
    for k, p in zip(acts[3:], plain_acts[3:]):
        c = k.shape[2]
        d = (PC.from_planar_plain(k, h1, c)
             != PC.from_planar_plain(p, h1, c)).any(-1)
        zone = zone | d.repeat_interleave(2, 1).repeat_interleave(2, 2)
    if extra is not None:
        zone = zone | extra
    zone = torch.nn.functional.max_pool2d(
        zone[:, None].float(), 2 * radius + 1, 1, radius)[:, 0] > 0
    return zone, flips


def remat_kernel(dev, sp, sbp, card, walk_fwd_bwd_ms, tc_info) -> dict:
    """Phase 5, K5 at batch 24, 608^2, bfloat16 and float32, against K2 on
    K1's save_acts masks of the same x: in either dtype K5 recomputes the
    masks with K1's own arithmetic and runs K2's chain, so its gx must
    equal K2's bit for bit (``torch.equal``; a recomputed sign that
    differed from K1's mask would move gx near it); against the plain chain
    on those masks at K2's tolerances everywhere; then against its own
    plain version, which recomputes the masks in cuDNN's order: the same
    tolerances outside 12 pixels of a gate where K1's masks (K5's signs)
    and the plain ones differ, at most 1e-5 of the mask elements. Returns
    K5's entry of the kernels line, beside the stem's cuDNN forward +
    input backward at b24 bfloat16 (K5 recomputes the forward), with
    phase 1's tensor-core record."""
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    bf16 = torch.bfloat16
    b, h, h1, h5 = TRAIN_BATCH, SIZE, SIZE // 2, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    x = torch.rand(b, h, h, 3, generator=gen, device=dev).to(bf16)
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
    ent = {"name": "fused_stem_bwd", "route": "cuda",
           "source": f"{PORT}/csrc/stem_remat.cu",
           "replaces": f"{JAX_PKG}/ops/stem_fused.py:965", "launches": 0,
           "library_ms": walk_fwd_bwd_ms,
           "library_is": "the stem on cuDNN (stem_conv_walk), bfloat16, "
                         "forward + input backward, b24",
           "dtype": "bfloat16", **tc_info["fused_stem_bwd"]}

    def merged(t):
        return SF.merge_phases(*t, h1, 3).float()

    for dt in (bf16, torch.float32):
        spd = sp if dt == bf16 else [(w.float(), bb) for w, bb in sp]
        sbpd = sbp if dt == bf16 else SF.stem_bwd_params(spd)
        xe, xo = SF.split_phases(x.to(dt))
        g5p = PC.to_planar(g5.to(dt))
        acts = SF.fused_stem_fwd(xe, xo, spd, save_acts=True)
        k2 = SF.fused_stem_bwd_saved(acts, g5p, sbpd)
        torch.full(xe.shape, float("nan"), dtype=dt, device=dev)
        got = SF.fused_stem_bwd(xe, xo, acts[0], g5p, spd, sbpd)
        torch.cuda.synchronize()
        for gk in got:
            assert not gk[..., 0].any() and not gk[..., h1 + 1:].any()
            assert not gk[:, :, 3:].any()
        unequal = sum(int((gk != kk).sum().item()) for gk, kk in zip(got, k2))
        n_mask = sum(m.numel() for m in acts[1:])
        chain = SF.fused_stem_bwd_saved_plain(acts, g5p, sbpd)
        rel_tol = 2e-5 if dt == torch.float32 else 2.0 ** -6
        e = (merged(got) - merged(chain)).abs()
        scale = merged(chain).abs().max().item()
        tol = rel_tol * scale
        r = {"vs_k2_unequal_elements": unequal,
             "vs_k2_equal": all(torch.equal(gk, kk)
                                for gk, kk in zip(got, k2)),
             "gx_elements": sum(gk.numel() for gk in got),
             "same_masks_max_abs_err": e.max().item(),
             "same_masks_mean_abs_err": e.mean().item(), "tol": tol}
        log(f"[k5] {dt}: gx vs K2 on K1's masks: {unequal} of "
            f"{r['gx_elements']} elements differ (K5's recomputed signs "
            f"against K1's masks: bit for bit); vs the plain chain on them "
            f"{r['same_masks_max_abs_err']:.3g} (tol {tol:.3g})")
        assert r["vs_k2_equal"] and unequal == 0, (dt, r)
        assert r["same_masks_max_abs_err"] <= tol, (dt, r)
        assert r["same_masks_mean_abs_err"] <= 1e-4 * scale, (dt, r)
        del chain, k2, e
        # its own plain version: the masks recomputed by cuDNN, against
        # K5's own signs (K1's masks)
        own = SF.fused_stem_bwd_plain(xe, xo, acts[0], g5p, spd, sbpd)
        plain_acts = SF.fused_stem_fwd_plain(xe, xo, spd, save_acts=True)
        zone, flips = flip_zone(acts, plain_acts, h)
        del plain_acts
        e = (merged(got) - merged(own)).abs().amax(-1)
        err_out = e[~zone].max().item() if (~zone).any() else 0.0
        r.update(max_abs_err=e.max().item(), mean_abs_err=e.mean().item(),
                 max_abs_err_outside_flips=err_out, mask_flips=flips,
                 mask_elements=n_mask,
                 flip_zone_frac=zone.float().mean().item(),
                 tol_applies_to="same_masks_max_abs_err and "
                                "max_abs_err_outside_flips")
        assert flips <= 1e-5 * n_mask, (flips, n_mask)
        assert err_out <= tol, r
        del own, e, zone
        in_bytes = (2 * image_bytes(xe, h1, 3) + image_bytes(acts[0], h5, 128)
                    + image_bytes(g5p, h5, 128))
        b_ms, b_by = bound(in_bytes + nbytes(*got),
                           stem_flops(b, h, conv5=False) + stem_flops(b, h),
                           dt)
        r.update(ms=time_ms(lambda: SF.fused_stem_bwd(
                     xe, xo, acts[0], g5p, spd, sbpd), 5),
                 plain_ms=time_ms(lambda: SF.fused_stem_bwd_plain(
                     xe, xo, acts[0], g5p, spd, sbpd), 3),
                 k2_ms=time_ms(lambda: SF.fused_stem_bwd_saved(
                     acts, g5p, sbpd), 5),
                 bound_ms=b_ms, bound_by=b_by)
        del got, acts
        log(f"[k5] {dt}: vs own plain {r['max_abs_err']:.3g} ({flips} mask "
            f"flips, outside their zone {err_out:.3g}); {r['ms']:.4f} ms vs "
            f"plain {r['plain_ms']:.4f}, K2 {r['k2_ms']:.4f}, bound "
            f"{b_ms:.4f} ({b_by}) ({card})")
        if dt == bf16:
            ent.update(r, shape=list(xe.shape),
                       gflop=(stem_flops(b, h, conv5=False)
                              + stem_flops(b, h)) / 1e9)
        else:
            ent["f32"] = r
    return ent


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
    """Layers 0-5 as cuDNN convs (for float32 the caller turns TF32 off):
    NHWC x -> NHWC y5, the reference of the stem-level gradient check and,
    in bfloat16, the yardstick of K1, K2 and K5 (``stem_yardstick``)."""
    def conv(u, w, b, s):
        y = torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1),
                                       b.to(u.dtype), s,
                                       (w.shape[0] - 1) // 2)
        return torch.where(y > 0, y, 0.1 * y)
    v = x.permute(0, 3, 1, 2)
    y1 = conv(conv(v, *sp[0], 1), *sp[1], 2)
    y3 = conv(conv(y1, *sp[2], 1), *sp[3], 1)
    return conv(y3 + y1, *sp[4], 2).permute(0, 2, 3, 1)


def stem_yardstick(x, sp, backward=True) -> dict:
    """The whole stem on cuDNN (``stem_conv_walk``, bfloat16) at x's shape,
    timed as the yardstick of the stem kernels (the port never calls it):
    the forward, and with ``backward`` the input backward alone (on a
    retained graph) and forward + input backward."""
    with torch.no_grad():
        out = {"fwd_ms": time_ms(lambda: stem_conv_walk(x, sp), 5)}
    if backward:
        xr = x.detach().requires_grad_(True)
        g5 = torch.randn(x.shape[0], x.shape[1] // 4, x.shape[2] // 4, 128,
                         generator=torch.Generator(device=x.device)
                         .manual_seed(SEED + 30), device=x.device).to(x.dtype)
        y5 = stem_conv_walk(xr, sp)
        out["bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            y5, xr, g5, retain_graph=True), 5)
        del y5
        out["fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
            stem_conv_walk(xr, sp), xr, g5), 5)
    return out


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
        # the default training route is unchanged: no K4, K5, K6 or K6c
        assert darknet.last_routes()["res152"] == "conv"
        assert all(launches[k] == 0 for k in K4_VARIANTS + K6_KERNELS
                   + NEW_KERNELS + EXP_KERNELS), launches
        for k in TRAIN_PATH + EOT_WARP:
            assert launches[k] > 0, f"kernel {k} did not launch in training"
        # split_phases: one K3a launch (both column phases) a stem forward
        assert launches["to_planar_phases"] == (
            launches["fused_stem_fwd"]
            + launches["fused_stem_fwd_save_acts"]), launches
        assert launches["to_planar"] == 0, launches
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


def stage_conv_walk(y5, fwd):
    """Layers 6-11 as cuDNN convs on NHWC y5 (the caller turns TF32 off
    for float32): the stage-level gradient checks' reference and the K6
    yardstick. ``fwd``: the stage's (HWIO weight, float32 bias) pairs."""
    def conv(u, w, b):
        y = torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1),
                                       b.to(u.dtype), 1, (w.shape[0] - 1) // 2)
        return torch.where(y > 0, y, 0.1 * y)
    (w6, b6), (w7, b7), (w9, b9), (w10, b10) = fwd
    v = y5.permute(0, 3, 1, 2)
    y8 = conv(conv(v, w6, b6), w7, b7) + v
    return (conv(conv(y8, w9, b9), w10, b10) + y8).permute(0, 2, 3, 1)


def check_k4(conv, xp, w, b, res=None, *, k, stride=1, slope=0.1, w_img,
             gate=None, cin_real=None, t2=False, iters=5):
    """One K4 geometry of the planar routes: the kernel against
    ``planar_conv_plain`` on the same inputs (float32: 2e-5 of the output
    scale, summation order; bfloat16: two bf16 ulps of it, a rounding
    flipped by the order, and a mean below 1e-4 of it), its zero lanes,
    its time beside its bound, the plain version's and the cuDNN call of
    the same function alone (channels_last). Returns (record, output).
    ``t2``: the stride-2 adjoint variant ``planar_conv_t2`` on the
    unexpanded cotangent ``xp`` at width ``w_img`` (its plain version the
    zero interleave then the stride-1 conv; its cuDNN call
    ``F.conv_transpose2d`` with stride 2); its bytes and FLOPs are the
    real ones (9 tap products per 2 x 2 outputs)."""
    PC = import_port("ops.planar_conv")
    _cuda = import_port("ops._cuda")
    F = torch.nn.functional
    dt = xp.dtype
    bsz, h, _, _ = xp.shape
    cin_real = cin_real or w.shape[2]
    cout = w.shape[-1]
    if t2:
        kw = dict(w_img=w_img, gate=gate)

        def kern():
            return PC.planar_conv_t2(xp, w, b, **kw)

        def plain():
            return PC.planar_conv_t2_plain(xp, w, b, **kw)
        ho, wo = 2 * h, 2 * w_img
        flops = 2.0 * bsz * h * w_img * cout * 9 * cin_real
    else:
        kw = dict(k=k, stride=stride, slope=slope, w_img=w_img, gate=gate)

        def kern():
            return PC.planar_conv(xp, w, b, res, **kw)

        def plain():
            return PC.planar_conv_plain(xp, w, b, res, **kw)
        ho, wo = h // stride, w_img // stride
        flops = 2.0 * bsz * ho * wo * cout * k * k * cin_real
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    scale = max(want.float().abs().max().item(), 1e-30)
    e = (got.float() - want.float()).abs()
    err, mean_err = e.max().item(), e.mean().item()
    del want, e
    tol = (2e-5 if dt == torch.float32 else 2.0 ** -6) * scale
    assert err <= tol and mean_err <= 1e-4 * scale, (conv, err, mean_err,
                                                     scale)
    assert not got[..., 0].any() and not got[..., wo + 1:].any(), conv
    read = bsz * h * w_img * cin_real * xp.element_size()
    read += sum(image_bytes(t, wo, cout) for t in (res, gate)
                if t is not None)
    b_ms, b_by = bound(read + nbytes(got), flops, dt)
    x_cl = torch.randn(bsz, cin_real, h, w_img, device=xp.device).to(
        dt).contiguous(memory_format=torch.channels_last)
    if t2:
        # conv_transpose2d's weight is the forward conv's OIHW kernel
        # [cin, cout, 3, 3]: w is its flipped, channel-swapped HWIO
        w_cl = torch.flip(w[:, :, :cin_real], (0, 1)).permute(
            2, 3, 0, 1).contiguous(memory_format=torch.channels_last)

        def lib_call():
            return F.conv_transpose2d(x_cl, w_cl, None, 2, 1, 1)
    else:
        w_cl = w[:, :, :cin_real].permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def lib_call():
            return F.conv2d(x_cl, w_cl, None, stride, (k - 1) // 2)
    with _cuda.no_tf32():
        lib = time_ms(lib_call, iters)
        plain_ms = time_ms(plain, max(2, iters // 2), 1)
    rec = {"conv": conv, "variant": "t2" if t2 else f"k{k}s{stride}",
           "k": k, "stride": stride, "cin": cin_real,
           "cout": cout, "shape": list(xp.shape), "w_img": w_img,
           "dtype": str(dt).replace("torch.", ""), "res": res is not None,
           "gate": gate is not None, "slope": None if t2 else slope,
           "expanded": False,
           "max_abs_err": err, "tol": tol, "mean_abs_err": mean_err,
           "ms": time_ms(kern, iters), "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "gflop": flops / 1e9,
           "library_ms": lib,
           "library": ("F.conv_transpose2d, stride 2" if t2
                       else "F.conv2d")}
    del x_cl
    return rec, got


def planar_kernels(dev, model, card) -> list:
    """Phase 7, K4: every geometry the planar routes launch at full width,
    on the bfloat16 model's route weights: the stem forward (bfloat16 at
    b24, float32 at b8), the planar stem's backward convs at b24 (the
    two stride-2 adjoints as the k3t2 variant on the unexpanded cotangent;
    gate and res), the 152^2 stage's convs forward and backward at b24.
    Returns the per-geometry records."""
    PC = import_port("ops.planar_conv")
    PSP = import_port("models.stem_planar")
    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    recs = []

    def run(name, *a, **kw):
        rec, out = check_k4(name, *a, **kw)
        recs.append(rec)
        log(f"[k4] {name} {rec['dtype']}: err {rec['max_abs_err']:.3g} "
            f"(tol {rec['tol']:.3g}), {rec['ms']:.4f} ms vs plain "
            f"{rec['plain_ms']:.4f}, cuDNN alone {rec['library_ms']:.4f}, "
            f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}) ({card})")
        return out

    fwd, bwd = model.planar_stem_params()
    x8 = torch.rand(BATCH, SIZE, SIZE, 3, generator=gen, device=dev)
    x24 = torch.rand(TRAIN_BATCH, SIZE, SIZE, 3, generator=gen,
                     device=dev).to(bf16)
    h1 = SIZE // 2
    # bfloat16 at the step's b24, float32 (the golden checks' dtype) at b8
    for dt, x in ((bf16, x24), (f32, x8)):
        f = fwd if dt == bf16 else [(w.float(), b) for w, b in fwd]
        xp = PC.to_planar(x.to(dt), c_pad=8)
        y0 = run("stem_fwd_conv0", xp, *f[0], k=3, w_img=SIZE, cin_real=3)
        y1 = run("stem_fwd_conv1", y0, *f[1], k=3, stride=2, w_img=SIZE)
        y2 = run("stem_fwd_conv2", y1, *f[2], k=1, w_img=h1)
        y3 = run("stem_fwd_conv3", y2, *f[3], k=3, w_img=h1)
        run("stem_fwd_conv5", y3 + y1, *f[4], k=3, stride=2, w_img=h1)
        del xp, y0, y1, y2, y3
    # the backward at b24 on the kernels' own forward activations
    y0, y1, y2, y3, y5 = PSP._forward(x24, fwd)
    g5 = torch.randn(TRAIN_BATCH, SIZE // 4, SIZE // 4, 128, generator=gen,
                     device=dev).to(bf16)
    gp5 = PC.leaky_bwd_planar(PC.to_planar(g5), y5)
    del g5, y5
    g_sc = run("stem_bwd_conv5", gp5, *bwd[4], k=3, w_img=SIZE // 4,
               t2=True, iters=3)
    gp3 = PC.leaky_bwd_planar(g_sc, y3)
    gp2 = run("stem_bwd_conv3", gp3, *bwd[3], k=3, slope=None, gate=y2,
              w_img=h1, iters=3)
    gp1 = run("stem_bwd_conv2", gp2, *bwd[2], g_sc, k=1, slope=None,
              gate=y1, w_img=h1, iters=3)
    del gp3, gp2, g_sc, y1, y2, y3
    gp0 = run("stem_bwd_conv1", gp1, *bwd[1], k=3, gate=y0, w_img=h1,
              t2=True, iters=3)
    del gp1, y0
    run("stem_bwd_conv0", gp0, *bwd[0], k=3, slope=None, w_img=SIZE,
        iters=3)
    del gp0
    # the 152^2 stage, forward then backward (its K4 route's weights)
    h5 = SIZE // 4
    rfwd, _, rbwd = model.res_params()
    x5 = PC.to_planar(torch.randn(TRAIN_BATCH, h5, h5, 128, generator=gen,
                                  device=dev).to(bf16))
    a = run("stage_fwd_conv6", x5, *rfwd[0], k=1, w_img=h5)
    post7 = run("stage_fwd_conv7", a, *rfwd[1], k=3, w_img=h5)
    c = run("stage_fwd_conv9", post7 + x5, *rfwd[2], k=1, w_img=h5)
    post10 = run("stage_fwd_conv10", c, *rfwd[3], k=3, w_img=h5)
    g11 = PC.to_planar(torch.randn(TRAIN_BATCH, h5, h5, 128, generator=gen,
                                   device=dev).to(bf16))
    gp9 = run("stage_bwd_conv10", PC.leaky_bwd_planar(g11, post10), *rbwd[3], k=3,
              slope=None, gate=c, w_img=h5)
    g8 = run("stage_bwd_conv9", gp9, *rbwd[2], g11, k=1, slope=None,
             w_img=h5)
    gp6 = run("stage_bwd_conv7", PC.leaky_bwd_planar(g8, post7), *rbwd[1], k=3,
              slope=None, gate=a, w_img=h5)
    run("stage_bwd_conv6", gp6, *rbwd[0], g8, k=1, slope=None, w_img=h5)
    return recs


# the K4 cycle split's geometries at b24: (image side, cin, cout, stride)
K4_SPLIT = {"stage_fwd_conv7": (SIZE // 4, 64, 128, 1),
            "stem_fwd_conv1": (SIZE, 32, 64, 2)}


def k4_split(dev, card) -> dict:
    """Where the bfloat16 K4's time goes at b24 in the stage's 3x3 s1
    (conv7, 64 -> 128 at 152^2) and the stem's 3x3 s2 (conv1, 32 -> 64,
    608^2 -> 304^2), on seeded random inputs and He-scaled weights: the
    library rebuilt with ``-DAPFP_PROFILE`` (``ops/_cuda.py: profiled``),
    in which thread 0 of each block adds the clock64 cycles between its
    laps to a category (``csrc/stem_common.cuh: wg::Lap``: input staging,
    input waits, weight waits, MMAs, epilogue, stores, barriers). Shares
    are of the summed cycles; ``split_ms`` applies them to the normal
    build's device time; the profiled build's own time is beside it."""
    _cuda = import_port("ops._cuda")
    PC = import_port("ops.planar_conv")
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    out = {}
    for name, (h, cin, cout, s) in K4_SPLIT.items():
        x = PC.to_planar(torch.randn(TRAIN_BATCH, h, h, cin, generator=gen,
                                     device=dev).to(bf16))
        w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev)
             * (2.0 / (9 * cin)) ** 0.5).to(bf16)
        b = torch.randn(cout, generator=gen, device=dev) * 0.1

        def fn():
            return PC.planar_conv(x, w, b, k=3, stride=s, w_img=h)
        ms = device_ms(fn)
        with _cuda.profiled("planar_conv"):
            fn()
            torch.cuda.synchronize()
            _cuda.prof_take("planar_conv")
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            cycles = _cuda.prof_take("planar_conv")
            prof_ms = device_ms(fn)
        total = sum(cycles.values())
        share = {k: v / total for k, v in cycles.items() if v}
        out[name] = {"dev_ms": ms, "share": share,
                     "split_ms": {k: v * ms for k, v in share.items()},
                     "profiled_dev_ms": prof_ms}
        log(f"[k4-split] {name} b24: dev {ms:.4f} ms; "
            f"{json.dumps({k: round(v, 4) for k, v in share.items()})}; "
            f"profiled build {prof_ms:.4f} ms ({card})")
        del x
        torch.cuda.empty_cache()
    return out


def k4_entries(recs, tc_info) -> list:
    """The kernels line's K4 entries, one per variant (1x1, 3x3 s1, 3x3
    s2, the stride-2 adjoint k3t2): ms, plain_ms, bound_ms and library_ms
    are sums over the variant's bfloat16 geometries, all at b24 (one
    planar-route training step launches each of them once), bound_by is that of the largest bound, max_abs_err and
    tol are those of the geometry nearest its tolerance; every geometry's
    record rides along, and phase 1's tensor-core records."""
    out = []
    for name, variant, rep in (
            ("planar_conv_k1", "k1s1", "494"), ("planar_conv_k3", "k3s1", "533"),
            ("planar_conv_k3s2", "k3s2", "533"),
            ("planar_conv_k3t2", "t2", "533 (through expand2_planar :202)")):
        mine = [r for r in recs if r["variant"] == variant]
        bf = [r for r in mine if r["dtype"] == "bfloat16"]
        worst = max(mine, key=lambda r: r["max_abs_err"] / r["tol"])
        out.append({
            "name": name, "route": "cuda",
            "source": f"{PORT}/csrc/planar_conv.cu",
            "replaces": f"{JAX_PKG}/ops/planar_conv.py:{rep}",
            "launches": 0, "max_abs_err": worst["max_abs_err"],
            "tol": worst["tol"],
            "ms": sum(r["ms"] for r in bf),
            "plain_ms": sum(r["plain_ms"] for r in bf),
            "bound_ms": sum(r["bound_ms"] for r in bf),
            "bound_by": max(bf, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(r["library_ms"] for r in bf),
            "library": ("cuDNN F.conv_transpose2d (stride 2) of the same "
                        "geometries, channels_last" if variant == "t2" else
                        "cuDNN F.conv2d of the same geometries, "
                        "channels_last (conv alone)"),
            "gflop": sum(r["gflop"] for r in bf),
            "geometries": mine, **tc_info[name]})
    return out


def stage_kernels(dev, model, card, tc_info) -> list:
    """Phase 7, K6: K6a with and without its masks and K6b at b24 608^2
    (the 152^2 stage), bfloat16 and float32, against their plain versions
    (K6b on the kernel's own masks), timed beside their bounds and the
    stage's four convs on the cuDNN walk (forward, forward + backward).
    bfloat16 K6a walks its sums as K4's forward does, so its y11 and masks
    must equal the planar stage route's (``res_planar._forward``: K4 x 4
    and two bfloat16 adds) bit for bit: the differing elements are
    counted and must be none. Returns the three entries of the kernels
    line, with phase 1's tensor-core records."""
    PC = import_port("ops.planar_conv")
    RF = import_port("ops.res_fused")
    PRP = import_port("models.res_planar")
    _cuda = import_port("ops._cuda")
    bf16 = torch.bfloat16
    b, h = TRAIN_BATCH, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    rfwd, rbwd, _ = model.res_params()
    x5 = torch.randn(b, h, h, 128, generator=gen, device=dev).to(bf16)
    g11 = torch.randn(b, h, h, 128, generator=gen, device=dev).to(bf16)
    flops = 2.0 * b * h * h * (128 * 64 + 9 * 64 * 128) * 2
    entries = {n: {"name": n, "route": "cuda",
                   "source": f"{PORT}/csrc/res_fused.cu", "launches": 0,
                   "library_ms": None}
               for n in K6_KERNELS}
    for n in K6_KERNELS:
        entries[n].update(tc_info[n])
    entries["res152_fused"]["replaces"] = f"{JAX_PKG}/ops/res_fused.py:449"
    entries["res152_fused_save"]["replaces"] = \
        f"{JAX_PKG}/ops/res_fused.py:449"
    entries["res152_fused_grad"]["replaces"] = \
        f"{JAX_PKG}/ops/res_fused.py:484"
    for dt in (bf16, torch.float32):
        fwd = rfwd if dt == bf16 else [(w.float(), bb) for w, bb in rfwd]
        bwd = rbwd if dt == bf16 else [w.float() for w in rbwd]
        xp, gp = PC.to_planar(x5.to(dt)), PC.to_planar(g11.to(dt))
        wl = xp.shape[-1]
        # yardstick: the stage's four convs on the cuDNN walk
        xn = x5.to(dt).requires_grad_(True)
        gn = g11.to(dt)
        with _cuda.no_tf32():
            walk_fwd = time_ms(lambda: stage_conv_walk(xn.detach(), fwd), 5)
            walk_fb = time_ms(lambda: torch.autograd.grad(
                (stage_conv_walk(xn, fwd) * gn).sum(), xn), 5)
        del xn
        # dirty the blocks the outputs will reuse: the kernels write every
        # lane
        torch.full(xp.shape, float("nan"), dtype=dt, device=dev)
        for c in (64, 128, 64, 128):
            torch.full((b, h, c, wl), 7, dtype=torch.int8, device=dev)
        y11 = RF.res152_fused(xp, fwd)
        y11s, *masks = RF.res152_fused(xp, fwd, save=True)
        torch.cuda.synchronize()
        assert torch.equal(y11, y11s), "save changed y11"
        want, *wmasks = RF.res152_fused_plain(xp, fwd, save=True)
        scale = want.float().abs().max().item()
        e = (y11.float() - want.float()).abs()
        err, mean_err = e.max().item(), e.mean().item()
        del want, e
        tol = (2e-5 if dt != bf16 else 2.0 ** -6) * scale
        assert err <= tol and mean_err <= 1e-4 * scale, (err, mean_err,
                                                         scale)
        n_mask = sum(m.numel() for m in masks)
        flips = [int((m != w).sum().item()) for m, w in zip(masks, wmasks)]
        del wmasks
        assert sum(flips) <= 1e-5 * n_mask, (flips, n_mask)
        for t in (y11, *masks):
            assert not t[..., 0].any() and not t[..., h + 1:].any()
        if dt == bf16:
            # the K4 witness: the planar stage route on the same x
            k4_y11, *acts = PRP._forward(xp, fwd)
            witness = {"y11": int((y11 != k4_y11).sum().item()),
                       "masks": [int((m != (a > 0).to(torch.int8))
                                     .sum().item())
                                 for m, a in zip(masks, acts)]}
            del k4_y11, acts
            log(f"[k6] bf16 K6a against the planar stage route (K4 x 4): "
                f"{witness} elements differ")
            assert witness == {"y11": 0, "masks": [0, 0, 0, 0]}, witness
            for n in ("res152_fused", "res152_fused_save"):
                entries[n]["k4_route_differing"] = witness
        torch.full(xp.shape, float("nan"), dtype=dt, device=dev)
        g5 = RF.res152_fused_grad(gp, masks, bwd)
        torch.cuda.synchronize()
        want = RF.res152_fused_grad_plain(gp, masks, bwd)
        gscale = want.float().abs().max().item()
        e = (g5.float() - want.float()).abs()
        gerr, gmean = e.max().item(), e.mean().item()
        del want, e
        gtol = (2e-5 if dt != bf16 else 2.0 ** -6) * gscale
        assert gerr <= gtol and gmean <= 1e-4 * gscale, (gerr, gmean,
                                                         gscale)
        assert not g5[..., 0].any() and not g5[..., h + 1:].any()
        x_read = image_bytes(xp, h, 128)
        m_read = sum(image_bytes(m, h, m.shape[2]) for m in masks)
        readings = {
            "res152_fused": dict(
                max_abs_err=err, tol=tol, mean_abs_err=mean_err,
                ms=time_ms(lambda: RF.res152_fused(xp, fwd), 5),
                plain_ms=time_ms(lambda: RF.res152_fused_plain(xp, fwd), 3),
                bound=bound(x_read + nbytes(y11), flops, dt)),
            "res152_fused_save": dict(
                max_abs_err=err, tol=tol, mean_abs_err=mean_err,
                mask_flips=flips, mask_elements=n_mask,
                ms=time_ms(lambda: RF.res152_fused(xp, fwd, save=True), 5),
                plain_ms=time_ms(lambda: RF.res152_fused_plain(
                    xp, fwd, save=True), 3),
                bound=bound(x_read + nbytes(y11, *masks), flops, dt)),
            "res152_fused_grad": dict(
                max_abs_err=gerr, tol=gtol, mean_abs_err=gmean,
                ms=time_ms(lambda: RF.res152_fused_grad(gp, masks, bwd), 5),
                plain_ms=time_ms(lambda: RF.res152_fused_grad_plain(
                    gp, masks, bwd), 3),
                bound=bound(image_bytes(gp, h, 128) + m_read + nbytes(g5),
                            flops, dt))}
        for n, r in readings.items():
            r["bound_ms"], r["bound_by"] = r.pop("bound")
            r["walk_fwd_ms"], r["walk_fwd_bwd_ms"] = walk_fwd, walk_fb
            ent = entries[n]
            if dt == bf16:
                ent.update(r, shape=list(xp.shape), dtype="bfloat16",
                           gflop=flops / 1e9)
            else:
                ent["f32"] = r
            log(f"[k6] {n} {dt}: err {r['max_abs_err']:.3g} (tol "
                f"{r['tol']:.3g}), {r['ms']:.4f} ms vs plain "
                f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
                f"({r['bound_by']}); cuDNN walk of the four convs fwd "
                f"{walk_fwd:.4f} ms, fwd+bwd {walk_fb:.4f} ms ({card})")
        del y11, y11s, masks, g5, xp, gp
    return [entries[n] for n in K6_KERNELS]


def grad12_kernel(dev, model, card, tc_info) -> dict:
    """Phase 7, K6c at b24 608^2 (gp12 [24, 76, 256, *], the stage's masks
    from K6a on a random x), bfloat16 and float32, against its plain
    version at K6b's tolerances, timed beside its bound (the stage's four
    convs and conv12's dgrad) and its cuDNN yardstick: conv12's dgrad
    (``torch.nn.grad.conv2d_input``) plus the stage's four convs forward
    and backward on the conv walk. Returns K6c's entry of the kernels
    line, with phase 1's tensor-core record."""
    PC = import_port("ops.planar_conv")
    RF = import_port("ops.res_fused")
    _cuda = import_port("ops._cuda")
    bf16 = torch.bfloat16
    b, h = TRAIN_BATCH, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    rfwd, rbwd, _ = model.res_params()
    x5 = torch.randn(b, h, h, 128, generator=gen, device=dev).to(bf16)
    g12 = torch.randn(b, h // 2, h // 2, 256, generator=gen,
                      device=dev).to(bf16)
    g11 = torch.randn(b, h, h, 128, generator=gen, device=dev).to(bf16)
    flops = (2.0 * b * h * h * (128 * 64 + 9 * 64 * 128) * 2
             + 2.0 * b * (h // 2) ** 2 * 256 * 128 * 9)
    ent = {"name": "res152_fused_grad12", "route": "cuda",
           "source": f"{PORT}/csrc/res_fused.cu",
           "replaces": f"{JAX_PKG}/ops/res_fused.py:538", "launches": 0,
           "dtype": "bfloat16", "gflop": flops / 1e9,
           "library": "cuDNN conv12 dgrad (torch.nn.grad.conv2d_input) + "
                      "the stage's four convs fwd + bwd on the conv walk",
           **tc_info["res152_fused_grad12"]}
    for dt in (bf16, torch.float32):
        fwd = rfwd if dt == bf16 else [(w.float(), bb) for w, bb in rfwd]
        bwd = rbwd if dt == bf16 else [w.float() for w in rbwd]
        w12t = model.w12t if dt == bf16 else model.w12t.float()
        xp = PC.to_planar(x5.to(dt))
        _, *masks = RF.res152_fused(xp, fwd, save=True)
        gp12 = PC.to_planar(g12.to(dt))
        torch.full(xp.shape, float("nan"), dtype=dt, device=dev)
        g5 = RF.res152_fused_grad12(gp12, masks, bwd, w12t)
        torch.cuda.synchronize()
        want = RF.res152_fused_grad12_plain(gp12, masks, bwd, w12t)
        scale = want.float().abs().max().item()
        e = (g5.float() - want.float()).abs()
        err, mean = e.max().item(), e.mean().item()
        del want, e
        tol = (2e-5 if dt != bf16 else 2.0 ** -6) * scale
        assert err <= tol and mean <= 1e-4 * scale, (dt, err, mean, scale)
        assert not g5[..., 0].any() and not g5[..., h + 1:].any()
        # the yardstick: conv12's dgrad and the stage's walk, on cuDNN
        w12 = w12t.permute(2, 3, 0, 1).contiguous(
            memory_format=torch.channels_last)       # OIHW [256, 128, 3, 3]
        g12n = g12.to(dt).permute(0, 3, 1, 2)
        xn = x5.to(dt).requires_grad_(True)
        gn = g11.to(dt)
        with _cuda.no_tf32():
            dgrad_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
                (b, 128, h, h), w12, g12n, 2, 1), 5)
            walk_fb = time_ms(lambda: torch.autograd.grad(
                (stage_conv_walk(xn, fwd) * gn).sum(), xn), 5)
        del xn
        g11p = PC.to_planar(g11.to(dt))
        m_read = sum(image_bytes(m, h, m.shape[2]) for m in masks)
        b_ms, b_by = bound(image_bytes(gp12, h // 2, 256) + m_read
                           + nbytes(g5), flops, dt)
        r = dict(max_abs_err=err, tol=tol, mean_abs_err=mean,
                 ms=time_ms(lambda: RF.res152_fused_grad12(
                     gp12, masks, bwd, w12t), 5),
                 plain_ms=time_ms(lambda: RF.res152_fused_grad12_plain(
                     gp12, masks, bwd, w12t), 3),
                 k6b_ms=time_ms(lambda: RF.res152_fused_grad(
                     g11p, masks, bwd), 5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=dgrad_ms + walk_fb, conv12_dgrad_ms=dgrad_ms,
                 walk_fwd_bwd_ms=walk_fb)
        log(f"[k6c] {dt}: err {err:.3g} (tol {tol:.3g}), {r['ms']:.4f} ms "
            f"vs plain {r['plain_ms']:.4f}, K6b {r['k6b_ms']:.4f}, bound "
            f"{b_ms:.4f} ({b_by}); cuDNN conv12 dgrad {dgrad_ms:.4f} + "
            f"stage walk fwd+bwd {walk_fb:.4f} ms ({card})")
        if dt == bf16:
            ent.update(r, shape=list(gp12.shape))
        else:
            ent["f32"] = r
        del g5, masks, xp, gp12, g11p
    return ent


# the K6 rows (entry names of the kernels line), timed at b24 608^2
K6_ROWS = (*K6_KERNELS, "res152_fused_grad12")


def k6_calls(dev, model) -> tuple:
    """The bfloat16 K6 kernels at b24 608^2 (the 152^2 stage) on seeded
    inputs: ({entry name: a call}, {entry name: its output}). K6a alone
    and with ``save``, K6b on K6a's masks, K6c on the same masks and a
    seeded gp12."""
    PC = import_port("ops.planar_conv")
    RF = import_port("ops.res_fused")
    bf16, b, h = torch.bfloat16, TRAIN_BATCH, SIZE // 4
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    rfwd, rbwd, _ = model.res_params()
    xp = PC.to_planar(torch.randn(b, h, h, 128, generator=gen,
                                  device=dev).to(bf16))
    gp = PC.to_planar(torch.randn(b, h, h, 128, generator=gen,
                                  device=dev).to(bf16))
    gp12 = PC.to_planar(torch.randn(b, h // 2, h // 2, 256, generator=gen,
                                    device=dev).to(bf16))
    y11, *masks = RF.res152_fused(xp, rfwd, save=True)
    calls = {
        "res152_fused": lambda: RF.res152_fused(xp, rfwd),
        "res152_fused_save": lambda: RF.res152_fused(xp, rfwd, save=True),
        "res152_fused_grad": lambda: RF.res152_fused_grad(gp, masks, rbwd),
        "res152_fused_grad12": lambda: RF.res152_fused_grad12(
            gp12, masks, rbwd, model.w12t)}
    outs = {"res152_fused": [calls["res152_fused"]()],
            "res152_fused_save": [y11, *masks],
            "res152_fused_grad": [calls["res152_fused_grad"]()],
            "res152_fused_grad12": [calls["res152_fused_grad12"]()]}
    return calls, outs


def digest(ts) -> str:
    """sha256 of the tensors' bytes, in order (a tree's outputs against
    another's, bit for bit)."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def k6_split(dev, model, dev_ms: dict) -> dict:
    """Where the bfloat16 K6 kernels' time goes at b24 (``k6_calls``: tile
    loads, input waits, weight waits, MMAs, epilogues, mask staging and
    sign stores, output stores, barriers): ``lap_split``, a
    ``[k6-split]`` line a kernel."""
    calls, _ = k6_calls(dev, model)
    return lap_split({n: ("res_fused", fn) for n, fn in calls.items()},
                     dev_ms, "k6-split")


def k6_readings(dev, model) -> dict:
    """The four K6 rows at b24 (``k6_calls``): CUDA-event ms over 5 calls
    (as phase 7 times them), device ms (``device_ms``: a CUDA graph of 20)
    and a digest of each output (``digest``)."""
    calls, outs = k6_calls(dev, model)
    rec = {"ms": {n: time_ms(fn, 5) for n, fn in calls.items()},
           "dev_ms": {n: device_ms(fn) for n, fn in calls.items()},
           "digest": {n: digest(outs[n]) for n in calls}}
    del calls, outs
    torch.cuda.empty_cache()
    return rec


def k6_route_steps(dev, steps: int = 10) -> dict:
    """The b24 training step (``tools/step_profile.build_step``: the
    default step's victim and inputs) on the c12 route (K6a ``save`` +
    K6c) and the fused-stage route (K6a ``save`` + K6b): CUDA-event ms a
    step over ``steps`` after 3 warm-up steps, and the K6 launches of the
    timed steps."""
    SP = import_port("tools.step_profile")
    out = {}
    for route in ("c12", "fused"):
        run, _ = SP.build_step(TRAIN_BATCH, dev, res152=route)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            run()
        end.record()
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items()
                    if k in K6_ROWS and v}
        out[route] = {"ms": start.elapsed_time(end) / steps,
                      "launches": launches}
        del run
        torch.cuda.empty_cache()
    return out


def route_forward(x, kw, sp, pf, rf, c12=None):
    """A route's own forward through layers 0-11 (0-12 on the c12 route,
    ``c12`` = conv12's OIHW weight and bias) on its kernels (no grad): y11
    (y12) NHWC and the gates of its leaky layers (NCHW float32, 1 where the
    route's value or mask is > 0, else 0.1), in the order of
    ``gated_walk_y11``'s convs. The fused and c12 routes' gates are their
    kernels' masks (K1 ``save_acts``, K6a ``save``; conv12's its own
    pre-activation's sign), the planar route's its K4 activations."""
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    RF = import_port("ops.res_fused")
    PSP = import_port("models.stem_planar")
    PRP = import_port("models.res_planar")

    def gate(p, w, c):
        v = PC.from_planar_plain(p, w, c).permute(0, 3, 1, 2)
        return torch.where(v > 0, 1.0, 0.1)

    h = x.shape[1]
    h1, h5 = h // 2, h // 4
    with torch.no_grad():
        if kw.get("fused_stem"):
            xe, xo = SF.split_phases(x.contiguous())
            y5p, m0e, m0o, m1, m2, m3 = SF.fused_stem_fwd(xe, xo, sp,
                                                          save_acts=True)
            m0 = SF.merge_phases(m0e, m0o, h1, 32).permute(0, 3, 1, 2)
            gates = [torch.where(m0 > 0, 1.0, 0.1), gate(m1, h1, 64),
                     gate(m2, h1, 32), gate(m3, h1, 64)]
        else:
            y0, y1, y2, y3, y5p = PSP._forward(x.contiguous(), pf)
            gates = [gate(y0, h, 32), gate(y1, h1, 64), gate(y2, h1, 32),
                     gate(y3, h1, 64)]
        gates.append(gate(y5p, h5, 128))
        if kw["res152"] == "c12":
            # K6a on the stem's planar y5 itself, as the route runs it
            y11p, *acts = RF.res152_fused(y5p, rf, save=True)
        else:
            xp = PC.to_planar(PC.from_planar(y5p, h5, 128))
            if kw["res152"] == "fused":
                y11p, *acts = RF.res152_fused(xp, rf, save=True)
            else:
                y11p, *acts = PRP._forward(xp, rf)
        gates += [gate(a, h5, a.shape[2]) for a in acts]
        y11 = PC.from_planar(y11p, h5, 128)
        if kw["res152"] != "c12":
            return y11, gates
        return conv12_gated(y11, c12, gates)


def conv12_gated(y11, c12, gates):
    """conv12 (cuDNN) on NHWC y11 as the c12 route runs it: its y12 and
    ``gates`` with conv12's own leaky gate (NCHW) appended."""
    PRP = import_port("models.res_planar")
    y12, m12 = PRP._conv12(y11, *c12)
    return y12, gates + [torch.where(m12.permute(0, 3, 1, 2) > 0, 1.0, 0.1)]


def _gated_conv(u, w, b, s, g):
    return torch.nn.functional.conv2d(u, w.permute(3, 2, 0, 1), b, s,
                                      (w.shape[0] - 1) // 2) * g


def gated_stem_walk(x, sp, gates):
    """Layers 0-5 as cuDNN convs (float32; the caller turns TF32 off) whose
    leaky gates are the given ones (NCHW, layers 0, 1, 2, 3, 5): NHWC x ->
    NCHW y5."""
    conv = _gated_conv
    g0, g1, g2, g3, g5 = gates[:5]
    v = x.permute(0, 3, 1, 2)
    y1 = conv(conv(v, *sp[0], 1, g0), *sp[1], 2, g1)
    y3 = conv(conv(y1, *sp[2], 1, g2), *sp[3], 1, g3)
    return conv(y3 + y1, *sp[4], 2, g5)


def gated_walk_y11(x, sp, rf, gates, c12=None):
    """Layers 0-11 (0-12 with ``c12`` = conv12's OIHW weight and bias) as
    cuDNN convs (float32; the caller turns TF32 off) whose leaky gates are
    the given ones (``route_forward``'s): NHWC x -> NHWC y11 (y12)."""
    return gated_stage(gated_stem_walk(x, sp, gates), rf, gates[5:], c12)


def gated_stage(y5, rf, gates, c12=None):
    """Layers 6-11 (6-12 with ``c12``) as cuDNN convs (float32; the caller
    turns TF32 off) on NCHW y5 whose leaky gates are the given ones (NCHW,
    layers 6, 7, 9, 10 and 12): -> NHWC y11 (y12)."""
    conv = _gated_conv
    g6, g7, g9, g10 = gates[:4]
    (w6, b6), (w7, b7), (w9, b9), (w10, b10) = rf
    y8 = conv(conv(y5, w6, b6, 1, g6), w7, b7, 1, g7) + y5
    y11 = conv(conv(y8, w9, b9, 1, g9), w10, b10, 1, g10) + y8
    if c12 is not None:
        w12, b12 = c12
        y11 = torch.nn.functional.conv2d(y11, w12, b12, 2, 1) * gates[4]
    return y11.permute(0, 2, 3, 1)


@contextlib.contextmanager
def plain_kernels():
    """Route K4 (and its k3t2 variant), K5, K6 and K6c through their plain
    versions while inside (the layout kernels stay: they are exact), for
    the bfloat16 gradient readings against the plain route."""
    PC = import_port("ops.planar_conv")
    SF = import_port("ops.stem_fused")
    RF = import_port("ops.res_fused")
    PSP = import_port("models.stem_planar")
    PRP = import_port("models.res_planar")
    saved = (PSP.planar_conv, PSP.planar_conv_t2, PRP.planar_conv,
             RF.res152_fused, RF.res152_fused_grad, RF.res152_fused_grad12,
             SF.fused_stem_bwd)
    PSP.planar_conv = PRP.planar_conv = PC.planar_conv_plain
    PSP.planar_conv_t2 = PC.planar_conv_t2_plain
    RF.res152_fused = (lambda xp, fwd, *, save=False, w_img=None:
                       RF.res152_fused_plain(xp, fwd, save, w_img))
    RF.res152_fused_grad = (lambda g, m, bwd, *, w_img=None:
                            RF.res152_fused_grad_plain(g, m, bwd, w_img))
    RF.res152_fused_grad12 = (
        lambda g, m, bwd, w12t, *, w_img=None:
        RF.res152_fused_grad12_plain(g, m, bwd, w12t, w_img))
    SF.fused_stem_bwd = SF.fused_stem_bwd_plain
    try:
        yield
    finally:
        (PSP.planar_conv, PSP.planar_conv_t2, PRP.planar_conv,
         RF.res152_fused, RF.res152_fused_grad, RF.res152_fused_grad12,
         SF.fused_stem_bwd) = saved


ROUTES = {"fused_fused": (dict(fused_stem=True, res152="fused"),
                          ("fused", "fused")),
          "planar_planar": (dict(fused_stem=False, planar_stem=True,
                                 res152="planar"), ("planar", "planar")),
          "remat": (dict(fused_stem=True, res152=None, stem_remat=True),
                    ("fused", "conv")),
          "c12": (dict(fused_stem=True, res152="c12"), ("c12", "c12"))}


def route_training(dev, card) -> dict:
    """Phase 8: ``paper_obj`` at b24 on the full-width YOLOv3 (the CLI's
    victim, seed 1) on the other routes, with counted launches: a
    ``PatchTrainer`` each with ``res152="fused"``, ``stem_remat=True`` and
    ``res152="c12"``, and a train step with only K4 in layers 0-11, each 3
    warm-up and ROUTE_STEPS timed steps; the victim's forward and forward
    + backward on each route; then the float32 gradient checks at batch 4
    and the bfloat16 readings."""
    T = import_port("train")
    PT = import_port("train.trainer")
    PE = import_port("attack.eot")
    PO = import_port("train.optim")
    PC = import_port("ops.planar_conv")
    RF = import_port("ops.res_fused")
    PSP = import_port("models.stem_planar")
    PRP = import_port("models.res_planar")
    _cuda = import_port("ops._cuda")
    darknet = import_port("models.darknet")
    flops = import_port("models.flops")
    SyntheticData = import_port("data").SyntheticData
    exp = T.get_experiment("paper_obj", batch_size=TRAIN_BATCH,
                           img_size=SIZE, patch_size=PATCH)
    net, params = PT.build_victim(exp, 1)

    def make_trainer(name):
        kw = {k: v for k, v in ROUTES.get(name, ({},))[0].items()
              if k != "fused_stem"}
        return PT.PatchTrainer(exp, net, params, device=dev,
                               log=lambda m: None, **kw)

    trainer = make_trainer("fused_fused")
    data = SyntheticData(48, SIZE, exp.max_labels, seed=SEED + 7)
    staged = [tuple(torch.from_numpy(a).to(dev) for a in
                    data.batch(TRAIN_BATCH, i)) for i in range(2)]
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    planar_step = PT.make_train_step(trainer.model, exp,
                                     **ROUTES["planar_planar"][0])
    pw = trainer.patch.detach().clone().requires_grad_(True)
    popt = PO.make_optimizer(pw, exp.learning_rate)

    rec = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # the stride-2 adjoints run as K4's k3t2 variant: no route may call the
    # zero interleave
    expand_calls = []
    expand2 = PC.expand2_planar

    def counted_expand2(*a, **k):
        expand_calls.append(1)
        return expand2(*a, **k)
    PC.expand2_planar = counted_expand2
    for name, (kw, want) in ROUTES.items():
        # the remat and c12 trainers hold their own model (0.13 GB of
        # bfloat16 weights beside the fused trainer's) for their run only
        tr = (trainer if name == "fused_fused" else make_trainer(name)
              if name in ("remat", "c12") else None)
        if tr is not None:
            def step(i, tr=tr):
                return tr.step(*staged[i % 2])
            patch_of = tr.patch
        else:
            def step(i):
                return planar_step(
                    pw, popt, *staged[i % 2], exp.learning_rate,
                    PE.draw_eot(gen, TRAIN_BATCH, exp.patch_size,
                                trainer.eot_cfg))
            patch_of = pw
        p0 = patch_of.detach().clone()
        reset_counts()
        expand_calls.clear()
        for i in range(3):
            step(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start.record()
        for i in range(ROUTE_STEPS):
            aux = step(i)
        end.record()
        torch.cuda.synchronize()
        launches = read_counts()
        routes = tuple(darknet.last_routes().values())
        n = 3 + ROUTE_STEPS
        assert not expand_calls, (name, "expand2_planar was called")
        ms = start.elapsed_time(end) / ROUTE_STEPS
        r = rec[name] = {
            "routes": routes, "steps_counted": n, "launches": launches,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "ms_per_step": ms, "steps_per_min": 60e3 / ms,
            "mfu": flops.mfu(ms / 1e3, TRAIN_BATCH, net,
                             torch.cuda.get_device_name(0)),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": {k: float(v) for k, v in aux.items()}}
        log(f"[routes] {name}: {ms:.2f} ms/step, peak "
            f"{r['peak_mem_gb']:.2f} GB ({card})")
        assert routes == want, (name, routes)
        assert all(np.isfinite(v) for v in r["loss"].values()), r["loss"]
        assert not torch.equal(patch_of.detach(), p0), \
            "the patch did not move"
        per_step = {k: v / n for k, v in launches.items()}
        if name == "fused_fused":
            # one K6a with masks and one K6b a step; the stage adds a K3a
            # (tiled) and a K3b each way to the stem's
            assert launches["res152_fused_save"] == n, launches
            assert launches["res152_fused_grad"] == n, launches
            assert launches["res152_fused"] == 0, launches
            assert launches["to_planar_g5"] == 3 * n, launches
            assert launches["from_planar"] == 3 * n, launches
            assert launches["to_planar_phases"] == n, launches
            assert launches["fused_stem_fwd_save_acts"] == n, launches
            assert all(launches[k] == 0 for k in K4_VARIANTS + NEW_KERNELS), \
                launches
        elif name == "planar_planar":
            # only K4 in layers 0-11: per step 6 1x1, 8 3x3 s1, 2 3x3 s2
            # and the 2 stride-2 adjoints (k3t2), forward and backward
            assert [launches[k] for k in K4_VARIANTS] == [
                6 * n, 8 * n, 2 * n, 2 * n], launches
            assert all(launches[k] == 0 for k in K6_KERNELS + NEW_KERNELS), \
                launches
            assert launches["fused_stem_fwd_save_acts"] == 0, launches
            assert launches["fused_stem_bwd_saved"] == 0, launches
            # K3a's step-1 narrow form on x and K3b's narrow form on gx0,
            # once a step each; no split_phases
            assert launches["to_planar"] == n, launches
            assert launches["from_planar_narrow"] == n, launches
            assert launches["to_planar_phases"] == 0, launches
        elif name == "remat":
            # K1 without masks and K5 a step; no K2, no masks
            want_ps = {"fused_stem_fwd": 1, "fused_stem_fwd_save_acts": 0,
                       "fused_stem_bwd": 1, "fused_stem_bwd_saved": 0,
                       "to_planar_phases": 1, "to_planar": 0,
                       "to_planar_g5": 1, "from_planar": 1}
            assert all(per_step[k] == v for k, v in want_ps.items()), \
                launches
            assert all(launches[k] == 0 for k in
                       K4_VARIANTS + K6_KERNELS + ("res152_fused_grad12",)), \
                launches
        else:
            # K1 save_acts, K6a save, K6c and K2 a step; K3a for the two x
            # phases (one launch) and gp12 (tiled), K3b for y11 only
            want_ps = {"fused_stem_fwd": 0, "fused_stem_fwd_save_acts": 1,
                       "res152_fused": 0, "res152_fused_save": 1,
                       "res152_fused_grad": 0, "res152_fused_grad12": 1,
                       "fused_stem_bwd_saved": 1, "fused_stem_bwd": 0,
                       "to_planar_phases": 1, "to_planar": 0,
                       "to_planar_g5": 1, "from_planar": 1}
            assert all(per_step[k] == v for k, v in want_ps.items()), \
                launches
            assert all(launches[k] == 0 for k in K4_VARIANTS), launches
        if name in ("remat", "c12"):
            del tr, step, patch_of
            torch.cuda.empty_cache()
    PC.expand2_planar = expand2

    # the default route (fused stem, K2) under the same conditions, two
    # models held: the yardstick of the remat and c12 routes' peaks
    tr = make_trainer("default")
    for i in range(3):
        tr.step(*staged[i % 2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start.record()
    for i in range(ROUTE_STEPS):
        tr.step(*staged[i % 2])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / ROUTE_STEPS
    rec["default"] = {"routes": tuple(darknet.last_routes().values()),
                      "ms_per_step": ms, "steps_per_min": 60e3 / ms,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    assert rec["default"]["routes"] == ("fused", "conv"), rec["default"]
    log(f"[routes] default: {ms:.2f} ms/step, peak "
        f"{rec['default']['peak_mem_gb']:.2f} GB ({card})")
    pp = rec["planar_planar"]["ms_per_step"]
    log(f"[routes] planar stem + planar stage (K4): {pp:.2f} ms/step beside "
        f"the default's {ms:.2f} ({pp - ms:+.2f} ms) ({card})")
    del tr
    torch.cuda.empty_cache()

    # where a step's victim time goes on each route (CUDA events)
    images, labels = staged[0]
    draws = PE.draw_eot(gen, TRAIN_BATCH, exp.patch_size, trainer.eot_cfg)
    with torch.no_grad():
        x_in, _ = PE.apply_eot_patch(trainer.patch.detach(), images, labels,
                                     draws, trainer.eot_cfg)
    x_req = x_in.detach().requires_grad_(True)
    rec["breakdown_ms"] = {}
    for name, (kw, _) in ROUTES.items():
        def fwd():
            with torch.no_grad():
                return trainer.model(x_in, **kw)

        def fwd_bwd():
            heads = trainer.model(x_req, **kw)
            return torch.autograd.grad(sum(hd.sum() for hd in heads), x_req)
        rec["breakdown_ms"][name] = {"victim_fwd": time_ms(fwd, 5, 2),
                                     "victim_fwd_bwd": time_ms(fwd_bwd, 5, 2)}
    del x_in, x_req

    # patch gradients at batch 4, float32, TF32 off: fixed random
    # projections (the random victim's saturated losses would not reach
    # the stem), as phase 6's checks
    exp32 = dataclasses.replace(exp, compute_dtype="float32")
    cfg32 = PT.eot_config(exp32)
    m32 = darknet.Darknet(net, params, torch.float32, device=dev).eval()
    imgs, labs = staged[0][0][:4], staged[0][1][:4]
    draws32 = PE.draw_eot(torch.Generator(device=dev).manual_seed(9), 4,
                          exp.patch_size, cfg32)
    draws16 = PE.draw_eot(torch.Generator(device=dev).manual_seed(9), 4,
                          exp.patch_size, trainer.eot_cfg)
    rgen = torch.Generator(device=dev).manual_seed(10)
    projs = {}
    patch = trainer.patch.detach()

    def grad(fwd, cfg, d, key):
        p = patch.clone().requires_grad_(True)
        with _cuda.no_tf32():
            patched, _ = PE.apply_eot_patch(p, imgs, labs, d, cfg)
            outs = fwd(patched)
            if key not in projs:
                projs[key] = [torch.randn(o.shape, generator=rgen,
                                          device=dev)
                              / o.detach().abs().max() for o in outs]
            loss = sum((o * q).sum() for o, q in zip(outs, projs[key]))
            return torch.autograd.grad(loss, p)[0]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    sp32 = m32.stem_params()
    pf32, pb32 = m32.planar_stem_params()
    rf32, rb32, rb4_32 = m32.res_params()
    c12_32 = (m32.w12, m32.bc12)
    gc = {}
    # (1) the planar stem alone against cuDNN convs of the same weights
    gc["f32_planar_stem_rel_l2"] = rel(
        grad(lambda x: [PSP.planar_stem(x.contiguous(), pf32, pb32)], cfg32,
             draws32, "y5"),
        grad(lambda x: [stem_conv_walk(x, sp32)], cfg32, draws32, "y5"))

    # (2) each stage route alone, on the cuDNN stem (c12 through conv12)
    def stage(route):
        def fwd(x):
            y5 = stem_conv_walk(x, sp32).contiguous()
            if route == "fused":
                return [PRP.res152_fused_stage(y5, rf32, rb32)]
            if route == "planar":
                return [PRP.res152_planar(y5, rf32, rb4_32)]
            if route == "c12":
                # the planar y5 through the differentiable plain layout
                # (the K3a wrapper records no graph)
                return [PRP.res152_c12_fused(PC.to_planar_plain(y5), rf32,
                                             rb32, *c12_32, m32.w12t)]
            if route == "walk12_on_route_gates":
                # the route's own leaky gates in layers 6-12 (K6a's masks,
                # conv12's sign on K6a's y11): a pre-activation within
                # summation order of 0 gates both alike
                with torch.no_grad():
                    y11p, *acts = RF.res152_fused(
                        PC.to_planar_plain(y5), rf32, save=True)
                    gates = [torch.where(PC.from_planar_plain(
                        a, SIZE // 4, a.shape[2]).permute(0, 3, 1, 2) > 0,
                        1.0, 0.1) for a in acts]
                    _, gates = conv12_gated(PC.from_planar(
                        y11p, SIZE // 4, 128), c12_32, gates)
                return [gated_stage(y5.permute(0, 3, 1, 2), rf32, gates,
                                    c12_32)]
            y11 = stage_conv_walk(y5, rf32)
            if route == "walk12":
                return [PRP._conv12(y11, *c12_32)[0]]
            return [y11]
        return fwd
    g_walk = grad(stage("walk"), cfg32, draws32, "y11")
    for r in ("fused", "planar"):
        gc[f"f32_stage_{r}_rel_l2"] = rel(grad(stage(r), cfg32, draws32,
                                               "y11"), g_walk)
    g_c12 = grad(stage("c12"), cfg32, draws32, "y12")
    gc["f32_stage_c12_rel_l2"] = rel(g_c12, grad(
        stage("walk12_on_route_gates"), cfg32, draws32, "y12"))
    gc["f32_stage_c12_vs_walk_rel_l2"] = rel(
        g_c12, grad(stage("walk12"), cfg32, draws32, "y12"))

    # (3) the whole victim on each route, against the walk carrying that
    # route's own forward: its y11 (y12 on the c12 route; straight
    # through, so the later layers see the route's values) and its leaky
    # gates in layers 0-11 (0-12), so a pre-activation within summation
    # order of 0 gates both alike; and, recorded beside it, against the
    # walk itself. The remat route against the default fused route: the
    # same forward, and K5's gradient is K2's
    def heads(model, kw, want):
        def fwd(x):
            out = model(x, **kw)
            assert tuple(darknet.last_routes().values()) == want
            return out
        return fwd

    def witness(kw):
        c12 = c12_32 if kw["res152"] == "c12" else None
        last = 12 if c12 is not None else 11

        def fwd(x):
            yk, gates = route_forward(x, kw, sp32, pf32, rf32, c12)
            yg = gated_walk_y11(x, sp32, rf32, gates, c12)
            v = (yk + (yg - yg.detach())).permute(0, 3, 1, 2)
            return m32.walk(v, last + 1, {last: v})
        return fwd

    g32w = grad(heads(m32, {}, ("conv", "conv")), cfg32, draws32, "heads")
    for name, (kw, want) in ROUTES.items():
        gk = grad(heads(m32, kw, want), cfg32, draws32, "heads")
        if name == "remat":
            gc["f32_heads_remat_vs_fused_rel_l2"] = rel(gk, grad(heads(
                m32, {"fused_stem": True}, ("fused", "conv")), cfg32,
                draws32, "heads"))
        else:
            gc[f"f32_heads_{name}_vs_walk_on_route_forward_rel_l2"] = rel(
                gk, grad(witness(kw), cfg32, draws32, "heads"))
        gc[f"f32_heads_{name}_vs_walk_rel_l2"] = rel(gk, g32w)
    del m32
    # (4) bfloat16: each route's kernels against its plain versions, both
    # against the float32 walk (recorded)
    for name, (kw, want) in ROUTES.items():
        g16k = grad(heads(trainer.model, kw, want), trainer.eot_cfg, draws16,
                    "heads")
        with plain_kernels():
            g16p = grad(heads(trainer.model, kw, want), trainer.eot_cfg,
                        draws16, "heads")
        gc[f"bf16_{name}_kernel_vs_plain_l2"] = (g16k - g16p).norm().item()
        gc[f"bf16_{name}_plain_vs_f32_walk_l2"] = (g16p - g32w).norm().item()
    gc["grad_l2"] = g32w.norm().item()
    gc["tol"] = 1e-4
    rec["grad_check"] = gc
    log(f"[routes] grad check {json.dumps(gc)}")
    for k, v in gc.items():
        if k.endswith("_rel_l2") and "_vs_walk_rel" not in k:
            assert v <= 1e-4, (k, v)
    log(f"[routes] {json.dumps(rec)} ({card})")
    return rec


def close_check(got, want, dt, what) -> tuple:
    """A kernel against its plain version: float32 2e-5 of the output scale
    (summation order); bfloat16 two bf16 ulps of it (a rounding flipped by
    the order) and a mean below 1e-4 of it. Returns (max, mean, tol)."""
    scale = max(want.float().abs().max().item(), 1e-30)
    e = (got.float() - want.float()).abs()
    err, mean = e.max().item(), e.mean().item()
    tol = (2e-5 if dt == torch.float32 else 2.0 ** -6) * scale
    assert err <= tol and (dt == torch.float32 or mean <= 1e-4 * scale), \
        (what, err, mean, scale)
    return err, mean, tol


def median_kernel(dev, card, k7_info) -> dict:
    """Phase 9, K7: bit for bit (int32 / int16 views) against its plain
    version in float32 and bfloat16, written into blocks filled with NaN
    that are checked to be its outputs, at [3, 224, 224] for every k of
    ``K7_KS`` (the network form, and the rank-counting form at k 9) and
    every case of ``median_pallas.check_input`` (the GPU tests' inputs);
    then, at the EOT smoother's shape ([3, 224, 224] float32, k 7, with a
    tied block), equal to the shipped ``median_pool_nhwc_fast`` forward
    and to one ``kthvalue`` over the unfolded reflect-padded windows, and
    timed (CUDA events and device time) beside its operations bound (the
    min/max instructions of the pruned network that the kernel runs), the
    plain version, the ``kthvalue`` yardstick and the shipped forward;
    also at [3, 608, 608] (a whole scene tile, the rate
    apart from the launch) and the rank form at k 9. Returns K7's entry of
    the kernels line."""
    MPL = import_port("experimental.median_pallas")
    MP = import_port("ops.median_pool")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    checked = 0
    for k in K7_KS:
        for case in ("ties", "zeros", "nan"):
            x = torch.from_numpy(MPL.check_input(
                (3, PATCH, PATCH), k, case, seed=SEED + 20 + k)).to(dev)
            for dt, bits in ((torch.float32, torch.int32),
                             (torch.bfloat16, torch.int16)):
                xd = x.to(dt)
                nans = torch.full_like(xd, float("nan"))
                got = MPL._median_pool_into(xd, nans, k)
                torch.cuda.synchronize()
                assert got is nans, "K7: not in place"
                want = MPL.median_pool_2d_pallas_plain(xd, k)
                assert torch.equal(got.view(bits), want.view(bits)), \
                    f"K7 k {k} {case} {dt} differs from its plain version"
                checked += 1
    del x, xd, nans, got, want

    def instructions(k, numel):
        """min/max instructions of the pruned network: those of the
        comparators' halves that the median reads."""
        return float(MP.median_net_minmax(k)) * numel

    def ops_bound(xt, k):
        # an FMNMX issues as one lane instruction where an FMA counts two
        # FLOPs: instructions x 2 over the f32 FLOP rate
        return bound(2 * nbytes(xt), 2 * instructions(k, xt.numel()),
                     torch.float32)

    x = torch.rand(3, PATCH, PATCH, generator=gen, device=dev)
    x[:, 40:60, 70:90] = 0.5
    got = MPL.median_pool_2d_pallas(x, 7)
    with torch.no_grad():
        shipped = MP.median_pool_nhwc_fast(x.permute(1, 2, 0), 7)
    assert torch.equal(got, shipped.permute(2, 0, 1)), "K7 vs shipped"

    def library():
        xp = F.pad(x[None], (3, 3, 3, 3), mode="reflect")
        return F.unfold(xp, 7).view(3, 49, -1).kthvalue(25, 1).values.view(
            x.shape)
    assert torch.equal(library(), got), "kthvalue yardstick"
    xb = x.to(torch.bfloat16)
    b_ms, b_by = ops_bound(x, 7)
    scene = torch.rand(3, SIZE, SIZE, generator=gen, device=dev)
    assert torch.equal(MPL.median_pool_2d_pallas(scene, 7),
                       MPL.median_pool_2d_pallas_plain(scene, 7)), "K7 608"
    s_ms, s_by = ops_bound(scene, 7)
    r_ms, r_by = ops_bound(x, 9)
    def run():
        return MPL.median_pool_2d_pallas(x, 7)
    with torch.no_grad():
        ent = {"name": "median_pool_2d_pallas", "route": "cuda",
               "source": f"{PORT}/csrc/median_pool.cu",
               "replaces": f"{JAX_PKG}/experimental/median_pallas.py:54",
               "launches": 0, "form": MPL.kernel_form(7),
               "max_abs_err": 0.0, "tol": 0.0, "checked_bit_for_bit": checked,
               "shape": list(x.shape), "k": 7, "dtype": "float32",
               "ms": time_ms(run), "device_ms": device_ms(run),
               "bf16_ms": time_ms(lambda: MPL.median_pool_2d_pallas(xb, 7)),
               "bf16_device_ms": device_ms(
                   lambda: MPL.median_pool_2d_pallas(xb, 7)),
               "plain_ms": time_ms(
                   lambda: MPL.median_pool_2d_pallas_plain(x, 7), 5),
               "bound_ms": b_ms, "bound_by": b_by,
               "comparators": len(MP.median_net_table(7)[0]),
               "minmax_an_output": MP.median_net_minmax(7),
               "minmax_instructions": instructions(7, x.numel()),
               "library_ms": time_ms(library),
               "library_device_ms": device_ms(library),
               "library": "F.pad (reflect) + F.unfold + torch.kthvalue",
               "shipped_fwd_ms": time_ms(
                   lambda: MP.median_pool_2d_fast(x, 7)),
               "scene_608": {
                   "shape": list(scene.shape),
                   "ms": time_ms(lambda: MPL.median_pool_2d_pallas(scene, 7)),
                   "device_ms": device_ms(
                       lambda: MPL.median_pool_2d_pallas(scene, 7)),
                   "bound_ms": s_ms, "bound_by": s_by},
               "rank_k9": {
                   "form": MPL.kernel_form(9),
                   "ms": time_ms(lambda: MPL.median_pool_2d_pallas(x, 9)),
                   "device_ms": device_ms(
                       lambda: MPL.median_pool_2d_pallas(x, 9)),
                   "bound_ms": r_ms, "bound_by": r_by,
                   "comparators": len(MP.median_net_table(9)[0]),
                   "minmax_an_output": MP.median_net_minmax(9)},
               "resources": k7_info, "card": card}
    log(f"[k7] {checked} checks bit for bit (k {K7_KS}, ties / zeros / nan, "
        f"f32 and bf16, into NaN blocks); equal to the shipped forward and "
        f"kthvalue; {ent['ms']:.4f} ms, device {ent['device_ms']:.4f} (bf16 "
        f"{ent['bf16_ms']:.4f}, device {ent['bf16_device_ms']:.4f}) vs "
        f"plain {ent['plain_ms']:.4f}, kthvalue {ent['library_ms']:.4f} "
        f"(device {ent['library_device_ms']:.4f}), shipped forward "
        f"{ent['shipped_fwd_ms']:.4f}, bound {b_ms:.6f} ({b_by}); 608: "
        f"{json.dumps(ent['scene_608'])}; k 9: {json.dumps(ent['rank_k9'])} "
        f"({card})")
    return ent


def lanes_bytes(t, bsz: int, w: int, c: int) -> int:
    """Bytes of a batch-on-lanes [rows, C', B*seg] tensor's first ``c``
    channels at its ``w`` value lanes per image (what a kernel must read of
    an input)."""
    return t.shape[0] * c * bsz * w * t.element_size()


def batched_kernels(dev, sp, sbp, card, tc_info) -> list:
    """Phase 9, K8a (with and without ``save_acts``) and K8b at b24 608^2,
    bfloat16 and float32, on the full-width victim's stem weights: each
    against its plain version (K8b on K8a's own activations, its gp5dd
    built as ``FusedStemBatched.backward`` builds it) with K1's and K2's
    tolerances, every border and slack lane zero though the blocks were
    dirty; then against K1 / K2 on the same x. bfloat16, where K8a runs
    K1's wgmma convs and K8b K2's wgmma chain: K8a's decimated y5 and its
    activations' signs equal K1's y5 and masks, and K8b's merged gx K2's
    on K1's masks, bit for bit. float32: K8a's y5 against K1's, K8b's gx
    (its FMA adjoint sums in another order) against K2's outside the
    12-pixel zone of any sign that differs. Timed beside their bounds and
    K1 ``save_acts`` + K2 at the same shape. Returns the three entries,
    with phase 1's tensor-core records."""
    SB = import_port("experimental.stem_batched")
    SF = import_port("ops.stem_fused")
    PC = import_port("ops.planar_conv")
    bf16 = torch.bfloat16
    b, h, h1, h5 = TRAIN_BATCH, SIZE, SIZE // 2, SIZE // 4
    seg = SB._seg(h1)
    tot = b * seg
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x = torch.rand(b, h, h, 3, generator=gen, device=dev)
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev)
    names = ("fused_stem_fwd_b", "fused_stem_fwd_b_save_acts",
             "fused_stem_bwd_b")
    # the yardstick: the stem on cuDNN at the same shape, bfloat16
    walk = stem_yardstick(x.to(bf16), sp)
    log(f"[k8] the stem on cuDNN, b24 bfloat16: {json.dumps(walk)} ({card})")
    ents = {n: {"name": n, "route": "cuda",
                "source": f"{PORT}/csrc/stem_batched.cu", "launches": 0,
                "library_ms": walk["bwd_ms" if n == "fused_stem_bwd_b"
                                   else "fwd_ms"],
                "library_is": "the stem on cuDNN (stem_conv_walk), bfloat16, "
                              "b24, " + ("input backward alone on a "
                                         "retained graph"
                                         if n == "fused_stem_bwd_b"
                                         else "forward"),
                "dtype": "bfloat16", **tc_info[n]} for n in names}
    ents["fused_stem_fwd_b"]["replaces"] = \
        f"{JAX_PKG}/experimental/stem_batched.py:402"
    ents["fused_stem_fwd_b_save_acts"]["replaces"] = \
        f"{JAX_PKG}/experimental/stem_batched.py:402"
    ents["fused_stem_bwd_b"]["replaces"] = \
        f"{JAX_PKG}/experimental/stem_batched.py:591"
    conv5 = 2.0 * b * h5 * h5 * 128 * 576   # conv5's real multiply-adds x 2

    def zero_lanes(t, what):
        v = t.reshape(*t.shape[:2], b, seg)
        assert not v[..., 0].any() and not v[..., h1 + 1:].any(), what

    for dt in (bf16, torch.float32):
        spd = sp if dt == bf16 else [(w.float(), bb) for w, bb in sp]
        sbpd = sbp if dt == bf16 else SF.stem_bwd_params(spd)
        xd = x.to(dt)
        xe, xo = SB.split_phases_b(xd, seg)
        r = {n: {} for n in names}
        # K8a alone, then with save_acts: dirty the blocks first
        torch.full((h5, 128, tot), float("nan"), dtype=dt, device=dev)
        y5 = SB.fused_stem_fwd_b(xe, xo, spd, b)
        torch.cuda.synchronize()
        for rows, c in ((h, 32), (h, 32), (h1, 64), (h1, 32), (h1, 64)):
            torch.full((rows, c, tot), float("nan"), dtype=dt, device=dev)
        acts = SB.fused_stem_fwd_b(xe, xo, spd, b, save_acts=True)
        torch.cuda.synchronize()
        assert torch.equal(acts[0], y5), "save_acts changed y5"
        want = SB.fused_stem_fwd_b_plain(xe, xo, spd, b, save_acts=True)
        err, mean, tol = close_check(y5, want[0], dt, "K8a y5")
        r["fused_stem_fwd_b"].update(max_abs_err=err, mean_abs_err=mean,
                                     tol=tol)
        act_errs = [close_check(a, w, dt, "K8a act") for a, w in
                    zip(acts[1:], want[1:])]
        worst = max(act_errs + [(err, mean, tol)], key=lambda e: e[0] / e[2])
        r["fused_stem_fwd_b_save_acts"].update(
            max_abs_err=worst[0], mean_abs_err=worst[1], tol=worst[2],
            act_max_abs_err=[e[0] for e in act_errs])
        for t in acts:
            zero_lanes(t, "K8a")
        del want
        # K8b on K8a's own activations: g5 (in the compute dtype, as
        # autograd hands it over) gated by K8a's y5, interleaved
        y5n = SB.batched_to_nhwc(y5, b, h5, 128, lane0=1, stride=2)
        g5d = g5.to(dt)
        gp5 = (g5d.float() * torch.where(y5n > 0, 1.0, 0.1)).to(dt)
        gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
            SB.interleave_zero_cols(gp5)), seg)
        torch.full((h, 8, tot), float("nan"), dtype=dt, device=dev)
        gx = SB.fused_stem_bwd_b(gp5dd, acts, sbpd, b)
        torch.cuda.synchronize()
        wx = SB.fused_stem_bwd_b_plain(gp5dd, acts, sbpd, b)
        errs = [close_check(gk, wk, dt, "K8b") for gk, wk in zip(gx, wx)]
        worst = max(errs, key=lambda e: e[0] / e[2])
        r["fused_stem_bwd_b"].update(max_abs_err=worst[0],
                                     mean_abs_err=worst[1], tol=worst[2])
        for t in gx:
            zero_lanes(t, "K8b")
            assert not t[:, 3:].any(), "K8b padding channels"
        del wx
        # against K1 / K2 on the same x (K1's masks; g5 through K3a)
        k1 = SF.fused_stem_fwd(*SF.split_phases(xd), spd, save_acts=True)
        k1y5 = PC.from_planar(k1[0], h5, 128)
        d_y5 = (y5n.float() - k1y5.float()).abs().max().item()
        k2 = SF.fused_stem_bwd_saved(k1, PC.to_planar(g5d), sbpd)
        # K8a's signs in K1's planar mask layout
        m0 = (SB.merge_phases_b(acts[1], acts[2], b, h1, 32) > 0).to(
            torch.int8)
        k8m = (None, PC.to_planar_plain(m0, step=2, offset=0),
               PC.to_planar_plain(m0, step=2, offset=1),
               *[PC.to_planar_plain((SB.batched_to_nhwc(
                   a, b, h1, a.shape[1]) > 0).to(torch.int8))
                 for a in acts[3:]])
        # K2 gates g5 by K1's y5, K8b's input by K8a's: a y5 sign that
        # differs joins the zone too (at its 4 x 4 input pixels)
        d5 = ((y5n > 0) != (k1y5 > 0)).any(-1)
        zone, flips = flip_zone(k1, k8m, h, extra=d5.repeat_interleave(
            4, 1).repeat_interleave(4, 2))
        y5_flips = int(((y5n > 0) != (k1y5 > 0)).sum().item())
        del m0, k8m, d5
        gxm = SB.merge_phases_b(*gx, b, h1, 3)
        k2m = SF.merge_phases(*k2, h1, 3)
        e = (gxm.float() - k2m.float()).abs().amax(-1)
        vs = {"y5_vs_k1_max_abs_diff": d_y5,
              "gx_vs_k2_max_abs_err": e.max().item(),
              "sign_flips_vs_k1_masks": flips,
              "y5_sign_flips_vs_k1": y5_flips}
        if dt == bf16:
            # K1's convs and K2's chain, all on wgmma: the same sums, bit
            # for bit
            assert torch.equal(y5n, k1y5) and flips == 0, ("K8a vs K1", d_y5,
                                                          flips)
            assert torch.equal(gxm, k2m), ("K8b vs K2", e.max().item())
            vs["bit_equal_to_k1_k2"] = True
        else:
            _, _, tol5 = close_check(y5n, k1y5, dt, "K8a y5 vs K1")
            out = e[~zone] if (~zone).any() else e.new_zeros(1)
            gtol = 2e-5 * k2m.float().abs().max().item()
            assert out.max().item() <= gtol, ("K8b vs K2", out.max().item(),
                                              gtol)
            vs.update(y5_tol=tol5, gx_tol=gtol,
                      gx_vs_k2_max_abs_err_outside_flips=out.max().item(),
                      flip_zone_frac=zone.float().mean().item())
            del out
        del k2, zone, e, gxm, k2m
        # times: kernels, plain versions, K1 (save_acts) + K2 at this shape
        x_read = 2 * lanes_bytes(xe, b, h1, 3)
        in_acts = (2 * lanes_bytes(acts[1], b, h1, 32)
                   + lanes_bytes(acts[3], b, h1, 64)
                   + lanes_bytes(acts[4], b, h1, 32)
                   + lanes_bytes(acts[5], b, h1, 64))
        # gp5dd holds data at one position in four: the bound counts that
        # quarter's bytes and the adjoint's real FLOPs (PERF.md's rule)
        bounds = {
            "fused_stem_fwd_b": bound(x_read + nbytes(y5),
                                      stem_flops(b, h) + conv5, dt),
            "fused_stem_fwd_b_save_acts": bound(
                x_read + nbytes(*acts), stem_flops(b, h) + conv5, dt),
            "fused_stem_bwd_b": bound(
                lanes_bytes(gp5dd, b, h1, 128) // 4 + in_acts + nbytes(*gx),
                stem_flops(b, h), dt)}
        k1_ms = time_ms(lambda: SF.fused_stem_fwd(
            *SF.split_phases(xd), spd, save_acts=True), 3)
        g5p = PC.to_planar(g5.to(dt))
        k2_ms = time_ms(lambda: SF.fused_stem_bwd_saved(k1, g5p, sbpd), 3)
        fns = {"fused_stem_fwd_b": (
                   lambda: SB.fused_stem_fwd_b(xe, xo, spd, b),
                   lambda: SB.fused_stem_fwd_b_plain(xe, xo, spd, b)),
               "fused_stem_fwd_b_save_acts": (
                   lambda: SB.fused_stem_fwd_b(xe, xo, spd, b, True),
                   lambda: SB.fused_stem_fwd_b_plain(xe, xo, spd, b, True)),
               "fused_stem_bwd_b": (
                   lambda: SB.fused_stem_bwd_b(gp5dd, acts, sbpd, b),
                   lambda: SB.fused_stem_bwd_b_plain(gp5dd, acts, sbpd, b))}
        for n in names:
            kern, plain = fns[n]
            r[n].update(ms=time_ms(kern, 3, 2), plain_ms=time_ms(plain, 2, 1),
                        bound_ms=bounds[n][0], bound_by=bounds[n][1],
                        k1_save_acts_plus_k2_ms=k1_ms + k2_ms,
                        k1_save_acts_ms=k1_ms, k2_ms=k2_ms, **vs)
            log(f"[k8] {n} {dt}: err {r[n]['max_abs_err']:.3g} (tol "
                f"{r[n]['tol']:.3g}), {r[n]['ms']:.4f} ms vs plain "
                f"{r[n]['plain_ms']:.4f}, bound {r[n]['bound_ms']:.4f} "
                f"({r[n]['bound_by']}); K1 save_acts + K2 {k1_ms:.4f} + "
                f"{k2_ms:.4f} ({card})")
            if dt == bf16:
                ents[n].update(r[n], shape=[h, 8, tot])
            else:
                ents[n]["f32"] = r[n]
        log(f"[k8] {dt} against K1 / K2 on the same x: {json.dumps(vs)}")
        del k1, acts, gx, gp5dd, xe, xo, y5
        torch.cuda.empty_cache()
    return [ents[n] for n in names]


EXP_PATH_STEPS = 3   # victim fwd + input bwd steps of phase 9's counted run


def experimental_path(dev, net, params, card, default_breakdown) -> dict:
    """Phase 9, the experimental package's entry points at full width
    (75 convs, 608^2) with counted launches: the EOT patch through K7, the
    bfloat16 b24 victim forward + input backward with layers 0-5 on
    ``fused_stem_batched`` (EXP_PATH_STEPS steps: one K8a ``save_acts`` and
    one K8b each, no K1 or K2), one forward without grad (K8a alone), and
    the b8 packed-stem forward. Then the A/B against the shipped fused stem
    (layout glue timed apart), the victim fwd + bwd on both stems, the
    float32 b4 patch-gradient check against the walk carrying the route's
    own y5 forward and gates, and the packed route's f32 heads against the
    conv walk. Returns the record (its ``launches`` from the counted
    run)."""
    SB = import_port("experimental.stem_batched")
    MPL = import_port("experimental.median_pallas")
    SF = import_port("ops.stem_fused")
    PC = import_port("ops.planar_conv")
    T = import_port("train")
    PT = import_port("train.trainer")
    PE = import_port("attack.eot")
    _cuda = import_port("ops._cuda")
    darknet = import_port("models.darknet")
    SyntheticData = import_port("data").SyntheticData
    bf16 = torch.bfloat16
    b, h, h1, h5 = TRAIN_BATCH, SIZE, SIZE // 2, SIZE // 4
    seg = SB._seg(h1)
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    model = darknet.Darknet(net, params, bf16, device=dev).eval()
    packed = {dt: darknet.Darknet(net, darknet.fold_bn(net, params), dt,
                                  device=dev).eval()
              for dt in (bf16, torch.float32)}
    sp, sbp = model.stem_params(), model.stem_bwd_params()
    x = torch.rand(b, h, h, 3, generator=gen, device=dev).to(bf16)
    x8 = x[:BATCH].contiguous()
    patch = torch.rand(PATCH, PATCH, 3, generator=gen, device=dev)   # HWC
    with torch.no_grad():
        heads_shape = [hd.shape for hd in model(x[:1])]
    projs = [torch.randn((b, *s[1:]), generator=gen, device=dev)
             for s in heads_shape]

    def batched_victim(xr):
        y5 = SB.fused_stem_batched(xr, sp, sbp)
        v = y5.permute(0, 3, 1, 2)
        return model.walk(v, 6, {5: v})

    def fwd_bwd(fwd):
        xr = x.detach().requires_grad_(True)
        heads = fwd(xr)
        loss = sum((hd * p).sum() for hd, p in zip(heads, projs))
        return torch.autograd.grad(loss, xr)[0]

    # -- the counted run through the package's entry points ------------
    rec = {}
    reset_counts()
    # the EOT smoother's median over the patch's H, W
    smoothed = MPL.median_pool_2d_pallas(patch.permute(2, 0, 1).contiguous(),
                                         7)
    for _ in range(EXP_PATH_STEPS):
        gxb = fwd_bwd(batched_victim)
    with torch.no_grad():
        heads_nograd = batched_victim(x)
        heads_packed = packed[bf16](x8, packed_stem=True)
        route_packed = darknet.last_routes()["stem"]
    torch.cuda.synchronize()
    launches = read_counts()
    rec["launches"] = launches
    log(f"[exp] counted run: {launches}")
    assert route_packed == "packed", route_packed
    assert launches["median_pool_2d_pallas"] == 1, launches
    # the patch's k 7 median went through the network form
    assert launches["median_pool_2d_pallas_network"] == 1, launches
    assert launches["fused_stem_fwd_b_save_acts"] == EXP_PATH_STEPS, launches
    assert launches["fused_stem_bwd_b"] == EXP_PATH_STEPS, launches
    assert launches["fused_stem_fwd_b"] == 1, launches
    assert all(v == 0 for k, v in launches.items() if k not in
               EXP_KERNELS), launches
    assert smoothed.shape == (3, PATCH, PATCH) and bool(
        torch.isfinite(smoothed).all())
    assert bool(torch.isfinite(gxb).all()) and gxb.abs().max().item() > 0
    assert all(bool(torch.isfinite(t).all())
               for t in list(heads_nograd) + list(heads_packed))
    del gxb, heads_nograd, heads_packed, smoothed

    # -- A/B against the shipped fused stem, glue apart ----------------
    g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
    xr = x.detach().requires_grad_(True)
    # each route's layout work around its kernels, on their real tensors:
    # batched split_phases_b + the y5 decimation forward; gating, the two
    # zero interleaves, nhwc_to_batched and merge_phases_b backward; the
    # shipped K3a x 2 + K3b forward, K3a (g5) + merge_phases backward
    acts = SB.fused_stem_fwd_b(*SB.split_phases_b(x, seg), sp, b, True)
    y5n = SB.batched_to_nhwc(acts[0], b, h5, 128, 1, 2).contiguous()
    gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(
        SB.interleave_zero_cols(g5)), seg)
    gxb = SB.fused_stem_bwd_b(gp5dd, acts, sbp, b)
    acts_k1 = SF.fused_stem_fwd(*SF.split_phases(x), sp, save_acts=True)
    gxk = SF.fused_stem_bwd_saved(acts_k1, PC.to_planar(g5), sbp)
    del gp5dd

    def glue_fwd():
        SB.split_phases_b(x, seg)
        return SB.batched_to_nhwc(acts[0], b, h5, 128, 1, 2).contiguous()

    def glue_bwd():
        gp5 = g5.float() * torch.where(y5n > 0, 1.0, 0.1)
        SB.nhwc_to_batched(SB.interleave_zero_rows(SB.interleave_zero_cols(
            gp5.to(bf16))), seg)
        return SB.merge_phases_b(*gxb, b, h1, 3)

    def shipped_glue_fwd():
        SF.split_phases(x)
        return PC.from_planar(acts_k1[0], h5, 128)

    def shipped_glue_bwd():
        PC.to_planar(g5)
        return SF.merge_phases(*gxk, h1, 3)

    with torch.no_grad():
        ab = {"batched_fwd_ms": time_ms(
                  lambda: SB.fused_stem_batched(x, sp), 3, 2),
              "fused_fwd_ms": time_ms(lambda: SF.fused_stem(x, sp), 3, 2),
              "batched_glue_fwd_ms": time_ms(glue_fwd, 5, 2),
              "batched_glue_bwd_ms": time_ms(glue_bwd, 5, 2),
              "fused_glue_fwd_ms": time_ms(shipped_glue_fwd, 5, 2),
              "fused_glue_bwd_ms": time_ms(shipped_glue_bwd, 5, 2)}
    ab["batched_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        SB.fused_stem_batched(xr, sp, sbp), xr, g5), 3, 1)
    ab["fused_fwd_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        SF.fused_stem(xr, sp, sbp), xr, g5), 3, 1)
    del acts, acts_k1, y5n, gxb, gxk
    torch.cuda.empty_cache()
    # the victim forward + input backward on each stem (fixed projection)
    ab["victim_fwd_bwd_batched_ms"] = time_ms(
        lambda: fwd_bwd(batched_victim), 3, 1)
    ab["victim_fwd_bwd_fused_ms"] = time_ms(
        lambda: fwd_bwd(lambda v: model(v, fused_stem=True)), 3, 1)
    ab["phase6_victim_fwd_bwd_fused_ms"] = default_breakdown[
        "victim_fwd_bwd_fused"]
    rec["ab"] = ab
    log(f"[exp] A/B at b24 608^2 bf16: {json.dumps(ab)} ({card})")
    del model, xr
    torch.cuda.empty_cache()

    # -- float32 patch gradient at b4 ----------------------------------
    exp = T.get_experiment("paper_obj", batch_size=TRAIN_BATCH,
                           img_size=SIZE, patch_size=PATCH)
    exp32 = dataclasses.replace(exp, compute_dtype="float32")
    cfg32 = PT.eot_config(exp32)
    m32 = darknet.Darknet(net, params, torch.float32, device=dev).eval()
    sp32, sbp32 = m32.stem_params(), m32.stem_bwd_params()
    data = SyntheticData(8, SIZE, exp.max_labels, seed=SEED + 7)
    imgs, labs = (torch.from_numpy(a).to(dev) for a in data.batch(4, 0))
    draws32 = PE.draw_eot(torch.Generator(device=dev).manual_seed(9), 4,
                          exp.patch_size, cfg32)
    rgen = torch.Generator(device=dev).manual_seed(10)
    gproj = []

    def grad(fwd):
        p = patch.clone().requires_grad_(True)
        with _cuda.no_tf32():
            patched, _ = PE.apply_eot_patch(p, imgs, labs, draws32, cfg32)
            outs = fwd(patched)
            if not gproj:
                gproj.extend(torch.randn(o.shape, generator=rgen, device=dev)
                             / o.detach().abs().max() for o in outs)
            loss = sum((o * q).sum() for o, q in zip(outs, gproj))
            return torch.autograd.grad(loss, p)[0]

    def walk_from(y5):
        v = y5.permute(0, 3, 1, 2)
        return m32.walk(v, 6, {5: v})

    def batched32(xp):
        return walk_from(SB.fused_stem_batched(xp.contiguous(), sp32, sbp32))

    def witness(xp):
        with torch.no_grad():
            ph = SB.split_phases_b(xp.contiguous(), SB._seg(h1))
            a = SB.fused_stem_fwd_b(*ph, sp32, xp.shape[0], True)
            nb = xp.shape[0]
            # contiguous NHWC, as the route's own y5: the walk's convs then
            # sum in the route's order
            y5k = SB.batched_to_nhwc(a[0], nb, h5, 128, 1, 2).contiguous()

            def gate(v):
                return torch.where(v > 0, 1.0, 0.1).permute(0, 3, 1, 2)
            gates = [gate(SB.merge_phases_b(a[1], a[2], nb, h1, 32))] + [
                gate(SB.batched_to_nhwc(t, nb, h1, t.shape[1]))
                for t in a[3:]] + [gate(y5k)]
        yg = gated_stem_walk(xp, sp32, gates).permute(0, 2, 3, 1)
        return walk_from(y5k + (yg - yg.detach()))

    g_b = grad(batched32)
    g_w = grad(witness)
    g_f = grad(lambda xp: m32(xp, fused_stem=True))
    g_c = grad(lambda xp: m32(xp))

    def rel(a, bb):
        return ((a - bb).norm() / bb.norm()).item()
    gc = {"batch": 4, "tol": 1e-4,
          "f32_heads_batched_vs_walk_on_route_forward_rel_l2": rel(g_b, g_w),
          "f32_heads_batched_vs_fused_rel_l2": rel(g_b, g_f),
          "f32_heads_batched_vs_walk_rel_l2": rel(g_b, g_c),
          "grad_l2": g_c.norm().item()}
    rec["grad_check"] = gc
    log(f"[exp] grad check {json.dumps(gc)}")
    assert g_c.norm().item() > 0
    assert gc["f32_heads_batched_vs_walk_on_route_forward_rel_l2"] <= 1e-4, gc
    del m32, g_b, g_w, g_f, g_c

    # -- the packed stem, b8 forward -----------------------------------
    pk = {}
    with torch.no_grad():
        for dt, m in packed.items():
            name = "bf16" if dt == bf16 else "f32"
            out = m(x8, packed_stem=True)
            assert darknet.last_routes()["stem"] == "packed"
            pk[f"{name}_packed_fwd_ms"] = time_ms(
                lambda: m(x8, packed_stem=True), 5, 2)
            pk[f"{name}_walk_fwd_ms"] = time_ms(lambda: m(x8), 5, 2)
            pk[f"{name}_fused_fwd_ms"] = time_ms(
                lambda: m(x8, fused_stem=True), 5, 2)
            if dt == torch.float32:
                walk = m(x8)
                err = max(((o - w).abs().max() / w.abs().max()).item()
                          for o, w in zip(out, walk))
                pk["f32_heads_vs_walk_max_err_over_scale"] = err
                assert err <= 1e-4, err
    rec["packed"] = pk
    log(f"[exp] packed stem b8: {json.dumps(pk)} ({card})")
    return rec


STORE_TILES = 58    # 2 x 24 + 10: the store epoch's last batch is padded
STORE_EPOCHS = 2    # the second epoch is the timed one
PACE_TILES = 192    # 8 b24 steps an epoch: the paths' pace once running
TRACE_STEPS = 5     # default b24 steps inside the profiler trace


def smooth_tile(rng) -> np.ndarray:
    """A synthetic 608^2 uint8 tile: smooth random fields at three scales
    (5, 19 and 76 cells across, bicubic) plus pixel noise (sigma 6). Not
    aerial imagery: a stand-in whose PNG (PIL's default level 6) inflates
    and unfilters like a photograph's, at about 0.63 of its raw bytes,
    where uniform noise is stored nearly raw and decodes faster."""
    from PIL import Image
    out = 120.0 + rng.normal(0.0, 6.0, (SIZE, SIZE, 3))
    for cells, amp in ((5, 90.0), (19, 40.0), (76, 25.0)):
        low = rng.normal(0.0, 1.0, (cells, cells, 3)).astype(np.float32)
        out += amp * np.stack([np.asarray(Image.fromarray(
            low[..., c], mode="F").resize((SIZE, SIZE), Image.BICUBIC))
            for c in range(3)], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def write_tiles(root: str, n: int, seed: int) -> tuple:
    """``n`` synthetic 608^2 PNG tiles (``smooth_tile``) and their YOLO
    label files (1-5 boxes each) under ``root``; returns (image dir, label
    dir, PNG bytes over raw bytes)."""
    from PIL import Image
    img_dir, lab_dir = os.path.join(root, "img"), os.path.join(root, "lab")
    os.makedirs(img_dir)
    os.makedirs(lab_dir)
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31, n)
    labels = []
    for _ in range(n):
        k = int(rng.integers(1, 6))
        labels.append("".join(
            f"{int(c)} {x:.4f} {y:.4f} {w:.4f} {h:.4f}\n" for c, x, y, w, h in
            zip(rng.integers(0, 15, k), *rng.uniform(0.2, 0.8, (2, k)),
                *rng.uniform(0.02, 0.2, (2, k)))))

    def save(i):
        path = os.path.join(img_dir, f"t{i:03d}.png")
        Image.fromarray(smooth_tile(np.random.default_rng(seeds[i]))).save(
            path)
        with open(os.path.join(lab_dir, f"t{i:03d}.txt"), "w") as f:
            f.write(labels[i])
        return os.path.getsize(path)

    with ThreadPoolExecutor(8) as pool:
        png_bytes = sum(pool.map(save, range(n)))
    return img_dir, lab_dir, png_bytes / (n * SIZE * SIZE * 3)


def pace(PT, D, exp, net, params, ds, dev) -> dict:
    """ms per b24 step of the store epoch and of the per-step path
    (``run_epoch`` over the CLI's ``BatchLoader``: PNG decode on 8 threads
    up to two batches ahead, a float32 host -> device copy a step) on the
    same files, in epoch 1 after a warm-up epoch 0, by CUDA events. The
    per-step path's steps are split apart by an event recorded as each
    step is enqueued, so an interval is a step as the card lives it, its
    waits for the host included: the first holds the epoch's first
    decode, which nothing can hide; the others are the path's running
    pace."""
    k = len(ds) // TRAIN_BATCH

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    rec = {"steps_an_epoch": k}
    store = D.DeviceStore(ds, device=dev)
    tr = PT.PatchTrainer(exp, net, params, seed=SEED, device=dev,
                         log=lambda s: None)
    for epoch in range(2):
        e0 = event()
        stats = tr.run_epoch_store(store, epoch)
        e1 = event()
        torch.cuda.synchronize()
        assert stats["num_batches"] == k, stats
    rec["store_ms_per_step"] = e0.elapsed_time(e1) / k
    del tr, store
    torch.cuda.empty_cache()
    tr = PT.PatchTrainer(exp, net, params, seed=SEED, device=dev,
                         log=lambda s: None)
    loader = D.BatchLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=8,
                           seed=SEED, drop_last=True)
    for epoch in range(2):
        events = []

        def batches():
            events.append(event())
            for batch in loader:
                yield batch
                events.append(event())

        stats = tr.run_epoch(batches(), epoch)
        torch.cuda.synchronize()
        assert stats["num_batches"] == k == len(events) - 1, stats
    loader.pool.shutdown()
    del tr
    torch.cuda.empty_cache()
    steps = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    rec.update({"per_step_ms": steps, "per_step_first_ms": steps[0],
                "per_step_running_ms_per_step": float(np.mean(steps[1:])),
                "per_step_epoch_ms_per_step": float(np.mean(steps))})
    rec["running_over_store"] = (rec["per_step_running_ms_per_step"]
                                 / rec["store_ms_per_step"])
    return rec


def store_path(dev, card) -> dict:
    """Phase 10: the device-store training path at full width (counted
    launches): the training CLI with ``--device-store`` over 58 PNG tiles
    (3 batches an epoch, the last padded) and without it (2, the partial
    batch dropped), the first store step held against the per-step path
    on the same rows (the gathered batch bit for bit; bfloat16 and float32
    loss parts within 1e-3 relative; the float32 patch gradient within
    1e-4 relative L2, TF32 off), and the two paths' pace (``pace``) over
    192 tiles, with one batch's PNG decode and its host -> device copy.
    The tiles are ``smooth_tile``s: synthetic, not DOTA imagery."""
    PT = import_port("train.trainer")
    D = import_port("data.dataset")
    _cuda = import_port("ops._cuda")
    darknet = import_port("models.darknet")
    cli = import_port("cli.train_patch")
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    rec = {"tiles": STORE_TILES, "epochs": STORE_EPOCHS}
    try:
        t0 = time.perf_counter()
        img_dir, lab_dir, _ = write_tiles(os.path.join(root, "cli"),
                                          STORE_TILES, SEED + 30)
        pimg, plab, rec["png_over_raw"] = write_tiles(
            os.path.join(root, "pace"), PACE_TILES, SEED + 31)
        rec["write_tiles_s"] = time.perf_counter() - t0
        args = ["--mode", "paper_obj", "--img-dir", img_dir, "--lab-dir",
                lab_dir, "--batch-size", str(TRAIN_BATCH), "--img-size",
                str(SIZE), "--patch-size", str(PATCH), "--epochs",
                str(STORE_EPOCHS), "--device", dev.type]
        reset_counts()
        t0 = time.perf_counter()
        trainer = cli.main(args + ["--device-store", "--out-dir",
                                   os.path.join(root, "store")])
        torch.cuda.synchronize()
        rec["cli_s"] = time.perf_counter() - t0
        launches = read_counts()
        exp = trainer.exp
        assert (exp.img_size, exp.patch_size, exp.batch_size,
                exp.compute_dtype) == (SIZE, PATCH, TRAIN_BATCH, "bfloat16")
        assert len(darknet.conv_specs(trainer.net)) == 75
        hist = trainer.history
        n_batches = -(-STORE_TILES // TRAIN_BATCH)
        assert [h["num_batches"] for h in hist] == [n_batches] * \
            STORE_EPOCHS, hist
        for h in hist:
            assert all(np.isfinite(h[k]) for k in
                       ("loss", "no_obj", "no_cls", "tv", "nps", "colorful"))
        steps = n_batches * STORE_EPOCHS
        # the default training kernels, each once a step, as on the
        # per-step path; nothing else
        want = {k: steps for k in TRAIN_PATH + EOT_WARP}
        assert launches == {k: want.get(k, 0) for k in launches}, launches
        assert darknet.last_routes() == {"stem": "fused", "res152": "conv"}
        rec.update({"launches": launches, "steps": steps,
                    "history": hist,
                    "store_ms_per_step": [h["epoch_time"] / n_batches * 1e3
                                          for h in hist]})
        del trainer
        torch.cuda.empty_cache()

        # the per-step CLI on the same files (BatchLoader: PNG decode and a
        # host -> device copy a step; the partial batch dropped). Its
        # epochs of 2 steps are mostly the first batch's decode: the pace
        # comes from ``pace`` below
        t0 = time.perf_counter()
        per = cli.main(args + ["--out-dir", os.path.join(root, "steps")])
        torch.cuda.synchronize()
        rec["per_step_cli_s"] = time.perf_counter() - t0
        k_per = STORE_TILES // TRAIN_BATCH
        assert [h["num_batches"] for h in per.history] == [k_per] * \
            STORE_EPOCHS
        rec["per_step_ms_per_step"] = [h["epoch_time"] / k_per * 1e3
                                       for h in per.history]
        del per
        torch.cuda.empty_cache()
        net, params = PT.build_victim(exp, SEED + 1)   # the CLI's victim
        pds = D.DotaDataset(pimg, plab, exp.max_labels, SIZE)
        rec["pace"] = pace(PT, D, exp, net, params, pds, dev)
        # what the per-step path adds to a step: one batch's PNG decode
        # (24 tiles on the loader's 8 threads) and its float32 copy from
        # pageable host memory to the card (106 MB)
        loader = D.BatchLoader(pds, TRAIN_BATCH, num_workers=8)
        t0 = time.perf_counter()
        host_imgs, _ = loader._make_batch(range(TRAIN_BATCH))
        rec["decode_batch_ms"] = (time.perf_counter() - t0) * 1e3
        loader.pool.shutdown()
        rec["h2d_batch_ms"] = time_ms(
            lambda: torch.from_numpy(host_imgs).to(dev), 5, 1)
        rec["h2d_batch_mb"] = host_imgs.nbytes / 1e6
        del host_imgs

        # the first store step against the per-step path on the same rows
        ds = D.DotaDataset(img_dir, lab_dir, exp.max_labels, SIZE)
        t0 = time.perf_counter()
        store = D.DeviceStore(ds, device=dev)
        torch.cuda.synchronize()
        rec["store_resident_s"] = time.perf_counter() - t0
        rec["store_gb"] = store.images.numel() / 1e9
        idx, w = D.epoch_plan(STORE_TILES, TRAIN_BATCH, 0, seed=SEED)
        idx_t, w_t = (torch.from_numpy(a).to(dev) for a in (idx, w))
        imgs, labs = (np.stack(a) for a in zip(*(ds[i] for i in idx[0])))
        gathered, _ = PT.store_batch(store.images, store.labels, idx_t[0])
        assert torch.equal(gathered, torch.from_numpy(imgs).to(dev)), \
            "the store's batch is not the loader's"
        del gathered
        checks = {}
        for dt in ("bfloat16", "float32"):
            exp_d = dataclasses.replace(exp, compute_dtype=dt)
            a, b = (PT.PatchTrainer(exp_d, net, params, seed=SEED,
                                    device=dev, log=lambda s: None)
                    for _ in range(2))
            epoch_fn = PT.make_epoch_scan_fn(b.model, exp_d)
            with _cuda.no_tf32():
                aux = a.step(imgs, labs, w[0])
                means = epoch_fn(b.patch, b.optimizer, b.generator,
                                 store.images, store.labels, idx_t[:1],
                                 w_t[:1], b.scheduler.lr)
            torch.cuda.synchronize()
            parts = {k: (float(aux[k]), float(means[k]))
                     for k in PT.LOSS_KEYS}
            rel_parts = {k: abs(u - v) / max(abs(u), 1e-30)
                         for k, (u, v) in parts.items()}
            ga, gb = a.patch.grad, b.patch.grad
            grad_rel = ((gb - ga).norm() / ga.norm()).item()
            checks[dt] = {"loss_parts": parts, "loss_rel": rel_parts,
                          "grad_rel_l2": grad_rel,
                          "grad_l2": ga.norm().item(),
                          "patch_equal": torch.equal(a.patch, b.patch)}
            assert all(v <= 1e-3 for v in rel_parts.values()), (dt,
                                                                rel_parts)
            if dt == "float32":
                assert ga.norm().item() > 0 and grad_rel <= 1e-4, grad_rel
            del a, b, epoch_fn
            torch.cuda.empty_cache()
        rec["first_step_checks"] = checks
        del store
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[store] launches {json.dumps(rec['launches'])}; store "
        f"{rec['store_gb']:.3f} GB resident in {rec['store_resident_s']:.2f} "
        f"s; first step vs per-step path "
        f"{json.dumps(rec['first_step_checks'])}")
    pc = rec["pace"]
    log(f"[store] CLI epochs, host clock, ms per step (epoch 0, epoch 1): "
        f"store {rec['store_ms_per_step']} (3 steps), per-step "
        f"{rec['per_step_ms_per_step']} (2 steps, the first batch's decode "
        f"exposed) ({card})")
    log(f"[store] pace over {PACE_TILES} synthetic tiles (PNG "
        f"{rec['png_over_raw']:.3f} of raw), epoch 1 of 8 b24 steps, CUDA "
        f"events: store {pc['store_ms_per_step']:.2f} ms a step; per-step "
        f"path running {pc['per_step_running_ms_per_step']:.2f} (steps 2-8; "
        f"{pc['running_over_store']:.3f}x the store's), first step "
        f"{pc['per_step_first_ms']:.2f}, epoch mean "
        f"{pc['per_step_epoch_ms_per_step']:.2f}; its steps "
        f"{[round(t, 2) for t in pc['per_step_ms']]}; one batch's PNG "
        f"decode {rec['decode_batch_ms']:.1f} ms, its host -> device copy "
        f"({rec['h2d_batch_mb']:.0f} MB) {rec['h2d_batch_ms']:.2f} ms "
        f"({card})")
    return rec


@contextlib.contextmanager
def launcher_env(rank: int, world: int, port: int):
    """The variables ``torchrun`` sets for one process, while inside."""
    new = {"RANK": str(rank), "WORLD_SIZE": str(world),
           "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in new}
    os.environ.update(new)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def nccl_mesh(dev, card) -> dict:
    """Phase 11: a one-rank NCCL process group on the card through
    ``init_distributed`` (``WORLD_SIZE=1``, a local ``MASTER_ADDR``), its
    collectives on card tensors, and 3 default b24 steps of a
    ``PatchTrainer`` given the mesh against the meshless trainer's. A
    size-1 mesh runs the meshless code, so the equal patches show that
    the trainer takes a mesh from the group and that this path stays the
    default one, not that the step's gather and reduction are right: the
    gloo tests on the CPU hold those (two ranks against one process and
    against the JAX step), and with two cards or more this phase runs the
    training CLI in two processes over NCCL (one card each) against it
    in one."""
    import torch.distributed as dist
    PT = import_port("train.trainer")
    PM = import_port("parallel.mesh")
    SyntheticData = import_port("data").SyntheticData
    rec = {}
    exp = import_port("train").get_experiment("paper_obj", batch_size=TRAIN_BATCH,
                           img_size=SIZE, patch_size=PATCH)
    net, params = PT.build_victim(exp, SEED + 1)
    data = SyntheticData(48, SIZE, exp.max_labels, seed=SEED + 40)
    staged = [tuple(torch.from_numpy(a).to(dev) for a in
                    data.batch(TRAIN_BATCH, i)) for i in range(3)]
    with launcher_env(0, 1, PM.free_port()):
        assert PM.init_distributed(dev.type)
    try:
        assert dist.get_backend() == "nccl", dist.get_backend()
        mesh = PM.make_mesh_for_batch(TRAIN_BATCH, dev.type)
        assert (mesh.size, mesh.rank, mesh.device) == (
            1, 0, torch.device("cuda", 0)), mesh
        t = torch.arange(4.0, device=dev)
        dist.all_reduce(t, group=mesh.group)
        dist.broadcast(t, src=0, group=mesh.group)
        (g,) = PM.gather_rows(mesh, t[:, None])
        torch.cuda.synchronize()
        assert torch.equal(g[:, 0], torch.arange(4.0, device=dev))
        patches = {}
        for name, m in (("mesh", mesh), ("meshless", None),
                        ("meshless_again", None)):
            tr = PT.PatchTrainer(exp, net, params, seed=SEED, device=dev,
                                 log=lambda s: None, mesh=m)
            for images, labels in staged:
                tr.step(images, labels)
            patches[name] = tr.patch.detach().clone()
            del tr
        rec["one_rank_equal_meshless"] = torch.equal(patches["mesh"],
                                                     patches["meshless"])
        rec["meshless_runs_equal"] = torch.equal(patches["meshless"],
                                                 patches["meshless_again"])
        assert rec["one_rank_equal_meshless"], "one-rank mesh != meshless"
    finally:
        dist.destroy_process_group()
    del patches
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    rec["cards"] = n_cards
    if n_cards < 2:
        log("[mesh] the two-process NCCL check needs two cards; this "
            f"machine has {n_cards}: it ran the one-rank group alone")
    else:
        rec["two_process"] = two_process_cli(dev)
    log(f"[mesh] {json.dumps(rec)} ({card})")
    return rec


def two_process_cli(dev) -> dict:
    """The training CLI (``paper_obj`` b24, 48 synthetic tiles, one
    epoch) as two NCCL processes on cards 0 and 1 (so rank 1's kernels
    run on ``cuda:1``), against the same CLI in this process: the loss
    parts within 1e-3 relative (bfloat16; each rank's half batch may take
    its own conv algorithms; 1.3e-4 seen on H100s)."""
    cli = import_port("cli.train_patch")
    PM = import_port("parallel.mesh")
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    args = ["--mode", "paper_obj", "--synthetic", "48", "--batch-size",
            str(TRAIN_BATCH), "--img-size", str(SIZE), "--patch-size",
            str(PATCH), "--epochs", "1", "--device", "cuda"]
    try:
        one = cli.main(args + ["--out-dir", os.path.join(root, "one")])
        ref = one.history[0]
        del one
        torch.cuda.empty_cache()
        outs = PM.run_ranks(
            ("-m", f"{PORT}.cli.train_patch", *args, "--out-dir",
             os.path.join(root, "two")), 2, PM.child_env(), 600)
        for r, (rc, out, err) in enumerate(outs):
            out += err
            assert rc == 0, f"rank {r}:\n{out[-3000:]}"
            # each rank trains on its own card
            assert f"device: cuda:{r} (" in out, out[-3000:]
        with open(os.path.join(root, "two", "history.json")) as f:
            two = json.load(f)[0]
        rel = {k: abs(two[k] - ref[k]) / max(abs(ref[k]), 1e-30)
               for k in ("loss", "no_obj", "no_cls", "tv", "nps",
                         "colorful")}
        assert two["num_batches"] == ref["num_batches"]
        assert all(v <= 1e-3 for v in rel.values()), rel
        return {"loss_rel": rel, "one": ref["loss"], "two": two["loss"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def step_trace(dev, card) -> dict:
    """Phase 12: a profiler trace (``utils.profiling.trace``) of 5 default
    b24 steps after warm-up: the device's busy share over the traced steps
    (from the host's start of the first step to the end of the last),
    its time by category, the 10 device operations that take the most
    time, and the longest idle gaps. ``tools/step_profile`` captures and
    reads the trace (``capture``, ``read_trace``, ``steps_window``,
    ``device_intervals``, ``attribute``)."""
    PT = import_port("train.trainer")
    SP = import_port("tools.step_profile")
    SyntheticData = import_port("data").SyntheticData
    exp = import_port("train").get_experiment("paper_obj", batch_size=TRAIN_BATCH,
                           img_size=SIZE, patch_size=PATCH)
    tr = PT.PatchTrainer(exp, seed=SEED, device=dev, log=lambda s: None)
    data = SyntheticData(48, SIZE, exp.max_labels, seed=SEED + 50)
    staged = [tuple(torch.from_numpy(a).to(dev) for a in
                    data.batch(TRAIN_BATCH, i)) for i in range(2)]
    for i in range(3):
        tr.step(*staged[i % 2])
    calls = iter(range(TRACE_STEPS))
    path = SP.capture(lambda: tr.step(*staged[next(calls) % 2]),
                      TRACE_STEPS, dev)
    try:
        events = SP.read_trace(path)
    finally:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    del tr
    torch.cuda.empty_cache()
    window = SP.steps_window(events)
    assert any(e.get("name") == SP.WINDOW for e in events), "no window"
    merged, ops = SP.device_intervals(events, window)
    assert ops, "the trace holds no device operation"
    busy = sum(e - s for s, e in merged)
    span = window[1] - window[0]
    # device time by name and by category (``step_profile.CATEGORIES``)
    by_name, by_kind = SP.attribute(ops)
    top = by_name.most_common(10)
    ends = {e: n for _, e, n in ops}
    starts = {}
    for s, _, n in ops:
        starts.setdefault(s, n)
    gaps = []
    edges = [[window[0], window[0]]] + merged + [[window[1], window[1]]]
    for (s0, e0), (s1, e1) in zip(edges, edges[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, e0 - window[0], ends.get(e0, "start"),
                         starts.get(s1, "end")))
    gaps.sort(reverse=True)
    rec = {"steps": TRACE_STEPS, "window_ms": span / 1e3,
           "ms_per_step_traced": span / 1e3 / TRACE_STEPS,
           "device_busy_ms": busy / 1e3, "busy_share": busy / span,
           "idle_share": 1 - busy / span, "device_ops": len(ops),
           "distinct_ops": len(by_name),
           "share_by_kind": {k: d / span for k, d in sorted(
               by_kind.items(), key=lambda kv: -kv[1])},
           "top_ops": [{"name": n[:120], "ms": d / 1e3,
                        "share_of_window": d / span,
                        "calls": sum(1 for o in ops if o[2] == n)}
                       for n, d in top],
           "longest_gaps": [{"us": g, "at_ms": at / 1e3,
                             "after": a[:80], "before": b[:80]}
                            for g, at, a, b in gaps[:8]],
           "gaps_over_20us": sum(1 for g, *_ in gaps if g > 20),
           "idle_in_gaps_over_20us_ms": sum(g for g, *_ in gaps
                                            if g > 20) / 1e3}
    assert 0.0 < rec["busy_share"] <= 1.0, rec["busy_share"]
    log(f"[trace] {json.dumps(rec)} ({card})")
    return rec


EVAL_TILES = 16      # full-width eval sweep: two b8 images_filter batches
EVAL_PGD_STEPS = 3   # full-width PGD steps (b2)


def structural_match(ours, ref, nms_thresh: float, atol=1e-3) -> int:
    """Two detection sets equal up to greedy-NMS tie order (T2, the check
    of ``tests/test_refparity.py``): counts within max(2, 1.5%), at most
    3% of ``ref`` unmatched 1-1 within ``atol``, each unmatched reference
    row overlapping (IoU > nms_thresh) one of our unmatched rows, another
    representative of its suppression cluster. Returns the rows matched
    1-1; raises otherwise."""
    ours = np.asarray(ours, np.float32).reshape(-1, 7)
    ref = np.asarray(ref, np.float32).reshape(-1, 7)
    assert abs(len(ours) - len(ref)) <= max(2, 0.015 * len(ref)), (
        len(ours), len(ref))
    used = np.zeros(len(ref), bool)
    mine = np.zeros(len(ours), bool)
    for i, row in enumerate(ours):
        d = np.abs(ref - row).max(axis=1)
        d[used] = np.inf
        j = int(np.argmin(d))
        if d[j] <= atol:
            used[j] = mine[i] = True
    assert (~used).sum() <= 0.03 * len(ref), ((~used).sum(), len(ref))
    alt = ours[~mine]
    for r in ref[~used]:
        x1, y1 = alt[:, 0] - alt[:, 2] / 2, alt[:, 1] - alt[:, 3] / 2
        x2, y2 = alt[:, 0] + alt[:, 2] / 2, alt[:, 1] + alt[:, 3] / 2
        iw = np.clip(np.minimum(r[0] + r[2] / 2, x2)
                     - np.maximum(r[0] - r[2] / 2, x1), 0, None)
        ih = np.clip(np.minimum(r[1] + r[3] / 2, y2)
                     - np.maximum(r[1] - r[3] / 2, y1), 0, None)
        inter = iw * ih
        iou = inter / (r[2] * r[3] + alt[:, 2] * alt[:, 3] - inter + 1e-12)
        assert len(alt) and iou.max() > nms_thresh, r
    return int(used.sum())


@contextlib.contextmanager
def timed_calls(owner, name: str, log: list, keep_result=False):
    """Replace ``owner.name`` for the block with a wrapper that appends
    (host ms, CUDA-event ms[, result]) of each call to ``log``; both
    clocks bracket the call between synchronizations."""
    real = getattr(owner, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = real(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t0) * 1e3,
                    start.elapsed_time(end)) + ((out,) if keep_result
                                                else ()))
        return out
    setattr(owner, name, wrapper)
    try:
        yield
    finally:
        setattr(owner, name, real)


def as_7col(rows: np.ndarray) -> np.ndarray:
    """5-column ``cls x y w h`` rows as 7-column ``x y w h 0 0 cls``."""
    if rows.shape[1] == 7:
        return rows
    return np.concatenate([rows[:, 1:5], np.zeros((len(rows), 2),
                                                  np.float32), rows[:, :1]], 1)


def label_dir(path: str) -> dict:
    L = import_port("data.labels")
    return {n: L.read_label_file(os.path.join(path, n), None)
            for n in sorted(os.listdir(path)) if n.endswith(".txt")}


def report_finite(report: dict, pred: str, gt: str) -> None:
    """Every value of a ``test_patch_metrics`` report over the label dirs
    ``pred`` and ``gt`` is finite, but an M2 whose instance gap is zero
    (NaN by definition) and the M2@0.4 quirk where a 5-column file holds
    a non-finite height (the quirk sums that column; random weights
    overflow ``exp`` into inf boxes)."""
    gaps = {"M2_avg_conf_created_04_quirk":
            report["instances_pred_04"] - report["instances_gt_04"],
            "M2_avg_conf_created_001":
            report["instances_pred_001"] - report["instances_gt_001"]}
    heights_finite = all(
        np.isfinite(rows[:, 4]).all() for d in (pred, gt)
        for rows in label_dir(os.path.join(d, "yolo-labels")).values()
        if rows.shape[1] == 5)
    for k, v in report.items():
        vals = v if isinstance(v, list) else [v]
        if k in gaps and gaps[k] == 0:
            assert all(np.isnan(x) for x in vals), (k, v)
        elif k == "M2_avg_conf_created_04_quirk" and not heights_finite:
            assert not np.isfinite(v), (k, v)
        else:
            assert all(np.isfinite(x) for x in vals), (k, v)


def eval_pipeline(cli, model_args, raw, root, patch_png, patch_size, conf,
                  seed) -> dict:
    """``images_filter`` -> ``test_patch`` -> ``test_patch_metrics
    --json`` in-process under ``root``, with each CLI's wall time, the
    eval placements (``transform_patch_eval``'s centres and the
    half-edges of ``mask_semi_edge``) and the per-image time of the
    placement, the composite and the detection (host clock and CUDA
    events)."""
    attack = import_port("attack")
    EE = import_port("attack.eot_eval")
    det_mod = import_port("evals.detect")
    gt, att = os.path.join(root, "gt"), os.path.join(root, "attacked")
    rec = {}
    filt = []
    t0 = time.perf_counter()
    with timed_calls(det_mod.Detector, "detect_batch", filt):
        cli["images_filter"].main([*model_args, "--img-dir", raw,
                                   "--out-dir", gt, "--conf", str(conf),
                                   "--batch-size", "8"])
    torch.cuda.synchronize()
    rec["images_filter_s"] = time.perf_counter() - t0
    rec["images_filter_detect_batch_ms"] = [h for h, _ in filt]
    log(f"[eval] images_filter {rec['images_filter_s']:.2f} s")
    place, paste, detect, semi = [], [], [], []
    t0 = time.perf_counter()
    with timed_calls(attack, "transform_patch_eval", place, True), \
            timed_calls(attack, "paste_patch", paste), \
            timed_calls(det_mod.Detector, "detect_batch", detect), \
            timed_calls(EE, "mask_semi_edge", semi, True):
        cli["test_patch"].main([
            *model_args, "--patch", patch_png, "--patch-size",
            str(patch_size), "--img-dir", os.path.join(gt, "images"),
            "--lab-dir", os.path.join(gt, "yolo-labels_w_conf"),
            "--out-dir", att, "--conf", str(conf), "--seed", str(seed),
            "--save-images"])
    torch.cuda.synchronize()
    rec["test_patch_s"] = time.perf_counter() - t0
    log(f"[eval] test_patch {rec['test_patch_s']:.2f} s")
    rec["placements"] = [list(r[2][1]) for r in place]
    rec["semi_edges"] = [r[2] for r in semi]
    rec["split_ms"] = {
        part: {"host": [r[0] for r in log], "events": [r[1] for r in log]}
        for part, log in (("transform_patch_eval", place),
                          ("paste_patch", paste), ("detect", detect))}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        report = cli["test_patch_metrics"].main(
            ["--pred-dir", att, "--gt-dir", gt, "--json"])
    rec["metrics_s"] = time.perf_counter() - t0
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    assert set(printed) == set(report)
    report_finite(report, att, gt)
    rec["report"] = report
    n_kept = len(os.listdir(os.path.join(gt, "images")))
    for d, subs in ((gt, ("images", "yolo-labels", "yolo-labels_w_conf")),
                    (att, ("images", "yolo-labels", "yolo-labels_w_conf"))):
        for sub in subs:
            assert len(os.listdir(os.path.join(d, sub))) == n_kept, (d, sub)
    assert len(place) == len(semi) == n_kept
    rec["kept"] = n_kept
    rec["gt"], rec["attacked"] = gt, att
    return rec


def eot_composite_check(attack, patch_png, raw, labs, out, dev) -> dict:
    """Phase 13: ``paste_patch``'s first EOT composite computed again in
    float32 as the CLI computes it (the first draw of a generator seeded
    SEED on the card, the first image's label from ``labs``): every value
    finite, the PNG the CLI wrote its 8-bit quantization, and the PNG
    different from the source inside the pasted box (the bounding box of
    the pixels the patch changed). Returns the image, the changed pixels
    and the box."""
    from PIL import Image
    CC = import_port("cli.common")
    labels_mod = import_port("data.labels")
    ckpt = import_port("utils.checkpoint")
    name = CC.list_images(raw)[0]
    stem = os.path.splitext(name)[0]
    patch = torch.from_numpy(ckpt.load_patch_png(patch_png, PATCH)).to(dev)
    arr = torch.from_numpy(CC.load_scaled(os.path.join(raw, name),
                                          SIZE)).to(dev)
    labels = labels_mod.pad_labels(labels_mod.read_label_file(
        os.path.join(labs, stem + ".txt"), 5), 1)[None]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = attack.EOTConfig(img_size=SIZE)
    draws = attack.draw_eot(gen, 1, PATCH, cfg)
    adv, _, _ = attack.transform_patch(
        patch, torch.from_numpy(labels).to(dev), draws, cfg)
    comp = attack.paste_patch(arr[None], adv)[0].cpu().numpy()
    assert np.isfinite(comp).all(), "a non-finite EOT composite"
    png = np.asarray(Image.open(os.path.join(out, stem + ".png")))
    assert np.array_equal(png, (comp * 255).astype(np.uint8)), \
        "the EOT composite PNG is not the CLI's composite"
    pasted = (comp != arr.cpu().numpy()).any(-1)
    assert pasted.any(), "the EOT patch left the image as it was"
    rows, cols = np.nonzero(pasted)
    box = (slice(rows.min(), rows.max() + 1),
           slice(cols.min(), cols.max() + 1))
    src = np.asarray(Image.open(os.path.join(raw, name)))
    assert not np.array_equal(png[box], src[box]), \
        "the EOT composite PNG shows no patch in the pasted box"
    return {"image": name, "changed_pixels": int(pasted.sum()),
            "box_rows": [int(rows.min()), int(rows.max())],
            "box_cols": [int(cols.min()), int(cols.max())]}


def slim_stem_gates(model, x):
    """The slim victim's stem (convs 0, 1, 2, 3, 5, any widths) on the
    planar route and on the conv walk (float32, TF32 off, no grad): each
    route's leaky gates (NCHW, 1 where the value is > 0, else 0.1), and
    the (HWIO weight, float32 bias) pairs ``gated_stem_walk`` takes."""
    PC = import_port("ops.planar_conv")
    PSP = import_port("models.stem_planar")
    _cuda = import_port("ops._cuda")
    h = x.shape[1]
    stem = [(getattr(model, f"w{i}").permute(2, 3, 1, 0),
             getattr(model, f"b{i}")) for i in PSP.STEM_CONVS]
    widths = (h, h // 2, h // 2, h // 2, h // 4)
    with torch.no_grad(), _cuda.no_tf32():
        acts = PSP._forward(x.contiguous(), model.planar_stem_params()[0])
        gk = [torch.where(PC.from_planar(a, w, b.shape[0]).permute(
            0, 3, 1, 2) > 0, 1.0, 0.1) for a, w, (_, b) in
            zip(acts, widths, stem)]
        gw = []

        def conv(u, i, s):
            w, b = stem[i]
            p = F.conv2d(u, w.permute(3, 2, 0, 1), b, s,
                         (w.shape[0] - 1) // 2)
            gw.append(torch.where(p > 0, 1.0, 0.1))
            return p * gw[-1]
        y1 = conv(conv(x.permute(0, 3, 1, 2), 0, 1), 1, 2)
        y3 = conv(conv(y1, 2, 1), 3, 1)
        conv(y3 + y1, 4, 2)
    return gk, gw, stem


def eval_path(dev, card) -> dict:
    """Phase 13: the evaluation half on the card. (1) Full width
    (``yolov3_blocks()``, random He-normal weights from the seed, bf16,
    written as .cfg + .weights): the eval CLIs in-process over 16
    ``smooth_tile``s (counted launches: K3a ``split_phases``, K1, K3b);
    img/s of ``images_filter`` and ``test_patch``, the latter's per-image
    time split into placement, composite and detection. (2) The committed
    slim victim (trained, 608^2) on its three tiles, float32, on the card
    and on the CPU: ``images_filter`` labels equal up to NMS tie order
    (1e-3); then ``test_patch`` on both from the CPU run's ground truth
    (the placement reads label coordinates through ``int()``, so one
    last-digit difference in a label file can move it; the detections are
    compared apart), with equal placements and half-edges, detections
    equal up to tie order, M1 and the instance counts equal, the other
    report floats within 1e-3 (counted launches: K3a, K4, K3b). (3) PGD:
    the slim victim's first image gradient on its kernel route against
    the conv walk on the card (1e-4 relative L2) and the stepped images'
    sign flips; at full width, b2, 3 float32 steps (counted launches: K1
    ``save_acts``, K2, the tiled K3a, K3b), within eps and [0, 1]."""
    from PIL import Image
    M = import_port("models")
    native = import_port("utils.native")
    darknet = import_port("models.darknet")
    PP = import_port("attack.pgd")
    EE = import_port("attack.eot_eval")
    attack = import_port("attack")
    _cuda = import_port("ops._cuda")
    cli = {n: import_port(f"cli.{n}") for n in (
        "images_filter", "clean_img_pre", "test_patch", "test_patch_metrics",
        "paste_patch", "dataset_tools")}
    assert native.available(), native.BUILD_ERROR
    rec = {"native": native.library_path()}
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        # -- full width: the six CLIs (the phase's main path) ------------
        t0 = time.perf_counter()
        blocks = M.yolov3_blocks(width=SIZE, height=SIZE)
        net = M.build_network(blocks)
        assert len(M.conv_specs(net)) == 75
        cfg, wts = os.path.join(root, "v.cfg"), os.path.join(root, "v.weights")
        M.write_darknet_cfg(blocks, cfg)
        M.save_darknet_weights(net, M.init_params(net, SEED), wts)
        raw, _, _ = write_tiles(os.path.join(root, "tiles"), EVAL_TILES,
                                SEED + 40)
        rng = np.random.default_rng(SEED + 41)
        patch_png = os.path.join(root, "patch.png")
        Image.fromarray((rng.random((PATCH, PATCH, 3)) * 255).astype(
            np.uint8)).save(patch_png)
        rec["setup_s"] = time.perf_counter() - t0
        model = ["--cfgfile", cfg, "--weightfile", wts, "--img-size",
                 str(SIZE), "--device", dev.type]
        reset_counts()
        full = eval_pipeline(cli, model, raw, os.path.join(root, "full"),
                             patch_png, PATCH, 0.01, SEED)
        t0 = time.perf_counter()
        cli["clean_img_pre"].main([*model, "--img-dir", raw, "--out-dir",
                                   os.path.join(root, "clean"), "--conf",
                                   "0.2"])
        full["clean_img_pre_s"] = time.perf_counter() - t0
        assert len(os.listdir(os.path.join(root, "clean", "yolo-labels"))) \
            == EVAL_TILES
        # EOT placement from finite labels: one box a tile, at its center
        # (the random victim's own labels have inf heights, and a patch
        # scaled from them is not finite)
        eot_labs = os.path.join(root, "eot_labels")
        os.makedirs(eot_labs)
        for n in os.listdir(raw):
            with open(os.path.join(eot_labs, os.path.splitext(n)[0]
                                   + ".txt"), "w") as f:
                f.write("0 0.5 0.5 0.25 0.25\n")
        for mode, extra in (("fixed", ["--fixed-center", "0.5", "0.5",
                                       "--fixed-scale", "0.4"]),
                            ("eot", ["--lab-dir", eot_labs, "--seed",
                                     str(SEED)])):
            out = os.path.join(root, f"paste_{mode}")
            t0 = time.perf_counter()
            cli["paste_patch"].main(["--patch", patch_png, "--patch-size",
                                     str(PATCH), "--img-dir", raw,
                                     "--out-dir", out, "--img-size",
                                     str(SIZE), "--device", dev.type, *extra])
            full[f"paste_patch_{mode}_s"] = time.perf_counter() - t0
            names = sorted(os.listdir(out))
            assert len(names) == EVAL_TILES
            for n in names[:4]:
                got = np.asarray(Image.open(os.path.join(out, n)))
                src = np.asarray(Image.open(os.path.join(raw, n)))
                assert not np.array_equal(got, src), (mode, n)
                if mode == "fixed":   # the patch spans rows 0.3-0.7
                    assert np.array_equal(got[:SIZE // 4], src[:SIZE // 4])
            if mode == "eot":
                full["paste_patch_eot_composite"] = eot_composite_check(
                    attack, patch_png, raw, eot_labs, out, dev)
        stats = io.StringIO()
        with contextlib.redirect_stdout(stats):
            # the 7-column dir: ``instances_per_class`` reads the class
            # from the last column (in a 5-column file, the height, which
            # random weights make inf), as the JAX package's CLI does
            cli["dataset_tools"].main(["stats", "--img-dir", os.path.join(
                full["gt"], "images"), "--lab-dir", os.path.join(
                full["gt"], "yolo-labels_w_conf"), "--ncols", "7"])
        assert f"images: {full['kept']}" in stats.getvalue()
        torch.cuda.synchronize()
        launches = read_counts()
        for k in SERVE_PATH:
            assert launches[k] > 0, f"{k} did not launch on the eval path"
        full["launches"] = launches
        full["images_filter_img_per_s"] = EVAL_TILES / full["images_filter_s"]
        full["test_patch_img_per_s"] = full["kept"] / full["test_patch_s"]
        full["label_rows"] = {
            sub: sum(len(v) for v in label_dir(os.path.join(
                full["gt"], sub)).values())
            for sub in ("yolo-labels", "yolo-labels_w_conf")}
        rec["full_width"] = {k: v for k, v in full.items()
                             if k not in ("gt", "attacked")}
        log(f"[eval] full width: {EVAL_TILES} tiles, kept {full['kept']}, "
            f"images_filter {full['images_filter_img_per_s']:.2f} img/s, "
            f"test_patch {full['test_patch_img_per_s']:.2f} img/s, "
            f"metrics {full['metrics_s']:.1f} s, test_patch per image "
            f"(median host ms) "
            f"{ {k: float(np.median(v['host'])) for k, v in full['split_ms'].items()} }, "
            f"label rows {full['label_rows']}, launches "
            f"{ {k: v for k, v in launches.items() if v} } ({card})")

        # -- the slim victim on the card against the CPU ----------------
        slim = os.path.join(ROOT, "tests", "fixtures", "refparity_slim")
        sraw = os.path.join(root, "slim_raw")
        os.makedirs(sraw)
        for i in range(3):
            shutil.copy(os.path.join(slim, f"tile_{i}.png"), sraw)
        smodel = ["--cfgfile", os.path.join(slim, "yolov3_dota_slim.cfg"),
                  "--weightfile", os.path.join(slim,
                                               "yolov3_dota_slim.weights"),
                  "--img-size", str(SIZE), "--fp32"]
        runs = {}
        sides = (("cpu", "cpu"), ("card", dev.type))
        for side, where in sides:
            base = os.path.join(root, f"slim_{side}")
            os.makedirs(base)
            if side == "card":
                reset_counts()
            gt = os.path.join(base, "gt")
            t0 = time.perf_counter()
            cli["images_filter"].main([*smodel, "--device", where,
                                       "--img-dir", sraw, "--out-dir", gt,
                                       "--conf", "0.01"])
            runs[side] = {"images_filter_s": time.perf_counter() - t0,
                          "gt": gt}
        cpu_gt = runs["cpu"]["gt"]
        for side, where in sides:
            att = os.path.join(root, f"slim_{side}", "attacked")
            place, semi = [], []
            t0 = time.perf_counter()
            with timed_calls(attack, "transform_patch_eval", place, True), \
                    timed_calls(EE, "mask_semi_edge", semi, True):
                cli["test_patch"].main([
                    *smodel, "--device", where, "--patch", patch_png,
                    "--img-dir", os.path.join(cpu_gt, "images"),
                    "--lab-dir", os.path.join(cpu_gt, "yolo-labels_w_conf"),
                    "--out-dir", att, "--conf", "0.01", "--seed",
                    str(SEED)])
            runs[side]["test_patch_s"] = time.perf_counter() - t0
            if side == "card":
                runs[side]["launches"] = {k: v for k, v in
                                          read_counts().items() if v}
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                runs[side]["report"] = cli["test_patch_metrics"].main(
                    ["--pred-dir", att, "--gt-dir", cpu_gt, "--json"])
            runs[side]["placements"] = [list(r[2][1]) for r in place]
            runs[side]["semi_edges"] = [r[2] for r in semi]
            runs[side]["attacked"] = att
        c, g = runs["cpu"], runs["card"]
        assert len(c["placements"]) == 3
        assert g["placements"] == c["placements"], (g["placements"],
                                                    c["placements"])
        assert g["semi_edges"] == c["semi_edges"], (g["semi_edges"],
                                                    c["semi_edges"])
        matched = {}
        for what, a, b in (("gt", g["gt"], c["gt"]),
                           ("attacked", g["attacked"], c["attacked"])):
            for sub in ("yolo-labels_w_conf", "yolo-labels"):
                ours, ref = label_dir(os.path.join(a, sub)), label_dir(
                    os.path.join(b, sub))
                assert list(ours) == list(ref), (what, sub)
                matched[f"{what}/{sub}"] = [
                    [structural_match(as_7col(ours[n]), as_7col(ref[n]),
                                      0.4), len(ref[n])] for n in ref]
        # the card's own ground truth, as text, against the CPU's
        differ = 0
        for n in sorted(os.listdir(os.path.join(c["gt"],
                                                "yolo-labels_w_conf"))):
            with open(os.path.join(c["gt"], "yolo-labels_w_conf", n)) as f:
                a = f.read().splitlines()
            with open(os.path.join(g["gt"], "yolo-labels_w_conf", n)) as f:
                b = f.read().splitlines()
            differ += sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
        rg, rc = g["report"], c["report"]
        for k, v in rc.items():
            if k.startswith("M1") or k.startswith("instances"):
                assert rg[k] == v, (k, rg[k], v)
            elif isinstance(v, list):
                assert rg[k] == v, (k, rg[k], v)
            elif np.isnan(v):
                assert np.isnan(rg[k]), k
            else:
                assert abs(rg[k] - v) <= 1e-3, (k, rg[k], v)
        for k in ("to_planar", "from_planar") + K4_VARIANTS[:3]:
            assert g["launches"].get(k, 0) > 0, (k, g["launches"])
        rec["slim"] = {
            "placements": c["placements"], "semi_edges": c["semi_edges"],
            "matched_rows": matched, "gt_text_lines_differing": differ,
            "report_cuda": rg, "report_cpu": rc,
            "launches_cuda": g["launches"],
            "seconds": {w: {k: v for k, v in r.items() if k.endswith("_s")}
                        for w, r in runs.items()}}
        log(f"[eval] slim victim card vs CPU: placements {c['placements']}, "
            f"semi-edges {c['semi_edges']}, rows matched {matched}, M1@0.01 "
            f"{rg['M1_avg_instances_created_001']} ({card})")

        # -- PGD ---------------------------------------------------------
        snet = M.network_from_cfg(os.path.join(slim,
                                               "yolov3_dota_slim.cfg"))
        sparams, _ = M.load_darknet_weights(
            snet, os.path.join(slim, "yolov3_dota_slim.weights"))
        xs = torch.stack([torch.from_numpy(np.asarray(Image.open(
            os.path.join(slim, f"tile_{i}.png")).convert("RGB"),
            np.float32) / 255.0) for i in range(2)]).to(dev)
        smodel32 = darknet.Darknet(snet, sparams, torch.float32, device=dev)
        g_k = PP.fabrication_grad(smodel32, xs)
        route = dict(darknet.last_routes())
        assert route["stem"] == "planar", route
        # the references: the conv walk as it is, and the conv walk
        # carrying the planar route's leaky gates in layers 0-5 (a flat
        # region whose pre-activation lies within rounding of 0 flips a
        # whole patch of gates between two summation orders)
        gates_k, gates_w, stem = slim_stem_gates(smodel32, xs)
        with _cuda.no_tf32(), torch.enable_grad():
            xw = xs.clone().requires_grad_(True)
            (g_w,) = torch.autograd.grad(
                PP.fabrication_loss(smodel32(xw)), xw)
            assert darknet.last_routes()["stem"] == "conv"
            xg = xs.clone().requires_grad_(True)
            y5 = gated_stem_walk(xg, stem, gates_k)
            (g_g,) = torch.autograd.grad(PP.fabrication_loss(
                smodel32.walk(y5, 6, {5: y5})), xg)
        rel = ((g_k - g_g).norm() / g_g.norm()).item()
        rel_walk = ((g_k - g_w).norm() / g_w.norm()).item()
        flipped_gates = [int((a != b).sum()) for a, b in zip(gates_k,
                                                             gates_w)]
        cfg1 = PP.PGDConfig(steps=1)
        adv1 = PP.make_pgd_fabrication(snet, cfg1)(sparams, xs)
        lo1 = torch.clamp(xs - cfg1.eps, 0, 1)
        hi1 = torch.clamp(xs + cfg1.eps, 0, 1)
        flips = (adv1 != torch.clamp(xs + cfg1.alpha * torch.sign(g_g),
                                     lo1, hi1)).float().mean().item()
        flips_walk = (adv1 != torch.clamp(
            xs + cfg1.alpha * torch.sign(g_w), lo1, hi1)).float().mean().item()
        assert rel <= 1e-4, rel
        assert flips <= 1e-4, flips
        if not any(flipped_gates):
            assert rel_walk <= 1e-4, rel_walk
        del smodel32, g_k, g_w, g_g
        fparams = M.init_params(net, SEED)
        xf = torch.stack([torch.from_numpy(smooth_tile(
            np.random.default_rng(SEED + 42 + i))) for i in range(2)]).to(
            dev).float() / 255.0
        cfgf = PP.PGDConfig(steps=EVAL_PGD_STEPS)
        attack_f = PP.make_pgd_fabrication(net, cfgf)
        reset_counts()
        advf = attack_f(fparams, xf)
        torch.cuda.synchronize()
        pgd_launches = {k: v for k, v in read_counts().items() if v}
        assert darknet.last_routes()["stem"] == "fused"
        for k in ("fused_stem_fwd_save_acts", "fused_stem_bwd_saved",
                  "to_planar_g5", "from_planar"):
            assert pgd_launches.get(k, 0) == EVAL_PGD_STEPS, pgd_launches
        assert bool(torch.isfinite(advf).all())
        assert (advf - xf).abs().max().item() <= cfgf.eps + 1e-6
        assert advf.min().item() >= 0.0 and advf.max().item() <= 1.0
        assert not torch.equal(advf, xf)
        fmodel = darknet.Darknet(net, fparams, torch.float32, device=dev)
        step_ms = time_ms(lambda: PP.fabrication_grad(fmodel, xf), 3, 1)
        rec["pgd"] = {"slim_grad_rel_l2": rel, "slim_route": route,
                      "slim_step_sign_flips": flips,
                      "slim_grad_rel_l2_vs_plain_walk": rel_walk,
                      "slim_step_sign_flips_vs_plain_walk": flips_walk,
                      "slim_gates_flipped_vs_plain_walk": flipped_gates,
                      "full_width_b2_launches": pgd_launches,
                      "full_width_b2_ms_per_step": step_ms,
                      "full_width_steps": EVAL_PGD_STEPS,
                      "max_abs_step": (advf - xf).abs().max().item()}
        log(f"[eval] PGD: slim gradient rel L2 {rel:.3g} against the walk "
            f"carrying the route's gates, {rel_walk:.3g} against the plain "
            f"walk (gates flipped {flipped_gates}; route {route}), sign "
            f"flips {flips:.3g} ({flips_walk:.3g}); full width b2 f32 {step_ms:.2f} ms a "
            f"step, launches {pgd_launches} ({card})")
        del fmodel, advf, xf
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


PROTO_RAW = 104      # slim protocol: raw scenes synthesized for 96 kept
PROTO_TRAIN = 96     # 4 b24 batches an epoch
PROTO_TEST = 16      # held-out scenes
PROTO_EPOCHS, PROTO_BREAK = 42, 21   # leg 2 resumes from epoch 20's checkpoint
SOAK_STEPS = 200     # full-width soak, b24
# the JAX package's recorded 150-epoch mini run (tests/test_attack_quality.py)
AQ_RECORD = {"M1_avg_instances_created_04": (49.8, 6.9),
             "M2_avg_conf_created_001": (1.87, 0.44)}


@contextlib.contextmanager
def recorded_clis(mods: dict, legs: list):
    """Replace each CLI module's ``main`` for the block with a wrapper that
    appends its leg to ``legs``: the CLI, its first arguments, its wall
    time (synchronized), the kernel launches it made and
    ``last_routes()`` after it."""
    darknet = import_port("models.darknet")
    real = {n: m.main for n, m in mods.items()}

    def wrap(name, fn):
        @functools.wraps(fn)
        def wrapper(argv=None):
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(argv)
            finally:
                torch.cuda.synchronize()
                after = read_counts()
                legs.append({
                    "cli": name, "argv": list(argv or [])[:4],
                    "seconds": time.perf_counter() - t0,
                    "launches": {k: after[k] - before[k] for k in after
                                 if after[k] != before[k]},
                    "routes": dict(darknet.last_routes())})
        return wrapper
    for n, m in mods.items():
        m.main = wrap(n, real[n])
    try:
        yield
    finally:
        for n, m in mods.items():
            m.main = real[n]


def metrics_finite(report: dict) -> None:
    """Every value of a ``test_patch_metrics --json`` report is finite,
    but an M2 whose instance gap is zero (NaN by definition, printed as
    null)."""
    gaps = {"M2_avg_conf_created_04_quirk":
            report["instances_pred_04"] - report["instances_gt_04"],
            "M2_avg_conf_created_001":
            report["instances_pred_001"] - report["instances_gt_001"]}
    for k, v in report.items():
        if k in gaps and gaps[k] == 0:
            assert v is None, (k, v)
            continue
        vals = v if isinstance(v, list) else [v]
        assert all(x is not None and np.isfinite(x) for x in vals), (k, v)


def protocol_path(dev, card) -> dict:
    """Phase 14: the attack-of-record tools (``<port>/tools/``) in this
    process, each CLI leg recorded (``recorded_clis``). (a)
    ``attack_quality --mini`` at its defaults: the trained patch beats the
    random control on M1@0.4 and M2@0.01. (b) The slim victim's protocol
    at 608^2, patch 224: ``protocol_prep``'s scenes and filter, then
    ``protocol_run`` (96 images, 42 epochs resumed at 21, 16 held-out
    scenes): 168 steps, every epoch logged once, K3a, K4 and K3b in the
    eval legs. (c) ``soak`` at full width, b24: each default training
    kernel once a step. (d) ``convergence_compare`` at its mini
    defaults."""
    tools = {n: import_port(f"tools.{n}") for n in (
        "attack_quality", "protocol_prep", "protocol_run",
        "convergence_compare", "soak")}
    clis = {n: import_port(f"cli.{n}") for n in (
        "images_filter", "train_patch", "test_patch", "test_patch_metrics")}
    root = tempfile.mkdtemp(prefix="chip_smoke_protocol_")
    legs, rec = [], {}
    try:
        with recorded_clis(clis, legs):
            reset_counts()
            # -- (a) attack quality on the mini victim -------------------
            t0 = time.perf_counter()
            aq_out = os.path.join(root, "aq")
            aq = tools["attack_quality"].main(
                ["--mini", "--out", aq_out, "--device", dev.type])
            aq_s = time.perf_counter() - t0
            t, r = aq["results"]["trained"], aq["results"]["random"]
            for rep in (t, r):
                metrics_finite(rep)
                assert len(rep["M4_per_class_gap_001"]) == 15
            for k in AQ_RECORD:
                assert t[k] > r[k], (k, t[k], r[k])
            run = os.path.join(aq_out, "run")
            n_b = [json.loads(line)["num_batches"] for line in open(
                os.path.join(run, "train_log.jsonl"))]
            aq_sched = tools["protocol_run"].schedule_summary(
                os.path.join(run, "train_log.jsonl"), n_b[-1], 0)
            rec["attack_quality"] = {
                "seconds": aq_s, "summary": aq,
                "steps": aq_sched["total_steps"],
                "steps_per_min_steady": aq_sched["steps_per_min_steady"],
                "legs": legs[:]}
            log(f"[protocol] (a) attack_quality --mini ({aq['epochs']} "
                f"epochs, {aq_sched['total_steps']} b24 steps at "
                f"{aq_sched['steps_per_min_steady']} steps/min, "
                f"{aq['test_scenes']} held-out scenes) in {aq_s:.1f} s: "
                + "; ".join(
                    f"{k} trained {t[k]:.3f} vs random {r[k]:.3f} (the JAX "
                    f"package's recorded 150-epoch run: {v[0]} vs {v[1]})"
                    for k, v in AQ_RECORD.items()) + f" ({card})")
            del legs[:]

            # -- (b) the protocol on the slim victim ---------------------
            slim = os.path.join(ROOT, "tests", "fixtures", "refparity_slim")
            cfg = os.path.join(slim, "yolov3_dota_slim.cfg")
            wts = os.path.join(slim, "yolov3_dota_slim.weights")
            prep = os.path.join(root, "slim")
            t0 = time.perf_counter()
            kept = tools["protocol_prep"].prepare(
                prep, cfg, wts, SIZE, PROTO_RAW, PROTO_TEST, SEED, dev.type)
            prep_s = time.perf_counter() - t0
            assert kept[0] >= PROTO_TRAIN and kept[1] == PROTO_TEST, kept
            n_prep = len(legs)
            out = os.path.join(prep, "run")
            t0 = time.perf_counter()
            ps = tools["protocol_run"].main([
                "--train-set", os.path.join(prep, "train_set"),
                "--gt", os.path.join(prep, "gt"), "--cfgfile", cfg,
                "--weightfile", wts, "--out", out, "--img-size", str(SIZE),
                "--patch-size", str(PATCH), "--train-images",
                str(PROTO_TRAIN), "--epochs", str(PROTO_EPOCHS),
                "--resume-break", str(PROTO_BREAK), "--seed", str(SEED),
                "--device", dev.type])
            run_s = time.perf_counter() - t0
            sched = ps["schedule"]
            assert (sched["epochs_run"], sched["total_steps"],
                    sched["resumed_at"]) == (
                PROTO_EPOCHS, PROTO_EPOCHS * PROTO_TRAIN // TRAIN_BATCH,
                PROTO_BREAK), sched
            with open(os.path.join(out, "cli.log")) as f:
                assert f"resumed at epoch {PROTO_BREAK}\n" in f.read()
            with open(os.path.join(out, "train", "train_log.jsonl")) as f:
                assert [json.loads(line)["epoch"] for line in f] == list(
                    range(PROTO_EPOCHS))
            for rep in ps["results"].values():
                metrics_finite(rep)
            evals = [g for g in legs[n_prep:] if g["cli"] == "test_patch"]
            assert len(evals) == 2, legs
            for g in evals:
                for k in ("to_planar", "from_planar") + K4_VARIANTS[:3]:
                    assert g["launches"].get(k, 0) > 0, (k, g)
            trains = [g for g in legs if g["cli"] == "train_patch"]
            rec["protocol_slim"] = {
                "prep_seconds": prep_s, "run_seconds": run_s,
                "kept": kept, "summary": ps, "legs": legs[:]}
            log(f"[protocol] (b) slim victim, 608^2, patch {PATCH}: prep "
                f"{prep_s:.1f} s (kept {kept}), protocol_run {run_s:.1f} s "
                f"(legs {ps['train_seconds']}); {sched['epochs_run']} epochs,"
                f" {sched['total_steps']} steps, resumed at "
                f"{sched['resumed_at']}, {sched['steps_per_min_steady']} "
                f"steps/min steady, loss {sched['loss_first']:.4f} -> "
                f"{sched['loss_last']:.4f}; M1@0.4 / M2@0.01 trained "
                f"{ps['results']['trained']['M1_avg_instances_created_04']}"
                f" / {ps['results']['trained']['M2_avg_conf_created_001']}"
                f", random "
                f"{ps['results']['random']['M1_avg_instances_created_04']}"
                f" / {ps['results']['random']['M2_avg_conf_created_001']}; "
                f"routes: train {[g['routes'] for g in trains]}, eval "
                f"{[g['routes'] for g in evals]} ({card})")
            del legs[:]

        # -- (c) the full-width soak -------------------------------------
        before = read_counts()
        soak = tools["soak"].main([str(SOAK_STEPS), str(TRAIN_BATCH),
                                   "--device", dev.type])
        after = read_counts()
        soak["launches"] = {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}
        assert soak["routes"]["stem"] == "fused", soak["routes"]
        for k in TRAIN_PATH:
            assert soak["launches"].get(k, 0) == SOAK_STEPS, soak["launches"]
        rec["soak"] = soak
        log(f"[protocol] (c) soak {SOAK_STEPS} steps b{TRAIN_BATCH} at full "
            f"width: {soak['steps_per_min']:.1f} steps/min, loss "
            f"{soak['loss_first']:.4f} -> {soak['loss_last']:.4f}, "
            f"launches {soak['launches']} ({card})")
        torch.cuda.empty_cache()

        # -- (d) the convergence table on the mini victim ----------------
        t0 = time.perf_counter()
        cc = tools["convergence_compare"].main(
            ["--out", os.path.join(root, "cc.json"), "--device", dev.type])
        cc_s = time.perf_counter() - t0
        assert len(cc["mini"]) == 20
        assert all(np.isfinite(v) for row in cc["mini"] for v in row.values())
        rec["convergence_compare"] = {"seconds": cc_s, "table": cc}
        log(f"[protocol] (d) convergence_compare (mini, 20 epochs, 96 "
            f"scenes) in {cc_s:.1f} s: epoch 0 {cc['mini'][0]}, epoch 19 "
            f"{cc['mini'][-1]}; reference epoch 0 {cc['reference_epoch0']} "
            f"({card})")
        torch.cuda.synchronize()
        rec["launches"] = read_counts()
        for k in ("to_planar_phases", "to_planar", "to_planar_g5",
                  "fused_stem_fwd_save_acts", "fused_stem_bwd_saved",
                  "from_planar") + K4_VARIANTS[:3]:
            assert rec["launches"][k] > 0, (k, rec["launches"])
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rec


SERVE_SOAK_S = 30       # serve_soak cut from the tool's 1,800 s to fit
# the repository tool's report keys (tools/serve_soak.py), in its order
SERVE_SOAK_KEYS = ("duration_s", "requests", "req_per_s", "latency_ms",
                   "batches", "mean_fill", "saturated_requests", "clients",
                   "max_batch", "wire", "img_size", "rss_mb", "rss_samples",
                   "devices")
# the JAX package's recorded warp A/B (600 steps, 64 held-out scenes, on
# another device and random stream): (train, paste) -> M1@0.4, M2@0.4,
# M1@0.01, M2@0.01
WARP_AB_RECORD = {("mxu", "mxu"): (11.766, 0.951, 3.656, 3.026),
                  ("mxu", "gather"): (11.766, 0.952, 3.766, 2.941),
                  ("gather", "mxu"): (11.766, 0.951, 3.656, 3.026),
                  ("gather", "gather"): (11.766, 0.952, 3.766, 2.941)}
WARP_DTYPE_RECORD = ("float32 and bfloat16 rows equal to 3 decimals, final "
                     "losses 0.035% apart")
AB_COLUMNS = ("M1@0.4", "M2@0.4", "M1@0.01", "M2@0.01")
# the warp A/Bs' gate: a trained row's M1@0.4 and M2@0.01 each more than
# AB_GATE times the control's (the same init patch, trained 0 steps,
# pasted through the same warp with the same draws)
AB_GATE_COLUMNS = ("M1@0.4", "M2@0.01")
AB_GATE = 2.0


def warp_ab_control(tool, dev) -> dict:
    """The A/Bs' control: the patch both A/Bs start from (``train_with``
    at 0 steps), pasted on the held-out scenes through each warp with the
    A/Bs' shared draws; paste warp -> its M1 / M2 row."""
    det, (imgs, labs), (eval_imgs, eval_labs), clean = tool.setup(64, dev)
    patch, _ = tool.train_with(det.model, imgs, labs, 0)
    draws = tool.paste_draws(64, dev)
    return {pw: tool.creation_row(det, tool.paste(patch, eval_imgs,
                                                  eval_labs, draws, pw),
                                  clean)
            for pw in ("mxu", "gather")}


def ab_gate(row: dict, control: dict) -> bool:
    return all(row[c] > AB_GATE * control[c] for c in AB_GATE_COLUMNS)


def launches_since(before: dict) -> dict:
    after = read_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def tools_path(dev, card, phase6_ms: float) -> dict:
    """Phase 15: the serving and training measurement tools and the warp
    A/Bs (``<port>/tools/``), each ``main(argv)`` in this process with
    ``--device cuda``, its summary printed on a line of its own. (a)
    ``serving_throughput 2048 8 16 uint8``: the service counts the 2,048
    requests and the warm one, mean fill <= 8, K3a ``split_phases``, K1
    and K3b launched. (b) ``detector_throughput
    16``: three finite positive rates. (c) ``serve_soak`` for
    ``SERVE_SOAK_S`` s (16 clients, b8, uint8): the repository tool's
    report keys, >= 1 request a second; RSS drift recorded. (d)
    ``perf_breakdown`` at b8 and b24: finite; at b24 K3a ``split_phases``,
    K1 ``save_acts``, K3b, the tiled K3a and K2 once a step. (e)
    ``step_profile 8 10``: the categories sum to the device's merged busy
    time over the window within 1% (one stream: no operation overlaps
    another, none is lost), stem-fwd, stem-bwd and layout non-zero. (f)
    ``warp_ab`` and ``warp_dtype_ab`` at their defaults: every metric
    finite, and every row's M1@0.4 and M2@0.01 more than ``AB_GATE``
    times those of the control (``warp_ab_control``: the untrained patch
    through the same paste warp), which fails that gate by construction
    and is recorded beside the clean count; printed beside the JAX
    package's record (not asserted: the random streams differ)."""
    import gc
    tools = {n: import_port(f"tools.{n}") for n in (
        "serving_throughput", "detector_throughput", "serve_soak",
        "perf_breakdown", "step_profile", "warp_ab", "warp_dtype_ab")}
    d = ["--device", dev.type]
    rec = {}

    def run(name, argv):
        """The tool's summary, and its launches and wall time apart."""
        before = read_counts()
        t0 = time.perf_counter()
        out = tools[name].main(argv + d)
        torch.cuda.synchronize()
        meta = {"launches": launches_since(before),
                "seconds_total": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
        return out, meta

    reset_counts()
    # -- (a) serving throughput ------------------------------------------
    st, meta = run("serving_throughput", ["2048", "8", "16", "uint8"])
    st.update(meta)
    assert st["served"] == 2048 + 1 and st["mean_fill"] <= 8, st
    for k in SERVE_PATH:
        assert st["launches"].get(k, 0) > 0, (k, st["launches"])
    rec["serving_throughput"] = st
    log(f"[tools] (a) serving_throughput {json.dumps(st)} ({card})")

    # -- (b) detector throughput -----------------------------------------
    dt, meta = run("detector_throughput", ["16"])
    for line in ("device_pipeline", "end_to_end", "detect_batch_device"):
        r = dt[line]
        assert all(np.isfinite(v) and v > 0 for v in r.values()), dt
    dt.update(meta)
    rec["detector_throughput"] = dt
    log(f"[tools] (b) detector_throughput {json.dumps(dt)} ({card})")

    # -- (c) serving soak, cut to SERVE_SOAK_S ---------------------------
    soak, meta = run("serve_soak", [
        "--duration", str(SERVE_SOAK_S), "--clients", "16", "--max-batch",
        "8", "--wire", "uint8"])
    assert tuple(soak) == SERVE_SOAK_KEYS, list(soak)
    assert soak["req_per_s"] >= 1.0, soak
    rec["serve_soak"] = {k: v for k, v in soak.items() if k != "rss_samples"}
    rec["serve_soak"].update(meta)
    log(f"[tools] (c) serve_soak {SERVE_SOAK_S} s (cut from 1,800): "
        f"{json.dumps(rec['serve_soak'])}; RSS drift "
        f"{soak['rss_mb']['drift']} MB (recorded, not asserted) ({card})")

    # -- (d) the training step at b8 and b24 ------------------------------
    pb = {}
    for b in (8, 24):
        pb[b], meta = run("perf_breakdown", [str(b)])
        pb[b].update(meta)
        assert np.isfinite(pb[b]["ms_per_step"]) and np.isfinite(
            pb[b]["loss"]), pb[b]
        assert pb[b]["routes"]["stem"] == "fused", pb[b]["routes"]
    steps = 3 + pb[24]["steps"]
    for k in TRAIN_PATH:
        assert pb[24]["launches"].get(k, 0) == steps, (k, pb[24]["launches"])
    rec["perf_breakdown"] = {f"b{b}": v for b, v in pb.items()}
    rec["perf_breakdown"]["phase6_b24_ms_per_step"] = phase6_ms
    log(f"[tools] (d) perf_breakdown {json.dumps(rec['perf_breakdown'])}; "
        f"b24 {pb[24]['ms_per_step']:.2f} ms/step beside phase 6's "
        f"{phase6_ms:.2f} ({card})")

    # -- (e) the step's device-time attribution ---------------------------
    sp, meta = run("step_profile", ["8", "10"])
    sp.update(meta)
    shutil.rmtree(os.path.dirname(sp["trace"]), ignore_errors=True)
    cats = sp["ms_per_step_by_category"]
    busy = sp["device_busy_ms"] / sp["steps"]
    assert abs(sum(cats.values()) - busy) <= 0.01 * busy, (cats, busy)
    for c in ("stem-fwd", "stem-bwd", "layout"):
        assert cats.get(c, 0.0) > 0, (c, cats)
    rec["step_profile"] = sp
    log(f"[tools] (e) step_profile {json.dumps(sp)} ({card})")

    # -- (f) the warp quality A/Bs ----------------------------------------
    control = warp_ab_control(tools["warp_ab"], dev)
    for pw, row in control.items():
        assert all(np.isfinite(row[c]) for c in AB_COLUMNS), row
        assert not ab_gate(row, row)
    rec["warp_ab_control"] = control
    log(f"[tools] (f) control (the init patch, 0 steps): "
        f"{json.dumps(control)}; M1@0.4 > 0 (the former check) "
        f"{all(r['M1@0.4'] > 0 for r in control.values())}, the gate "
        f"(> {AB_GATE}x the control on {'/'.join(AB_GATE_COLUMNS)}) "
        f"fails ({card})")
    for name in ("warp_ab", "warp_dtype_ab"):
        ab, meta = run(name, [])
        ab.update(meta)
        for row in ab["table"]:
            assert all(np.isfinite(row[c]) for c in AB_COLUMNS), row
            assert ab_gate(row, control[row.get("paste_warp", "mxu")]), (
                row, control)
        rec[name] = ab
        log(f"[tools] (f) {name} {json.dumps(ab)} ({card})")
    for row in rec["warp_ab"]["table"]:
        want = WARP_AB_RECORD[(row["train_warp"], row["paste_warp"])]
        log(f"[tools] (f) warp_ab {row['train_warp']:6s} "
            f"{row['paste_warp']:6s} " + "  ".join(
                f"{c} {row[c]:.3f} (JAX record {w})"
                for c, w in zip(AB_COLUMNS, want)))
    for row in rec["warp_dtype_ab"]["table"]:
        log(f"[tools] (f) warp_dtype_ab {row['warp_dtype']:8s} loss "
            f"{row['final_loss']:.4f} "
            + "  ".join(f"{c} {row[c]:.3f}" for c in AB_COLUMNS)
            + f" (JAX record: {WARP_DTYPE_RECORD})")
    rec["launches"] = read_counts()
    return rec


MICRO_STEP_BATCH = 24   # c12_ab step: phase 8's batch
FUSED_REL_ERR = 5e-2    # stem_fused_ab's b1 bf16 fused forward vs cuDNN
S2DX_TOL = 1e-5         # s2dx_poly_ab's float32 polyphase forms vs cuDNN
# what phase 16 must launch (entry names of the kernels line): K1 (and
# save_acts), K2, K5, K3a (step 1, split_phases, tiled), K3b (tiled,
# narrow), the four K4 variants, K6a save, K6b, K6c
MICRO_PATH = ("fused_stem_fwd", "fused_stem_fwd_save_acts",
              "fused_stem_bwd_saved", "fused_stem_bwd", "to_planar",
              "to_planar_phases", "to_planar_g5", "from_planar",
              "from_planar_narrow", *K4_VARIANTS, "res152_fused_save",
              "res152_fused_grad", "res152_fused_grad12")


def finite(values) -> bool:
    return all(np.isfinite(v) for v in values)


def micro_path(dev, card, phase7: dict, phase8: dict) -> dict:
    """Phase 16: the TPU-route A/B micro tools (``<port>/tools/``), each
    ``main(argv)`` in this process with ``--device cuda``, its summary
    printed on a line of its own, with its launches and wall time. (a)
    ``stem_ab 8 608``: every row finite; the chained backward's last piece
    (through ``from_planar``) equals ``_stem_bwd`` on the same inputs bit
    for bit (the tool counts the differing elements: 0); K4 1x1, 3x3 s1,
    3x3 s2 and ``k3t2`` launched. (b) ``stem_fused_ab 8 608``: the b1
    bf16 fused forward within ``FUSED_REL_ERR`` of the cuDNN walk; K1, K1
    ``save_acts``, K2 and K5 launched. (c) ``c12_ab grad`` and ``grad
    c12``: the routes asked for (the tool exits otherwise), finite
    digests, their gap recorded (not gated: bf16 summation orders); ``step
    24`` and ``step 24 c12``: on c12, K6a ``save`` and K6c once a step,
    the ms printed beside phase 8's (``phase8``: route -> ms/step). (d)
    ``c12_micro 24``: finite, K6a ``save``, K6b and K6c launched, each row
    beside phase 7's reading of the same kernel (``phase7``). (e)
    ``conv_micro 8``: finite, every TF/s below the bf16 peak (a reading
    above it is a timing fault). (f) ``s2dx_poly_ab 8``: both polyphase
    forms within ``S2DX_TOL`` max-rel of the float32 library adjoint (TF32
    off) at all five geometries. Every kernel of ``MICRO_PATH`` is
    launched over the phase."""
    import gc
    tools = {n: import_port(f"tools.{n}") for n in (
        "stem_ab", "stem_fused_ab", "c12_ab", "c12_micro", "conv_micro",
        "s2dx_poly_ab")}
    rec = {}

    def run(name, argv):
        """The tool's summary with its launches and wall time, printed."""
        before = read_counts()
        t0 = time.perf_counter()
        out = tools[name].main(argv + ["--device", dev.type])
        torch.cuda.synchronize()
        out["launches"] = launches_since(before)
        out["seconds_total"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        rec[" ".join([name, *argv])] = out
        log(f"[micro] {name} {' '.join(argv)} {json.dumps(out)} ({card})")
        return out

    reset_counts()
    # -- (a) the stem, cuDNN vs planar, and the planar backward's pieces --
    sa = run("stem_ab", [str(BATCH), str(SIZE)])
    assert finite([*sa["ms"].values(), *sa["pieces_ms"].values()]), sa
    assert sa["chain_vs_stem_bwd_differing"] == 0, sa
    for k in K4_VARIANTS:
        assert sa["launches"].get(k, 0) > 0, (k, sa["launches"])

    # -- (b) cuDNN vs planar vs fused ---------------------------------------
    sf = run("stem_fused_ab", [str(BATCH), str(SIZE)])
    assert finite(sf["ms"].values()), sf
    assert sf["fused_fwd_rel_err_b1"] < FUSED_REL_ERR, sf
    for k in ("fused_stem_fwd", "fused_stem_fwd_save_acts",
              "fused_stem_bwd_saved", "fused_stem_bwd"):
        assert sf["launches"].get(k, 0) > 0, (k, sf["launches"])

    # -- (c) the c12 route against the default: digests, step ms ----------
    digests = {}
    for c12 in ("", "c12"):
        g = run("c12_ab", ["grad"] + ([c12] if c12 else []))
        assert g["routes"] == tools["c12_ab"].WANT_ROUTES[bool(c12)], g
        assert finite([g[k] for k in ("loss", "gsum", "gmax", "gnorm")]), g
        digests[c12 or "default"] = g
    gap = {k: abs(digests["c12"][k] - digests["default"][k])
           / abs(digests["default"][k]) for k in ("loss", "gsum", "gnorm")}
    log(f"[micro] (c) c12_ab grad: c12 vs default relative gaps {gap} "
        f"(recorded, not gated: bf16 summation orders) ({card})")
    steps = {}
    for c12 in ("", "c12"):
        st = run("c12_ab", ["step", str(MICRO_STEP_BATCH)]
                 + ([c12] if c12 else []))
        assert finite([st["ms_per_step"], st["loss"]]), st
        n = 3 + st["steps"]
        if c12:
            for k in ("res152_fused_save", "res152_fused_grad12"):
                assert st["launches"].get(k, 0) == n, (k, st["launches"])
        steps[c12 or "default"] = st["ms_per_step"]
    log(f"[micro] (c) c12_ab step {MICRO_STEP_BATCH}: c12 "
        f"{steps['c12']:.2f} ms (phase 8: {phase8['c12']:.2f}), default "
        f"{steps['default']:.2f} ms (phase 8: {phase8['default']:.2f}) "
        f"({card})")
    rec["c12_ab_gap"] = gap

    # -- (d) the c12 stage backward taken apart --------------------------
    cm = run("c12_micro", [str(TRAIN_BATCH)])
    rows = {"res152_fused_save": cm["fwd_save_ms"],
            "res152_fused_grad": cm["bwd_g11_ms"],
            "res152_fused_grad12": cm["bwd_g12_ms"],
            "conv12_dgrad": cm["conv12_dgrad_ms"]}
    assert finite(rows.values()), cm
    for k in ("res152_fused_save", "res152_fused_grad",
              "res152_fused_grad12"):
        assert cm["launches"].get(k, 0) > 0, (k, cm["launches"])
    for k, ms in rows.items():
        log(f"[micro] (d) c12_micro {k}: {ms:.4f} ms (phase 7: "
            f"{phase7[k]:.4f}) ({card})")

    # -- (e) the victim's conv geometries on cuDNN -------------------------
    cv = run("conv_micro", [str(BATCH)])
    peak = PEAK_FLOPS[torch.bfloat16] / 1e12
    for r in cv["rows"]:
        assert finite([r["fwd_ms"], r["dx_ms"]]), r
        assert r["fwd_tflops"] < peak and r["dx_tflops"] < peak, r

    # -- (f) the stride-2 adjoint, polyphase vs cuDNN ----------------------
    s2 = run("s2dx_poly_ab", [str(BATCH)])
    assert len(s2["rows"]) == 5, s2
    for r in s2["rows"]:
        assert finite([r["xla_ms"], r["poly_ms"], r["poly_conv_ms"]]), r
        assert r["relerr_poly"] <= S2DX_TOL, r
        assert r["relerr_poly_conv"] <= S2DX_TOL, r

    rec["launches"] = read_counts()
    for k in MICRO_PATH:
        assert rec["launches"][k] > 0, (k, rec["launches"])
    return rec


ENTRY_BENCH_TIMEOUT_S = 600   # the bench subprocess: probe, child, 33 steps
ENTRY_CPU_RANKS = 4           # phase 17 (d): gloo ranks on the CPU


def entry_path(dev, card) -> dict:
    """Phase 17: the repository's root entry points on the port. (a) the
    bench as a user runs it (``python -m <port>.tools.bench``, a
    subprocess through ``run_ranks``, which stops it and its children on
    a timeout: the probe and one child a card): its record, and from its
    "# launches" line each kernel of ``TRAIN_PATH`` launched ``WARMUP +
    STEPS`` times; then ``bench.main`` in this process with both child
    timeouts at 1 s, no backoff and the probe's count of (a): the "error"
    record of a timed-out child, value 0.0. (b) ``entry()``'s forward: the heads' shapes, equal
    bit for bit to the ``Detector``'s forward of the same weights, on the
    fused stem, K3a ``split_phases``, K1 and K3b once each. (c)
    ``dryrun_multichip`` over NCCL on up to 4 cards. (d)
    ``dryrun_multichip(4, "cpu")``: 4 gloo ranks. Returns the record, whose "launches"
    are the bench child's counts plus ``entry()``'s call's (the
    ``Detector`` reference's forward is not counted; the dryruns' tiny
    victim takes no kernel)."""
    B = import_port("tools.bench")
    EN = import_port("tools.entry")
    PM = import_port("parallel.mesh")
    darknet = import_port("models.darknet")
    flops = import_port("models.flops")
    M, E = import_port("models"), import_port("evals")
    cards = torch.cuda.device_count()
    rec = {"cards": cards}

    # -- (a) the bench, as a subprocess, then a child that hangs ---------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ((bench_rc, stdout, stderr),) = PM.run_ranks(
        ("-m", f"{PORT}.tools.bench"), 1, PM.child_env(),
        ENTRY_BENCH_TIMEOUT_S)
    rec["bench_seconds"] = time.perf_counter() - t0
    assert bench_rc == 0, stderr[-3000:]
    lines = stdout.strip().splitlines()
    for line in lines[:-1]:
        log(f"[entry] (a) {line}")
    bench = json.loads(lines[-1])
    log(f"[entry] (a) bench record {json.dumps(bench)} in "
        f"{rec['bench_seconds']:.1f} s ({card})")
    assert "error" not in bench, bench
    assert bench["metric"] == (f"patch_train_steps_per_min_b8_"
                               f"{B._ranks(cards)}dev"), bench
    assert bench["value"] > 0 and np.isfinite(bench["ms_per_step"]), bench
    if flops.peak_flops_bf16(torch.cuda.get_device_name(0)) is not None:
        assert 0 < bench["mfu"] < 1, bench
    tag = "# launches: "
    child = json.loads(next(x for x in lines if x.startswith(tag))[len(tag):])
    assert set(child) <= set(counters()), child
    for k in TRAIN_PATH:
        assert child[k] == B.WARMUP + B.STEPS, (k, child)
    rec["bench"], rec["bench_launches"] = bench, child
    # the probe ran in (a); here it reports the cards without a process
    saved = {k: getattr(B, k) for k in ("_CHILD_TIMEOUT_S",
                                        "_CHILD_RETRY_TIMEOUT_S",
                                        "_BACKOFF_S", "_probe_device_count")}
    B._CHILD_TIMEOUT_S = B._CHILD_RETRY_TIMEOUT_S = 1.0
    B._BACKOFF_S = 0.0
    B._probe_device_count = lambda: cards
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            hung = B.main([])
    finally:
        for k, v in saved.items():
            setattr(B, k, v)
    assert hung["value"] == 0.0 and "timed out" in hung["error"], hung
    assert json.loads(B._extract_json_line(buf.getvalue())) == hung
    log(f"[entry] (a) 1-s child timeouts: {json.dumps(hung)} in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (b) entry(): the flagship forward at b1 ---------------------------
    reset_counts()
    fn, args = EN.entry()
    heads = fn(*args)
    torch.cuda.synchronize()
    forward = read_counts()
    routes = darknet.last_routes()
    assert [tuple(h.shape) for h in heads] == [
        (1, 19, 19, 60), (1, 38, 38, 60), (1, 76, 76, 60)], heads
    assert all(torch.isfinite(h).all() for h in heads)
    assert routes == {"stem": "fused", "res152": "conv"}, routes
    want = {"to_planar_phases": 1, "fused_stem_fwd": 1, "from_planar": 1}
    assert all(forward[k] == want.get(k, 0) for k in forward), forward
    net = fn.model.net
    det = E.Detector(net, M.fold_bn(net, M.init_params(net, 0)),
                     img_size=SIZE, compute_dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        ref = det._heads(args[0])
    rec["entry_equal_detector"] = all(torch.equal(a, b)
                                      for a, b in zip(heads, ref))
    assert rec["entry_equal_detector"], "entry() != the Detector's forward"
    rec["entry_forward_ms"] = time_ms(lambda: fn(*args), 10)
    log(f"[entry] (b) entry(): heads {[list(h.shape) for h in heads]}, "
        f"routes {routes}, launches {want}, equal to the Detector's "
        f"forward; {rec['entry_forward_ms']:.3f} ms a b1 forward ({card})")
    del fn, args, heads, det, ref
    torch.cuda.empty_cache()

    # -- (c) the dryrun over NCCL, (d) without a device ---------------------
    n = min(cards, 4)
    if n < 2:
        log(f"[entry] (c) the dryrun needs a card a rank; this machine has "
            f"{cards}: it runs a one-rank NCCL group")
    t0 = time.perf_counter()
    rc = EN.dryrun_multichip(n, "cuda")
    assert (rc["platform"], rc["n"]) == ("cuda", n), rc
    assert f"{n}-way cuda mesh" in rc["line"], rc
    log(f"[entry] (c) {rc['line']} in {time.perf_counter() - t0:.1f} s "
        f"({card})")
    t0 = time.perf_counter()
    rd = EN.dryrun_multichip(ENTRY_CPU_RANKS, "cpu")
    assert (rd["platform"], rd["n"]) == ("cpu", ENTRY_CPU_RANKS), rd
    assert f"{ENTRY_CPU_RANKS}-way cpu mesh" in rd["line"], rd
    log(f"[entry] (d) {rd['line']} in {time.perf_counter() - t0:.1f} s")
    rec["dryrun"] = {"cuda": rc, "cpu": rd}
    rec["launches"] = {k: v + child.get(k, 0) for k, v in forward.items()}
    return rec


def eot_warp_kernels(dev, card) -> tuple:
    """The EOT warp's kernel pair (``csrc/affine_warp.cu``; no Pallas
    counterpart: XLA's batched products in the JAX package) at b24, 224 ->
    608^2 and 416^2, bfloat16 (the step's) and float32. Each is checked
    against the plain warp on the card (forward and mask within one bf16
    ulp of each value / 2e-6, the gradient within 2^-7 / 1e-5 of its
    largest magnitude), then timed beside it: each kernel by CUDA events
    (``ms``) and by a CUDA graph of 20 calls (``device_ms``), against its
    byte bound (forward: the patch read and the [B, s, s, 4] buffer
    written; backward: the cotangent read inside each sample's footprint,
    the output pixels whose mask is not 0, and the patch's gradient
    written); the pair through autograd as the step runs it (forward, a
    product with a cotangent, backward: ``pair_ms``) beside the plain
    warp's (``plain_pair_ms``, ``plain_ms`` its forward alone), with each
    one's peak memory. The geometry is the card tests' (``warp_theta``).
    Returns the two kernels' entries and the launches their calls here
    counted (``launches_here``)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_torch_affine_warp_taps import warp_theta
    AM = import_port("ops.affine_mxu")
    b, p = TRAIN_BATCH, PATCH
    before = read_counts()
    fwd = {"name": "affine_warp_mxu", "route": "cuda",
           "source": f"{PORT}/csrc/affine_warp.cu",
           "replaces": "none (XLA's batched products in the JAX package's "
                       "ops/affine_mxu.py)", "readings": {}}
    bwd = dict(fwd, name="affine_warp_mxu_bwd", readings={})
    for s, pad in WARP_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            tag = f"b{b} {p}->{s} {str(dt).split('.')[-1]}"
            gen = torch.Generator().manual_seed(s)
            img = torch.rand(b, p, p, 3, generator=gen).to(dev, dt)
            theta = warp_theta(p, s, b=b, seed=s).to(dev)
            g = torch.randn(b, s, s, 3, generator=gen).to(dev)
            kw = dict(src_hw=(s, s), offset=(pad, pad))

            def pair(fn):
                it = img.clone().requires_grad_(True)
                out, mask = fn(it, theta, (s, s), **kw)
                (gi,) = torch.autograd.grad((out.float() * g).sum(), it)
                return out.detach(), mask.detach(), gi

            def peak(fn):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                pair(fn)
                torch.cuda.synchronize()
                return (torch.cuda.max_memory_allocated() - base) / 1e9

            got, want = pair(AM.affine_warp_mxu), pair(AM.affine_warp_mxu_plain)
            errs = {}
            for name, k, w in zip(("out", "mask", "grad"), got, want):
                k, w = k.float(), w.float()
                err = (k - w).abs().max().item()
                if name == "grad":
                    tol = (2.0 ** -7 if dt == torch.bfloat16 else 1e-5) * \
                        w.abs().max().item()
                    assert err <= tol, (tag, name, err, tol)
                elif dt == torch.bfloat16:
                    ulp = torch.exp2(torch.floor(torch.log2(
                        w.abs().clamp_min(1e-30))) - 7)
                    assert ((k - w).abs() <= ulp).all(), (tag, name, err)
                else:
                    assert err <= 2e-6, (tag, name, err)
                errs[name] = {"max_abs_err": err,
                              "equal_share": (k == w).float().mean().item()}
            coef = AM._kernel_coeffs(theta, (s, s), (s, s), (pad, pad))
            gd = g.to(dt)
            out4 = AM._warp_fwd(img, coef, (s, s))
            src_bytes = nbytes(img)
            footprint = int((out4[..., 3] != 0).sum().item())
            f_ms, f_by = bound(src_bytes + nbytes(out4), 0.0, dt)
            b_ms, b_by = bound(footprint * 3 * gd.element_size()
                               + src_bytes, 0.0, dt)
            common = {
                "errors": errs,
                "pair_ms": time_ms(lambda: pair(AM.affine_warp_mxu), 10),
                "plain_pair_ms": time_ms(
                    lambda: pair(AM.affine_warp_mxu_plain), 3, 1),
                "plain_ms": time_ms(lambda: AM.affine_warp_mxu_plain(
                    img, theta, (s, s), **kw), 3, 1),
                "pair_peak_gb": peak(AM.affine_warp_mxu),
                "plain_pair_peak_gb": peak(AM.affine_warp_mxu_plain)}
            fwd["readings"][tag] = {
                "ms": time_ms(lambda: AM._warp_fwd(img, coef, (s, s))),
                "device_ms": device_ms(lambda: AM._warp_fwd(
                    img, coef, (s, s))),
                "bound_ms": f_ms, "bound_by": f_by, **common}
            bwd["readings"][tag] = {
                "ms": time_ms(lambda: AM._warp_bwd(gd, coef, img.shape)),
                "device_ms": device_ms(lambda: AM._warp_bwd(
                    gd, coef, img.shape)),
                "bound_ms": b_ms, "bound_by": b_by,
                "footprint_share": footprint / (b * s * s)}
            r, rb = fwd["readings"][tag], bwd["readings"][tag]
            log(f"[warp] {tag}: fwd {r['ms']:.4f} ms (dev "
                f"{r['device_ms']:.4f}, bound {f_ms:.4f}), bwd "
                f"{rb['ms']:.4f} (dev {rb['device_ms']:.4f}, bound "
                f"{b_ms:.4f}, footprint {rb['footprint_share']:.3f} of "
                f"the canvas); pair through autograd {r['pair_ms']:.3f} ms, "
                f"{r['pair_peak_gb']:.2f} GB, against the plain warp's "
                f"{r['plain_pair_ms']:.3f} ms (forward "
                f"{r['plain_ms']:.3f}), {r['plain_pair_peak_gb']:.2f} GB; "
                f"errors {json.dumps(errs)} ({card})")
            del got, want, out4, gd, img, g
            torch.cuda.empty_cache()
    return [fwd, bwd], launches_since(before)


def warp_only() -> int:
    """``--warp``: the build and ``eot_warp_kernels`` alone."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    _cuda = import_port("ops._cuda")
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    info = _cuda.build_all()
    for line in info["affine_warp"]["log"].splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"    {line.strip()}")
    entries, launches = eot_warp_kernels(torch.device("cuda"), card)
    log(json.dumps({"eot_warp": entries, "launches_here": launches,
                    "card": card}))
    return 0


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
    phase("1 build")
    t0 = time.perf_counter()
    info = _cuda.build_all()
    log(f"[build] {time.perf_counter() - t0:.1f} s wall")
    for name, v in info.items():
        log(f"[build] {name}: {v['seconds']:.1f} s")
        for line in v["log"].splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"    {line.strip()}")
    tc_info = tensor_core_check(_cuda, info)
    layout_info = layout_resources(_cuda, info)
    k7_info = median_resources(_cuda, info)

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
    phase("2 serving kernels")
    kernels = []
    x8c = x8.contiguous()
    # K3a: split_phases (both column phases, one launch) and the step-1
    # narrow form at the planar stem's input (c_pad 8: [8, 608, 8, 640])
    def phases_at(dt):
        x = x8c.to(dt)
        pads = [(1, PC._round_up(w + 2, 128) - w - 1, 0, 5)
                for w in ((SIZE + 1) // 2, SIZE // 2)]
        return (lambda: SF.split_phases(x),
                lambda o: PC._to_planar_phases_into(x, *o, 8),
                lambda: (PC.to_planar_plain(x, 8, 2, 0),
                         PC.to_planar_plain(x, 8, 2, 1)),
                lambda: [F.pad(x[:, :, o::2].permute(0, 1, 3, 2), pads[o])
                         for o in (0, 1)], nbytes(x))
    kernels.append(layout_entry(
        "to_planar_phases", 124, phases_at, x8c.shape,
        "two F.pad calls on the phases' transposed views"))

    def step1_at(dt):
        x = x8c.to(dt)
        wl = PC._round_up(SIZE + 2, 128)
        return (lambda: PC.to_planar(x, 8),
                lambda o: PC._to_planar_into(x, o[0], 8),
                lambda: PC.to_planar_plain(x, 8),
                lambda: F.pad(x.permute(0, 1, 3, 2), (1, wl - SIZE - 1, 0, 5)),
                nbytes(x))
    kernels.append(layout_entry("to_planar", 124, step1_at, x8c.shape,
                                "F.pad on the transposed view"))
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
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": stem_yardstick(x8c, sp, backward=False)["fwd_ms"],
        "library_is": "the stem on cuDNN (stem_conv_walk: five convs, the "
                      "shortcut add and the leakys), bfloat16, forward, b8",
        "gflop": stem_flops(BATCH, SIZE) / 1e9, **tc_info["fused_stem_fwd"]}
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
    # K3b from_planar (stem output y5 -> NHWC): reads the image lanes of
    # y5's 128 channels (not its border and padding lanes)
    y5 = SF.fused_stem_fwd(xe, xo, sp)

    def y5_at(dt):
        y = y5.to(dt)
        view = y[:, :, :128, 1:SIZE // 4 + 1].permute(0, 1, 3, 2)
        return (lambda: PC.from_planar(y, SIZE // 4, 128),
                lambda o: PC._from_planar_into(y, o[0], SIZE // 4, 128),
                lambda: PC.from_planar_plain(y, SIZE // 4, 128),
                view.contiguous, image_bytes(y, SIZE // 4, 128))
    kernels.append(layout_entry("from_planar", 170, y5_at, y5.shape,
                                ".contiguous() of the image-lane view"))
    for k in kernels:
        log(f"[kernel] {k['name']}: err {k['max_abs_err']:.3g} "
            f"(tol {k['tol']:.3g}), {k['ms']:.4f} ms vs plain "
            f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.4f} ms "
            f"({k['bound_by']}) ({card})")

    # -- 3. serving (the main path; counted launches) ------------------
    phase("3 serving")
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
    # the default serving route is unchanged: fused stem, conv-walk stage
    assert darknet.last_routes() == {"stem": "fused", "res152": "conv"}
    assert all(launches[k] == 0 for k in K4_VARIANTS + K6_KERNELS
               + NEW_KERNELS + EXP_KERNELS), launches
    log(f"[serve] 16 service answers (rows {[len(a) for a in answers]}), "
        f"HTTP counts {http_counts}, batches {svc.stats.batches}, "
        f"saturated {svc.stats.saturated}; launches {launches}")
    for k in SERVE_PATH:
        assert launches[k] > 0, f"kernel {k} did not launch while serving"
    # split_phases: one K3a launch (both column phases) a stem forward
    assert launches["to_planar_phases"] == launches["fused_stem_fwd"], \
        launches
    assert launches["to_planar"] == 0, launches
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
    phase("4 goldens")
    # the slim victim's narrow stem takes the planar stem (K4), and with
    # res152="planar" its 32-wide stage too; launches counted per run
    fixtures = os.path.join(ROOT, "tests", "fixtures")
    golden_k4 = {}
    for d, name, res152, routes in (
            ("refparity", "mini_yolov3_dota", None, ("conv", "conv")),
            ("refparity_slim", "yolov3_dota_slim", None, ("planar", "conv")),
            ("refparity_slim", "yolov3_dota_slim", "planar",
             ("planar", "planar"))):
        with open(os.path.join(fixtures, d, "golden_boxes.json")) as f:
            golden = json.load(f)
        gnet = M.network_from_cfg(os.path.join(fixtures, d, f"{name}.cfg"))
        gparams, _ = M.load_darknet_weights(
            gnet, os.path.join(fixtures, d, f"{name}.weights"))
        gdet = E.Detector(gnet, gparams, img_size=golden["img_size"],
                          num_classes=golden["num_classes"],
                          compute_dtype=torch.float32, device=dev,
                          res152=res152)
        reset_counts()
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
            got = tuple(darknet.last_routes().values())
            assert got == routes, (d, res152, got)
            log(f"[golden] {d} (routes {got}) {key}: {n} boxes match 1-1 "
                f"within 1e-3")
        launches = read_counts()
        if routes[0] == "planar":
            # the forward alone: no stride-2 adjoint
            k4 = {k: launches[k] for k in K4_VARIANTS}
            assert all(v > 0 for k, v in k4.items()
                       if k != "planar_conv_k3t2"), k4
            assert k4["planar_conv_k3t2"] == 0, k4
            golden_k4[f"slim_res152_{res152 or 'conv'}"] = k4
            log(f"[golden] {d} res152={res152}: K4 launches {k4}")
        if routes == ("planar", "conv"):
            # the slim victim's bfloat16 Detector forward at b8: the planar
            # stem on the tensor-core K4 at its narrow widths (block widths
            # NW 1 and 2); each of its five K4 calls, recorded on the way,
            # is held against planar_conv_plain on the same inputs (two
            # bf16 ulps of the output scale, a mean below 1e-4 of it, zero
            # border and padding lanes); then timed, heads finite
            sdet = E.Detector(gnet, gparams, img_size=golden["img_size"],
                              num_classes=golden["num_classes"],
                              compute_dtype=torch.bfloat16, device=dev)
            gs = golden["img_size"]
            xs = torch.rand(BATCH, gs, gs, 3, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                SEED + 3)).to(torch.bfloat16)
            PSP = import_port("models.stem_planar")
            calls, k4_call = [], PSP.planar_conv

            def recorded(*a, **kw):
                out = k4_call(*a, **kw)
                calls.append((a, kw, out))
                return out
            reset_counts()
            PSP.planar_conv = recorded
            try:
                with torch.inference_mode():
                    heads = sdet._heads(xs)
                    torch.cuda.synchronize()
            finally:
                PSP.planar_conv = k4_call
            k4_16 = {k: v for k, v in read_counts().items() if v}
            assert tuple(darknet.last_routes().values()) == routes
            assert all(bool(torch.isfinite(hd).all()) for hd in heads)
            assert len(calls) == 5, len(calls)
            slim_checks = []
            with torch.inference_mode():
                for i, (a, kw, got) in enumerate(calls):
                    want = PC.planar_conv_plain(*a, **kw)
                    scale = max(want.float().abs().max().item(), 1e-30)
                    e = (got.float() - want.float()).abs()
                    err, mean_err = e.max().item(), e.mean().item()
                    wo = a[0].shape[1] // kw.get("stride", 1)
                    assert err <= 2.0 ** -6 * scale \
                        and mean_err <= 1e-4 * scale, (i, err, mean_err,
                                                       scale)
                    assert not got[..., 0].any() \
                        and not got[..., wo + 1:].any(), i
                    slim_checks.append({
                        "k": kw["k"], "stride": kw.get("stride", 1),
                        "cin": a[1].shape[2], "cout": a[1].shape[3],
                        "max_abs_err": err, "tol": 2.0 ** -6 * scale,
                        "mean_abs_err": mean_err})
                    del want, e
                del calls
                slim_bf16 = {"forward_ms": time_ms(lambda: sdet._heads(xs),
                                                   10),
                             "batch": BATCH, "launches": k4_16,
                             "k4_checks": slim_checks}
            assert all(k4_16.get(k, 0) > 0 for k in K4_VARIANTS[:3]), k4_16
            log(f"[golden] slim victim bfloat16 Detector forward b{BATCH}: "
                f"{json.dumps(slim_bf16)} ({card})")
            del sdet, heads, xs
        del gdet

    # -- 5. training kernels at the training shapes --------------------
    phase("5 training kernels")
    model_sbp = det.model.stem_bwd_params()
    train_kernels, layout_b24 = training_kernels(dev, sp, model_sbp, card,
                                                 tc_info)
    for k in kernels:
        if k["name"] == "fused_stem_fwd":
            k["dev_ms"] = layout_b24.pop("fused_stem_fwd")
            k["split_b24"] = layout_b24.pop("fused_stem_fwd_split_b24")
        elif k["name"] in layout_b24:
            k["b24"] = layout_b24[k["name"]]
    k5 = remat_kernel(dev, sp, det.model.stem_bwd_params(), card,
                      train_kernels[-1]["library_fwd_bwd_ms"], tc_info)
    # the wgmma records of K5 (here) and K8b (phase 9): device ms, split
    wg_recs = {n: {"dev_ms": layout_b24.pop(f"{n}_dev_ms"),
                   "split_b24": layout_b24.pop(f"{n}_split_b24")}
               for n in ("fused_stem_bwd", "fused_stem_bwd_b")}
    k5.update(wg_recs["fused_stem_bwd"])
    del det, svc
    torch.cuda.empty_cache()

    # -- 6. training (the second main path; counted launches) ----------
    phase("6 training")
    rec = training(dev, card)
    for k in train_kernels:
        k["launches"] = rec["launches"][k["name"]]
    kernels += train_kernels
    for k in kernels:
        k["train_launches_per_step"] = rec["launches_per_step"][k["name"]]

    # -- 7. planar-route and stage kernels at full width --------------
    phase("7 planar-route and stage kernels")
    model16 = darknet.Darknet(net, params, torch.bfloat16, device=dev)
    k4 = k4_entries(planar_kernels(dev, model16, card), tc_info)
    split = k4_split(dev, card)
    for k in k4:
        if k["name"] == "planar_conv_k3":
            k["split_b24"] = {"stage_fwd_conv7": split["stage_fwd_conv7"]}
        elif k["name"] == "planar_conv_k3s2":
            k["split_b24"] = {"stem_fwd_conv1": split["stem_fwd_conv1"]}
    k6 = stage_kernels(dev, model16, card, tc_info)
    k6c = grad12_kernel(dev, model16, card, tc_info)
    # the K6 rows' device times and cycle split at b24
    k6_dev = k6_readings(dev, model16)["dev_ms"]
    k6_sp = k6_split(dev, model16, k6_dev)
    for k in (*k6, k6c):
        k["dev_ms"], k["split_b24"] = k6_dev[k["name"]], k6_sp[k["name"]]
    del model16
    torch.cuda.empty_cache()
    # K3b's narrow form at the planar stem's input cotangent gx0
    # ([24, 608, 8, 640] -> [24, 608, 608, 3]): reads 3 channel rows' image
    # lanes
    gx0 = torch.randn(TRAIN_BATCH, SIZE, 8, PC._round_up(SIZE + 2, 128),
                      device=dev, generator=torch.Generator(
                          device=dev).manual_seed(SEED + 21))

    def gx0_at(dt):
        g = gx0.to(dt)
        view = g[:, :, :3, 1:SIZE + 1].permute(0, 1, 3, 2)
        return (lambda: PC.from_planar(g, SIZE, 3),
                lambda o: PC._from_planar_into(g, o[0], SIZE, 3),
                lambda: PC.from_planar_plain(g, SIZE, 3), view.contiguous,
                image_bytes(g, SIZE, 3))
    k3b_narrow = layout_entry("from_planar_narrow", 170, gx0_at, gx0.shape,
                              ".contiguous() of the image-lane view")
    # the tiled K3b at the same shape, the measurement that keeps a narrow
    # form (at c = 3 a tiled warp's tiles span one channel block, so 7 of
    # every 8 of its lanes have no tile): bit for bit, into NaN blocks
    k3b_narrow["tiled_form"] = {}
    for dt in (torch.bfloat16, torch.float32):
        g = gx0.to(dt)
        want = PC.from_planar_plain(g, SIZE, 3)

        def tiled(o):
            _cuda.launch("from_planar (tiled, c = 3)", "planar",
                         "apfp_from_planar", g, g.data_ptr(), o.data_ptr(),
                         _cuda.DTYPE_CODES[dt], *g.shape, SIZE, 3)
            return o
        got = tiled(torch.full_like(want, float("nan")))
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"tiled K3b at c = 3, {dt}"
        k3b_narrow["tiled_form"][str(dt).split(".")[1]] = {
            "ms": time_ms(lambda: tiled(torch.empty_like(want))),
            "device_ms": device_ms(lambda: tiled(torch.empty_like(want)))}
        del g, want, got
    log(f"[planar-kernel] from_planar_narrow: {json.dumps(k3b_narrow)} "
        f"({card})")
    del gx0

    # -- 8. training on the other routes (counted launches) ------------
    phase("8 training on the other routes")
    rrec = route_training(dev, card)
    # K3a's step-1 narrow form and K3b's narrow form run on the planar
    # stem (its input x; its input cotangent gx0)
    k3_planar = [k for k in kernels if k["name"] == "to_planar"] + [
        k3b_narrow]
    for k, run in [(k, "planar_planar") for k in k4 + k3_planar] + [
            (k, "fused_fused") for k in k6] + [(k5, "remat"), (k6c, "c12")]:
        k["launches"] = rrec[run]["launches"][k["name"]]
        k["train_launches_per_step"] = \
            rrec[run]["launches_per_step"][k["name"]]
        k["launches_on"] = f"paper_obj b24, routes {run}"
    # serving on the fused stage: K6a without masks (the forward alone),
    # which a training step never launches
    fdet = E.Detector(net, params, img_size=SIZE,
                      compute_dtype=torch.bfloat16, device=dev,
                      res152="fused")
    reset_counts()
    dets, _, _ = fdet.detect_batch_device(tiles[:BATCH], 0.4, 0.4)
    torch.cuda.synchronize()
    launches = read_counts()
    assert darknet.last_routes() == {"stem": "fused", "res152": "fused"}
    assert tuple(dets.shape) == (BATCH, 300, 7)
    assert launches["res152_fused"] == 1, launches
    assert launches["res152_fused_save"] == 0, launches
    with torch.inference_mode():
        rrec["serve_fused_stage"] = {
            "forward_ms": time_ms(lambda: fdet.model(
                x8, fused_stem=True, res152="fused"), 10),
            "forward_default_ms": time_ms(lambda: fdet.model(
                x8, fused_stem=True), 10)}
    log(f"[routes] serving b8 on the fused stage: launches {launches}, "
        f"{json.dumps(rrec['serve_fused_stage'])} ({card})")
    k6[0]["launches"] = launches["res152_fused"]
    k6[0]["launches_on"] = "serving b8, routes fused/fused"
    del fdet
    # serving on the c12 route: K1 and K6a without masks, K3b of y11 and
    # conv12 on cuDNN; no backward kernel
    cdet = E.Detector(net, params, img_size=SIZE,
                      compute_dtype=torch.bfloat16, device=dev, res152="c12")
    reset_counts()
    dets, _, _ = cdet.detect_batch_device(tiles[:BATCH], 0.4, 0.4)
    torch.cuda.synchronize()
    launches = read_counts()
    assert darknet.last_routes() == {"stem": "c12", "res152": "c12"}
    assert tuple(dets.shape) == (BATCH, 300, 7)
    want = {"to_planar_phases": 1, "fused_stem_fwd": 1, "res152_fused": 1,
            "from_planar": 1}
    assert all(launches[k] == want.get(k, 0) for k in launches), launches
    with torch.inference_mode():
        rrec["serve_c12"] = {
            "launches": launches,
            "forward_ms": time_ms(lambda: cdet.model(
                x8, fused_stem=True, res152="c12"), 10)}
    log(f"[routes] serving b8 on the c12 route: "
        f"{json.dumps(rrec['serve_c12'])} ({card})")
    del cdet
    for k in k4 + k6 + k3_planar + [k5, k6c]:
        assert k["launches"] > 0, k["name"]
    for k in k4:
        k["golden_launches"] = {run: v[k["name"]]
                                for run, v in golden_k4.items()}
        k["slim_bf16_forward_b8_ms"] = slim_bf16["forward_ms"]
    kernels += k4 + k6 + [k5, k6c, k3b_narrow]

    # -- 9. the experimental package (counted launches) -----------------
    phase("9 experimental package")
    k7 = median_kernel(dev, card, k7_info)
    k8 = batched_kernels(dev, sp, model_sbp, card, tc_info)
    k8[-1].update(wg_recs["fused_stem_bwd_b"])
    # K8a's device times and cycle split at b24, both forms
    k8a_dev = {n: device_ms(fn) for n, fn in k8a_calls(
        dev, sp, TRAIN_BATCH).items()}
    k8a_sp = k8a_split(dev, sp, k8a_dev)
    for k in k8[:2]:
        k["dev_ms"], k["split_b24"] = k8a_dev[k["name"]], k8a_sp[k["name"]]
    erec = experimental_path(dev, net, params, card, rec["breakdown_ms"])
    for k in [k7] + k8:
        k["launches"] = erec["launches"][k["name"]]
        k["launches_on"] = ("phase 9: K7 (network form) on the EOT patch "
                            "once, "
                            f"{EXP_PATH_STEPS} b24 victim fwd + bwd steps "
                            "through fused_stem_batched, one forward "
                            "without grad")
        assert k["launches"] > 0, k["name"]
    k7["network_launches"] = erec["launches"]["median_pool_2d_pallas_network"]
    kernels += [k7] + k8
    log(f"[exp] {json.dumps(erec)} ({card})")
    torch.cuda.empty_cache()

    # -- 9b. the EOT warp's kernel pair against the plain warp ----------
    phase("9b EOT warp")
    warp, warp_here = eot_warp_kernels(dev, card)
    for k in warp:
        # phase 6's training counts, as the other kernels' entries
        k["launches"] = rec["launches"][k["name"]]
        k["train_launches_per_step"] = rec["launches_per_step"][k["name"]]
        k["phase_9b_launches"] = warp_here.get(k["name"], 0)
        assert k["launches"] > 0 and k["phase_9b_launches"] > 0, k["name"]
    kernels += warp

    # -- 10. the device-store training path (counted launches) ---------
    phase("10 device-store training")
    srec = store_path(dev, card)
    for k in kernels:
        k["store_path_launches"] = srec["launches"][k["name"]]

    # -- 11. data parallelism: a one-rank NCCL group on the card -------
    phase("11 NCCL mesh")
    nccl_mesh(dev, card)

    # -- 12. a profiler trace of the default training step -------------
    phase("12 step trace")
    step_trace(dev, card)

    # -- 13. the evaluation path (counted launches) ---------------------
    phase("13 evaluation path")
    vrec = eval_path(dev, card)
    for k in kernels:
        k["eval_path_launches"] = vrec["full_width"]["launches"][k["name"]]
    log(f"[eval] {json.dumps(vrec)}")

    # -- 14. the attack-of-record tools (counted launches) --------------
    phase("14 attack-of-record tools")
    prec = protocol_path(dev, card)
    for k in kernels:
        k["protocol_path_launches"] = prec["launches"][k["name"]]
    log(f"[protocol] {json.dumps(prec)}")

    # -- 15. the measurement tools and the warp A/Bs (counted launches) -
    phase("15 measurement tools")
    trec = tools_path(dev, card, rec["ms_per_step"])
    for k in kernels:
        k["tools_path_launches"] = trec["launches"][k["name"]]
    log(f"[tools] {json.dumps(trec)}")

    # -- 16. the A/B micro tools (counted launches) -----------------------
    phase("16 micro tools")
    by_name = {k["name"]: k for k in k6 + [k6c]}
    mrec = micro_path(dev, card, {
        **{n: by_name[n]["ms"] for n in ("res152_fused_save",
                                         "res152_fused_grad",
                                         "res152_fused_grad12")},
        "conv12_dgrad": k6c["conv12_dgrad_ms"]},
        {r: rrec[r]["ms_per_step"] for r in ("c12", "default")})
    for k in kernels:
        k["micro_path_launches"] = mrec["launches"][k["name"]]

    # -- 17. the repository's root entry points (counted launches) -----
    phase("17 root entry points")
    nrec = entry_path(dev, card)
    for k in kernels:
        k["entry_path_launches"] = nrec["launches"][k["name"]]
    log(f"[entry] {json.dumps(nrec)}")
    phase("done")

    for k in kernels:
        if k["name"] in layout_info:
            k["resources"] = layout_info[k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# One tree's K4 readings for ``k4_ab``: phase 7's geometries and the cycle
# split, from that tree's own chip_smoke.py and kernels (what a parent
# commit already has)
K4_AB_CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
C.import_port("ops._cuda").build_all()
M = C.import_port("models")
darknet = C.import_port("models.darknet")
net = M.build_network(M.yolov3_blocks(width=C.SIZE, height=C.SIZE))
params = M.init_params(net, C.SEED)
dev, card = torch.device("cuda"), C.card_line()
model16 = darknet.Darknet(net, params, torch.bfloat16, device=dev)
recs = C.planar_kernels(dev, model16, card)
print("K4AB " + json.dumps({"geometries": recs,
                            "split": C.k4_split(dev, card)}))
"""


def ab_turns(parent: str, child: str, tag: str) -> list:
    """Run ``child`` (Python source, run from a tree's root: it imports
    that tree's chip_smoke.py and kernels) in the checkout at ``parent``
    and in this one, in turns (parent, this, this, parent), each in its
    own process on the one card, and return the record each printed last
    on a line starting with ``tag`` (JSON), with its ``tree``."""
    runs = []
    for label, tree in (("parent", parent), ("this", ROOT), ("this", ROOT),
                        ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", child], cwd=tree,
                             capture_output=True, text=True, timeout=1500)
        sys.stderr.write(out.stderr[-4000:])
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(tag + " ")]
        assert out.returncode == 0 and lines, (label, out.stdout[-4000:])
        rec = json.loads(lines[-1][len(tag) + 1:])
        rec["tree"] = label
        runs.append(rec)
    return runs


def k4_ab(parent: str) -> int:
    """``python3 chip_smoke.py --k4-ab DIR``: K4 in the checkout at DIR
    (a parent commit, e.g. unpacked by ``git archive``) and in this one,
    on one card in one call, in turns (``ab_turns``): phase 7's geometries
    (``planar_kernels``) and the cycle split (``k4_split``). Prints a
    ``[k4-ab]`` line a variant (the bfloat16 b24 sums of ms, cuDNN's and
    the bound) and one JSON record last."""
    card = card_line()
    runs = ab_turns(parent, K4_AB_CHILD, "K4AB")
    for rec in runs:
        for r in rec["geometries"]:
            if r["dtype"] == "bfloat16":
                log(f"[k4-ab] {rec['tree']} {r['conv']}: {r['ms']:.4f} ms, "
                    f"cuDNN {r['library_ms']:.4f}, bound "
                    f"{r['bound_ms']:.4f} ({card})")
    sums = {}
    for i, rec in enumerate(runs):
        for r in rec["geometries"]:
            if r["dtype"] != "bfloat16":
                continue
            v = sums.setdefault(r["variant"], {}).setdefault(
                f"{i}_{rec['tree']}", {"ms": 0.0, "library_ms": 0.0,
                                       "bound_ms": 0.0})
            for key in v:
                v[key] += r[key]
    for variant, by_run in sums.items():
        log(f"[k4-ab] {variant} b24 sums: " + "; ".join(
            f"{run} {v['ms']:.4f} ms (cuDNN {v['library_ms']:.4f}, bound "
            f"{v['bound_ms']:.4f})" for run, v in by_run.items())
            + f" ({card})")
    log(json.dumps({"k4_ab": runs, "sums": sums, "card": card}))
    return 0


# One tree's stem readings for ``stem_ab``, from that tree's own
# chip_smoke.py and kernels (what a parent commit already has): K5 as
# phase 5 times it (b24 bfloat16, ``time_ms`` over 5 calls), K8b as phase
# 9 does (over 3, on K8a's activations of the same x), K2 beside them, the
# device times and cycle split of the tree's wgmma stem kernels
# (``wgmma_device_times``, ``wgmma_split``), and K2's gx digest with the
# exact checks K5 = K2 and K8b = K2; then K8a, both forms, on phase 9's x
STEM_AB_CHILD = r"""
import hashlib, json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
C.import_port("ops._cuda").build_all()
M = C.import_port("models")
darknet = C.import_port("models.darknet")
SF = C.import_port("ops.stem_fused")
SB = C.import_port("experimental.stem_batched")
PC = C.import_port("ops.planar_conv")
net = M.build_network(M.yolov3_blocks(width=C.SIZE, height=C.SIZE))
dev, bf16 = torch.device("cuda"), torch.bfloat16
model = darknet.Darknet(net, M.init_params(net, C.SEED), bf16, device=dev)
sp, sbp = model.stem_params(), model.stem_bwd_params()
b, h1, h5 = C.TRAIN_BATCH, C.SIZE // 2, C.SIZE // 4
gen = torch.Generator(device=dev).manual_seed(C.SEED + 6)
x = torch.rand(b, C.SIZE, C.SIZE, 3, generator=gen, device=dev).to(bf16)
g5 = torch.randn(b, h5, h5, 128, generator=gen, device=dev).to(bf16)
xe, xo = SF.split_phases(x)
g5p = PC.to_planar(g5)
acts = SF.fused_stem_fwd(xe, xo, sp, save_acts=True)
k2 = SF.fused_stem_bwd_saved(acts, g5p, sbp)
k5 = SF.fused_stem_bwd(xe, xo, acts[0], g5p, sp, sbp)
seg = SB._seg(h1)
bacts = SB.fused_stem_fwd_b(*SB.split_phases_b(x, seg), sp, b,
                            save_acts=True)
y5n = SB.batched_to_nhwc(bacts[0], b, h5, 128, lane0=1, stride=2)
gp5dd = SB.nhwc_to_batched(SB.interleave_zero_rows(SB.interleave_zero_cols(
    (g5.float() * torch.where(y5n > 0, 1.0, 0.1)).to(bf16))), seg)
k8b = SB.fused_stem_bwd_b(gp5dd, bacts, sbp, b)
torch.cuda.synchronize()
bits = torch.cat([t.reshape(-1) for t in k2]).view(torch.int16)
rec = {"k2_gx_sha256": hashlib.sha256(bits.cpu().numpy().tobytes()
                                      ).hexdigest(),
       "k5_equals_k2": all(torch.equal(p, q) for p, q in zip(k5, k2)),
       "k8b_equals_k2": torch.equal(SB.merge_phases_b(*k8b, b, h1, 3),
                                    SF.merge_phases(*k2, h1, 3)),
       "k5_ms": C.time_ms(lambda: SF.fused_stem_bwd(xe, xo, acts[0], g5p,
                                                    sp, sbp), 5),
       "k8b_ms": C.time_ms(lambda: SB.fused_stem_bwd_b(gp5dd, bacts, sbp,
                                                       b), 3, 2),
       "k2_ms": C.time_ms(lambda: SF.fused_stem_bwd_saved(acts, g5p, sbp),
                          5)}
del k2, k5, k8b, acts, bacts, gp5dd
torch.cuda.empty_cache()
rec["dev_ms"] = C.wgmma_device_times(dev, sp, sbp, C.TRAIN_BATCH)
rec["split"] = C.wgmma_split(dev, sp, sbp, rec["dev_ms"])
# K8a, both forms, as phase 9 times them (over 3 calls), device ms, and a
# digest of each of its six outputs; its split where the tree keeps one
gen = torch.Generator(device=dev).manual_seed(C.SEED + 21)
x = torch.rand(b, C.SIZE, C.SIZE, 3, generator=gen, device=dev).to(bf16)
xe, xo = SB.split_phases_b(x, seg)
k8a = {"fused_stem_fwd_b": lambda: SB.fused_stem_fwd_b(xe, xo, sp, b),
       "fused_stem_fwd_b_save_acts": lambda: SB.fused_stem_fwd_b(
           xe, xo, sp, b, save_acts=True)}
outs = k8a["fused_stem_fwd_b_save_acts"]()
rec["k8a_y5_equal"] = torch.equal(k8a["fused_stem_fwd_b"](), outs[0])
rec["k8a_digest"] = {n: C.digest([t]) for n, t in
                     zip(("y5", "y0e", "y0o", "y1", "y2", "y3"), outs)}
del outs
rec["k8a_ms"] = {n: C.time_ms(fn, 3, 2) for n, fn in k8a.items()}
rec["k8a_dev_ms"] = {n: C.device_ms(fn) for n, fn in k8a.items()}
del k8a, x, xe, xo
torch.cuda.empty_cache()
if hasattr(C, "k8a_split"):
    rec["k8a_split"] = C.k8a_split(dev, sp, rec["k8a_dev_ms"])
print("STEMAB " + json.dumps(rec))
"""


# One tree's K6 readings for ``k6_ab``, from that tree's own chip_smoke.py
# and kernels (what a parent commit already has): the four K6 rows' times
# and output digests (``k6_readings``), their cycle split (``k6_split``)
# and the c12 and fused-stage b24 steps (``k6_route_steps``)
K6_AB_CHILD = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as C
C.import_port("ops._cuda").build_all()
M = C.import_port("models")
darknet = C.import_port("models.darknet")
net = M.build_network(M.yolov3_blocks(width=C.SIZE, height=C.SIZE))
dev = torch.device("cuda")
model = darknet.Darknet(net, M.init_params(net, C.SEED), torch.bfloat16,
                        device=dev)
rec = C.k6_readings(dev, model)
rec["split"] = C.k6_split(dev, model, rec["dev_ms"])
del model
torch.cuda.empty_cache()
rec["steps"] = C.k6_route_steps(dev)
print("K6AB " + json.dumps(rec))
"""


def k6_ab(parent: str) -> int:
    """``python3 chip_smoke.py --k6-ab DIR``: the K6 kernels in the
    checkout at DIR (a parent commit) and in this one, on one card in one
    call, in turns (``ab_turns``): the four rows' CUDA-event and device
    times and cycle splits, the c12 and fused-stage b24 steps, and a
    digest of each output. Prints a ``[k6-ab]`` line a turn, whether each
    output's digest agrees across the trees, and one JSON record last."""
    card = card_line()
    runs = ab_turns(parent, K6_AB_CHILD, "K6AB")
    for rec in runs:
        log(f"[k6-ab] {rec['tree']}: " + "; ".join(
            f"{n} {rec['ms'][n]:.4f} ms (dev {rec['dev_ms'][n]:.4f})"
            for n in K6_ROWS) + "; steps " + ", ".join(
            f"{r} {v['ms']:.2f} ms {v['launches']}"
            for r, v in rec["steps"].items()) + f" ({card})")
        for name, r in rec["split"].items():
            log(f"[k6-ab] {rec['tree']} {name} b24 split: " + json.dumps(
                {k: round(v, 4) for k, v in r["share"].items()}))
    agree = {n: len({rec["digest"][n] for rec in runs}) == 1
             for n in K6_ROWS}
    log(f"[k6-ab] outputs bit for bit the parent's: {json.dumps(agree)}")
    log(json.dumps({"k6_ab": runs, "digests_agree": agree, "card": card}))
    return 0


def stem_ab(parent: str) -> int:
    """``python3 chip_smoke.py --stem-ab DIR``: the stem kernels K5, K8b,
    K2 and K8a (both forms) in the checkout at DIR (a parent commit) and in
    this one, on one card in one call, in turns (``ab_turns``): phase 5's
    K5 reading, phase 9's K8b and K8a readings and K2's time, the device
    times and cycle splits of each tree's wgmma stem kernels and of K8a
    (where the tree keeps its cycle accounts), K2's gx digest and a digest
    of each of K8a's six outputs (this tree's must equal the parent's),
    and the exact checks K5 = K2, K8b = K2 and K8a's y5 alike in both
    forms. Prints a ``[stem-ab]`` line a turn and one JSON record last."""
    card = card_line()
    runs = ab_turns(parent, STEM_AB_CHILD, "STEMAB")
    for rec in runs:
        log(f"[stem-ab] {rec['tree']}: K5 {rec['k5_ms']:.4f} ms, K8b "
            f"{rec['k8b_ms']:.4f}, K2 {rec['k2_ms']:.4f}; dev "
            f"{json.dumps(rec['dev_ms'])}; K5 = K2 {rec['k5_equals_k2']}, "
            f"K8b = K2 {rec['k8b_equals_k2']} ({card})")
        log(f"[stem-ab] {rec['tree']}: " + "; ".join(
            f"{n} {rec['k8a_ms'][n]:.4f} ms (dev {rec['k8a_dev_ms'][n]:.4f})"
            for n in K8A_ROWS) + f" ({card})")
        for name, r in {**rec["split"], **rec.get("k8a_split", {})}.items():
            log(f"[stem-ab] {rec['tree']} {name} b24 split: " + json.dumps(
                {k: round(v, 4) for k, v in r["share"].items()}))
    digests = {rec["k2_gx_sha256"] for rec in runs}
    log(f"[stem-ab] K2's gx digests agree across the trees: "
        f"{len(digests) == 1}")
    k8a_agree = {n: len({rec["k8a_digest"][n] for rec in runs}) == 1
                 for n in K8A_OUTPUTS}
    log(f"[stem-ab] K8a's outputs bit for bit the parent's: "
        f"{json.dumps(k8a_agree)}")
    assert len(digests) == 1, "K2's gx moved"
    assert all(k8a_agree.values()), ("K8a's outputs moved", k8a_agree)
    assert all(rec["k5_equals_k2"] and rec["k8b_equals_k2"]
               and rec["k8a_y5_equal"] for rec in runs)
    log(json.dumps({"stem_ab": runs, "card": card}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--warp"]:
        sys.exit(warp_only())
    if sys.argv[1:2] == ["--k4-ab"]:
        sys.exit(k4_ab(os.path.abspath(sys.argv[2])))
    if sys.argv[1:2] == ["--stem-ab"]:
        sys.exit(stem_ab(os.path.abspath(sys.argv[2])))
    if sys.argv[1:2] == ["--k6-ab"]:
        sys.exit(k6_ab(os.path.abspath(sys.argv[2])))
    sys.exit(main())
