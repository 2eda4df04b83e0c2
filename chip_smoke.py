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

The last two lines are the kernels JSON object and
``{"ok": true, "device": {...}}``; the card's name and power limit are
printed before them. Exits non-zero, printing no result, without a card
or without the port beside this script.
"""

import io
import json
import os
import subprocess
import sys
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
    b_ms, b_by = bound(nbytes(xe, xo, y5k), stem_flops(BATCH, SIZE),
                       torch.bfloat16)
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
    b_ms, b_by = bound(nbytes(xe32, xo32, y5k), stem_flops(BATCH, SIZE),
                       torch.float32)
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
    counters = {"to_planar": PC.to_planar, "fused_stem_fwd":
                SF.fused_stem_fwd, "from_planar": PC.from_planar}
    for fn in counters.values():
        fn.launches = 0
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
    launches = {k: fn.launches for k, fn in counters.items()}
    log(f"[serve] 16 service answers (rows {[len(a) for a in answers]}), "
        f"HTTP counts {http_counts}, batches {svc.stats.batches}, "
        f"saturated {svc.stats.saturated}; launches {launches}")
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched on the main path"
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

    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
