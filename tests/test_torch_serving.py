"""The port's micro-batching detection service and HTTP endpoint, in the
scenarios of tests/test_serving.py, with the port's tiny detector on the
CPU: requests coalesce into one fixed-size device batch and each caller
gets exactly its own image's detections back."""

import io
import json
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch import evals
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.evals.serving import (
    DetectionService)
from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.models import (
    build_network, init_params, tiny_test_blocks)


def _rows(detector, batch):
    dets, valid, _ = detector.detect_batch_device(batch, 0.05, 0.4)
    return dets.numpy()[0][valid.numpy()[0]]


@pytest.fixture(scope="module")
def tiny_detector():
    net = build_network(tiny_test_blocks())
    return evals.Detector(net, init_params(net, 5), img_size=64,
                          compute_dtype=torch.float32, max_candidates=256,
                          device="cpu")


def test_submit_matches_direct_detection(tiny_detector):
    """A served request returns exactly detect_batch_device's valid rows
    for that image, regardless of batch padding."""
    rng = np.random.default_rng(0)
    img = rng.random((64, 64, 3), dtype=np.float32)
    with DetectionService(tiny_detector, max_batch=4, window_ms=1.0,
                          conf_thresh=0.05, nms_thresh=0.4) as svc:
        got = svc.submit(img)
    want = _rows(tiny_detector, np.stack(
        [img] + [np.zeros((64, 64, 3), np.float32)] * 3))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.shape[1] == 7 and len(got) > 0


def test_concurrent_requests_batch_and_route(tiny_detector):
    """8 concurrent submits over max_batch=4: every caller gets its own
    image's rows (inputs differ, so per-image results must differ from a
    swapped assignment) and the batcher coalesces (< 8 batches)."""
    rng = np.random.default_rng(1)
    imgs = [rng.random((64, 64, 3), dtype=np.float32) for _ in range(8)]
    svc = DetectionService(tiny_detector, max_batch=4, window_ms=50.0,
                          conf_thresh=0.05, nms_thresh=0.4)
    with svc:
        with ThreadPoolExecutor(8) as pool:
            results = list(pool.map(svc.submit, imgs))
    assert svc.stats.requests == 8
    assert svc.stats.batches < 8  # coalesced
    # oracle per image
    for img, got in zip(imgs, results):
        want = _rows(tiny_detector, np.stack(
            [img] + [np.zeros((64, 64, 3), np.float32)] * 3))
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_uint8_wire_matches_quantized_float(tiny_detector):
    """uint8 wire dtype: a uint8 submit returns exactly what the device
    program produces for that uint8 batch, and a float submit matches
    its 1/255-quantized uint8 image (the documented wire quantization)."""
    rng = np.random.default_rng(3)
    img_u8 = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    img_f = img_u8.astype(np.float32) / 255.0
    with DetectionService(tiny_detector, max_batch=4, window_ms=1.0,
                          conf_thresh=0.05, nms_thresh=0.4,
                          wire_dtype=np.uint8) as svc:
        got_u8 = svc.submit(img_u8)
        got_f = svc.submit(img_f)
    want = _rows(tiny_detector, np.stack(
        [img_u8] + [np.zeros((64, 64, 3), np.uint8)] * 3))
    np.testing.assert_allclose(got_u8, want, rtol=1e-6)
    # float input quantizes onto the same uint8 wire -> identical rows
    np.testing.assert_allclose(got_f, want, rtol=1e-6)


def test_wire_dtype_validation(tiny_detector):
    with pytest.raises(ValueError):
        DetectionService(tiny_detector, wire_dtype=np.float16)


def test_submit_validates_shape_and_lifecycle(tiny_detector):
    svc = DetectionService(tiny_detector, max_batch=2)
    with pytest.raises(RuntimeError):
        svc.submit(np.zeros((64, 64, 3), np.float32))  # not started
    with svc:
        with pytest.raises(ValueError):
            svc.submit(np.zeros((32, 32, 3), np.float32))  # wrong size
    with pytest.raises(RuntimeError):
        svc.submit(np.zeros((64, 64, 3), np.float32))  # stopped


def test_stats_are_bounded_running_counters(tiny_detector):
    """A long-lived service keeps O(1) stats state (no per-batch list);
    mean batch size comes from the running counters."""
    rng = np.random.default_rng(7)
    svc = DetectionService(tiny_detector, max_batch=4, window_ms=1.0,
                           conf_thresh=0.05, nms_thresh=0.4)
    with svc:
        for _ in range(3):
            svc.submit(rng.random((64, 64, 3), dtype=np.float32))
    assert svc.stats.requests == 3
    assert svc.stats.mean_batch == svc.stats.requests / svc.stats.batches
    assert not hasattr(svc.stats, "batch_sizes")


def test_submit_stop_race_never_leaves_unresolved_future(tiny_detector):
    """Hammer submit() from many threads while stop() runs: every submit
    either returns rows or raises, within a bounded wait — no Future may
    be left unresolved (the pre-lock race could enqueue after stop's
    drain and block its caller forever)."""
    rng = np.random.default_rng(11)
    img = rng.random((64, 64, 3), dtype=np.float32)
    outcomes = []

    def hammer(svc):
        try:
            outcomes.append(("ok", svc.submit(img, timeout=30.0)))
        except RuntimeError as e:
            outcomes.append(("refused", str(e)))

    for trial in range(5):
        svc = DetectionService(tiny_detector, max_batch=4, window_ms=0.5,
                               conf_thresh=0.05, nms_thresh=0.4)
        svc.start(warmup=(trial == 0))
        threads = [threading.Thread(target=hammer, args=(svc,))
                   for _ in range(8)]
        for t in threads:
            t.start()
        svc.stop()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive(), "submit blocked across stop()"
    assert len(outcomes) == 5 * 8  # every caller got an answer


def test_http_endpoint_end_to_end(tiny_detector):
    """Real HTTP server on a random port with the tiny model: /healthz,
    /detect with PNG bytes, /stats."""
    from http.server import ThreadingHTTPServer
    from PIL import Image

    from adversarial_patch_based_false_positive_creation_attacks_against_aerial_imagery_object_detectors_tpu_torch.cli.serve import make_handler

    svc = DetectionService(tiny_detector, max_batch=2, window_ms=1.0,
                          conf_thresh=0.05, nms_thresh=0.4)
    with svc:
        server = ThreadingHTTPServer(
            ("127.0.0.1", 0),
            make_handler(svc, [f"c{i}" for i in range(15)], 64))
        port = server.server_address[1]
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/healthz") as r:
                h = json.loads(r.read())
            assert h["ok"] and h["img_size"] == 64

            rng = np.random.default_rng(2)
            img = Image.fromarray(
                (rng.random((100, 80, 3)) * 255).astype(np.uint8))
            buf = io.BytesIO()
            img.save(buf, format="PNG")
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/detect", data=buf.getvalue())
            with urllib.request.urlopen(req) as r:
                out = json.loads(r.read())
            assert out["count"] == len(out["detections"])
            assert all(len(row) == 7 for row in out["detections"])
            assert len(out["names"]) == out["count"]

            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/stats") as r:
                st = json.loads(r.read())
            assert st["requests"] >= 1
        finally:
            server.shutdown()
