"""Batched streaming detector endpoint.

Serves the detection path over HTTP with micro-batching: concurrent
requests coalesce into one fixed-size device batch (forward + decode +
threshold + greedy NMS on the card), so throughput approaches the device
batch rate instead of the one-image round-trip rate.

  POST /detect            image file bytes (PNG/JPEG)
                          -> {"detections": [[x,y,w,h,obj,cls_conf,cls_id],...],
                              "names": [...], "count": N}
  GET  /healthz           -> {"ok": true, ...}
  GET  /stats             -> batching counters

Example:
  python -m <package>.cli.serve --weightfile yolov3-dota.weights --port 8700 &
  curl -s --data-binary @tile.png http://localhost:8700/detect | jq .count
"""

import argparse
import io
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..data import pad_and_scale
from ..data.assets import load_class_names
from ..evals.serving import DetectionService
from .common import add_model_args, build_detector


def make_handler(service: DetectionService, names, img_size: int):
    from PIL import Image

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet access log
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True, "img_size": img_size,
                                 "max_batch": service.max_batch})
            elif self.path == "/stats":
                s = service.stats
                self._json(200, {
                    "requests": s.requests, "batches": s.batches,
                    "mean_batch": s.mean_batch,
                    "saturated": s.saturated})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                raw = self.rfile.read(length)
                img = Image.open(io.BytesIO(raw)).convert("RGB")
                # same square-pad + resize the offline CLIs use
                arr, _ = pad_and_scale(
                    img, np.zeros((0, 5), np.float32), img_size)
                dets, saturated = service.submit(
                    arr, return_saturated=True)
                # strict JSON: non-finite box coords (possible under an
                # untrained victim's exp overflow) become null
                self._json(200, {
                    "count": int(dets.shape[0]),
                    # True when the device NMS candidate prune
                    # overflowed: detections are a lower bound then
                    # (Detector.detect_batch_device pruning contract)
                    "saturated": saturated,
                    "detections": [
                        [float(v) if np.isfinite(v) else None
                         for v in row] for row in dets],
                    "names": [names[int(row[6])] for row in dets]})
            except Exception as e:  # noqa: BLE001 — report, don't die
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_model_args(ap)
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="fixed device batch size")
    ap.add_argument("--batch-window-ms", type=float, default=5.0,
                    help="max wait to fill a batch after the first "
                         "request arrives")
    ap.add_argument("--conf", type=float, default=0.4)
    ap.add_argument("--nms", type=float, default=0.4)
    ap.add_argument("--names-file", default=None)
    ap.add_argument("--wire-dtype", choices=["float32", "uint8"],
                    default="uint8",
                    help="host->device image dtype; uint8 ships 4x "
                         "less and normalizes on device (exact for "
                         "8-bit sources like PNG/JPEG), float32 "
                         "preserves arbitrary float preprocessing")
    args = ap.parse_args(argv)

    detector = build_detector(args)
    names = (load_class_names(args.names_file) if args.names_file
             else load_class_names())
    service = DetectionService(
        detector, max_batch=args.max_batch,
        window_ms=args.batch_window_ms, conf_thresh=args.conf,
        nms_thresh=args.nms, wire_dtype=np.dtype(args.wire_dtype))
    print(f"warming up the fixed batch-{args.max_batch} program...",
          flush=True)
    service.start()
    server = ThreadingHTTPServer(
        (args.host, args.port),
        make_handler(service, names, args.img_size))
    print(f"serving on http://{args.host}:{args.port} "
          f"(batch {args.max_batch}, window {args.batch_window_ms} ms)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.stop()


if __name__ == "__main__":
    sys.exit(main())
