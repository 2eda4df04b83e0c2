"""ctypes bindings for the repository's native host routines
(``native/host_ops.cpp``): pairwise xywh IoU, greedy NMS, the eval-time
occupancy map and whitespace-float parsing.

These are host loops of the eval path, not device kernels. The library
is built at first use with

    g++ -O3 -march=native -fPIC -shared -std=c++17 -o build/libhost_ops_<hash>.so native/host_ops.cpp

into the package's gitignored ``build/`` directory (beside the CUDA
kernels' libraries); the name carries a hash of the source, the flags
and the host CPU's model, so an edited source is rebuilt and a library
built for another CPU is never loaded. Nothing is
written into ``native/``. Every entry point returns None when the library
is unavailable (no compiler, a failed build, or ``APFP_NATIVE=0``), and
its callers then run their numpy twins; ``available()`` says which one
runs, and ``BUILD_ERROR`` holds why a build failed. Nothing here runs at
import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "host_ops.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
BUILD_ERROR: Optional[str] = None


def _cpu_model() -> str:
    """The host CPU's model name: ``-march=native`` code built on one CPU
    may not run on another, so a copied build directory must not be
    reused there."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line
    except OSError:
        pass
    return platform.machine()


def library_path() -> str:
    """Where the library for the current source, flags and host CPU
    lives."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f"libhost_ops_{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it at first use; None if unavailable
    (then ``BUILD_ERROR`` says why, unless ``APFP_NATIVE=0`` asked for
    the numpy twins)."""
    global _lib, _tried, BUILD_ERROR
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("APFP_NATIVE", "1") == "0":
            return None
        try:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except subprocess.CalledProcessError as e:
            BUILD_ERROR = f"g++ failed (rc {e.returncode}): {e.stderr}"
            return None
        except (OSError, subprocess.SubprocessError) as e:
            BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.iou_xywh_matrix.restype = None
        lib.iou_xywh_matrix.argtypes = [f32p, ctypes.c_int64, f32p,
                                        ctypes.c_int64, f32p]
        lib.greedy_nms.restype = ctypes.c_int64
        lib.greedy_nms.argtypes = [f32p, f32p, ctypes.c_int64,
                                   ctypes.c_float, i64p]
        lib.interference_map.restype = None
        lib.interference_map.argtypes = [f32p, ctypes.c_int64,
                                         ctypes.c_float, ctypes.c_int64,
                                         f32p]
        lib.parse_floats.restype = ctypes.c_int64
        lib.parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_int64, f32p,
                                     ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native routines run, False when the numpy twins do."""
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _boxes(a: np.ndarray, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float32)
    if a.ndim != 2 or a.shape[1] != 4:
        raise ValueError(f"{name}: expected [N, 4] boxes, got {a.shape}")
    return a


def iou_xywh_matrix(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Pairwise IoU [N, M] of center-format boxes a [N, 4], b [M, 4]."""
    lib = get_lib()
    if lib is None:
        return None
    a, b = _boxes(a, "a"), _boxes(b, "b")
    out = np.empty((len(a), len(b)), np.float32)
    lib.iou_xywh_matrix(_fptr(a), len(a), _fptr(b), len(b), _fptr(out))
    return out


def greedy_nms(boxes: np.ndarray, scores: np.ndarray,
               iou_thresh: float) -> Optional[np.ndarray]:
    """Kept indices, descending score (ties: lower index first)."""
    lib = get_lib()
    if lib is None:
        return None
    boxes = _boxes(boxes, "boxes")
    scores = np.ascontiguousarray(scores, np.float32)
    if scores.shape != (len(boxes),):
        raise ValueError(f"scores {scores.shape} for {len(boxes)} boxes")
    keep = np.empty(len(scores), np.int64)
    n = lib.greedy_nms(_fptr(boxes), _fptr(scores), len(scores),
                       ctypes.c_float(iou_thresh),
                       keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:n].copy()


def interference_map(labels: np.ndarray, semi_edge: float,
                     img_size: int) -> Optional[np.ndarray]:
    """The eval placement's occupancy map [S, S] from [L, 7] labels."""
    lib = get_lib()
    if lib is None:
        return None
    labels = np.ascontiguousarray(labels, np.float32)
    if labels.ndim != 2 or labels.shape[1] != 7:
        raise ValueError(f"expected [L, 7] labels, got {labels.shape}")
    out = np.empty(img_size * img_size, np.float32)
    lib.interference_map(_fptr(labels), len(labels),
                         ctypes.c_float(semi_edge), img_size, _fptr(out))
    return out.reshape(img_size, img_size)


def parse_floats(text: bytes, max_out: int) -> Optional[np.ndarray]:
    """Up to ``max_out`` whitespace-separated floats of ``text``."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(max_out, np.float32)
    n = lib.parse_floats(text, len(text), _fptr(out), max_out)
    return out[:n].copy()
