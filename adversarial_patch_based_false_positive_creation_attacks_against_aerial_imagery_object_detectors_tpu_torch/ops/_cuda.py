"""Build and load the hand-written Hopper kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface
under the package's ``build/`` directory (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>_<hash>.so csrc/<name>.cu

The library name carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded. Each library is loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``.
Each C entry point launches on the stream it is given (the caller passes
``torch.cuda.current_stream()``) and returns ``cudaGetLastError()``;
``check`` raises when that is not 0. Nothing here runs at import: the
CPU tests import every module of the package.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures, by library: every pointer and the stream are c_void_p
SIGNATURES = {
    "planar": {
        # x, out, dtype, B, H, W, C, cp, wl, step, offset, w_out, stream
        "apfp_to_planar": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
        # the same arguments
        "apfp_to_planar_tiled": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
        # xp, out, dtype, B, H, cp, wl, w_img, c, stream
        "apfp_from_planar": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "stem_fused": {
        # xe, xo, w0, w1, w2, w3, w5, b0, b1, b2, b3, b5, y5,
        # m0e, m0o, m1, m2, m3 (save_acts masks or null), dtype,
        # B, H, wlh, wl5, stream
        "apfp_fused_stem_fwd": [_P] * 18 + [_I] * 5 + [_P],
    },
    "stem_bwd": {
        # m0e, m0o, m1, m2, m3, y5, g5, v0, v1, v2, v3, v5, gxe, gxo,
        # dtype, B, H, wlh, wl5, stream
        "apfp_fused_stem_bwd": [_P] * 14 + [_I] * 5 + [_P],
    },
    "planar_conv": {
        # x, w, bias, res, gate, out, dtype, B, H, cin, wl_in, w_img, cout,
        # cout_pad, k, stride, has_slope, slope, gate_slope, stream
        "apfp_planar_conv": [_P] * 6 + [_I] * 11 + [_F, _F, _P],
    },
    "res_fused": {
        # x, w6, w7, w9, w10, b6, b7, b9, b10, y11, am, p7m, cm, p10m
        # (masks null without save), dtype, B, H, W, wl, stream
        "apfp_res152_fused": [_P] * 14 + [_I] * 5 + [_P],
        # g11, am, p7m, cm, p10m, w6t, w7t, w9t, w10t, g5, dtype, B, H, W,
        # wl, stream
        "apfp_res152_fused_grad": [_P] * 10 + [_I] * 5 + [_P],
    },
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
BUILD_INFO: Dict[str, dict] = {}


def resolve_device(device) -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument; raises
    when it names CUDA and no card is visible (never falls back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain versions")
    return dev


_tf32_lock = threading.Lock()
_tf32_users = 0
_tf32_saved = True


@contextlib.contextmanager
def no_tf32():
    """float32 convolutions in full float32: cuDNN runs them in TF32 by
    default, which keeps ~3 decimal digits and drifts past the 1e-3
    golden tolerance over 75 chained convs. (Matmuls already default to
    "highest".) The flag is process-wide, so nested and concurrent users
    (a service worker and the main thread) share one count and the
    caller's setting comes back only when the last one leaves."""
    global _tf32_users, _tf32_saved
    with _tf32_lock:
        if _tf32_users == 0:
            _tf32_saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _tf32_users += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_users -= 1
            if _tf32_users == 0:
                torch.backends.cudnn.allow_tf32 = _tf32_saved


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (needed to build the CUDA kernels)")


def _sources_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(SRC_DIR, "*.cu"))
                       + glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, dict]:
    """Compile every library whose ``.so`` for the current source hash is
    missing, one ``nvcc`` per source, all in parallel. Returns
    ``{name: {"seconds", "log", "path"}}`` (``log`` holds the
    ``-Xptxas -v`` register, shared-memory and spill lines)."""
    with _lock:
        return _build_locked()


def _build_locked() -> Dict[str, dict]:
    digest = _sources_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in SIGNATURES:
        path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
        if name in BUILD_INFO and BUILD_INFO[name]["path"] == path:
            continue
        if os.path.exists(path):
            BUILD_INFO[name] = {"seconds": 0.0, "log": "(cached)",
                                "path": path}
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                            "log": log, "path": path}
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return BUILD_INFO


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building it at first use)."""
    with _lock:
        if name in _libs:
            return _libs[name]
        info = _build_locked()[name]
        so = ctypes.CDLL(info["path"])
        for fn, argtypes in SIGNATURES[name].items():
            getattr(so, fn).argtypes = argtypes
            getattr(so, fn).restype = ctypes.c_int
        _libs[name] = so
        return so


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's input check: contiguous tensors of one CUDA
    device in a dtype the kernel takes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if tensors[0].dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} not supported "
                        f"(float32 or bfloat16)")


def require_cuda_int8(name: str, device: torch.device,
                      *tensors: torch.Tensor) -> None:
    """A kernel wrapper's check of its int8 inputs (sign masks):
    contiguous, int8, on ``device``."""
    for t in tensors:
        if (t.device != device or t.dtype != torch.int8
                or not t.is_contiguous()):
            raise ValueError(f"{name}: masks must be contiguous int8 on "
                             f"{device}, got {t.dtype} on {t.device}")
