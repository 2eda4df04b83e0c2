"""Build and load the hand-written Hopper kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process
(all started together) into a shared library with a plain C interface
under the package's ``build/`` directory (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>_<hash>.so csrc/<name>.cu

The library name carries a hash of the sources, so an edited source is
rebuilt and a stale library is never loaded. Each library is loaded with
``ctypes``; every pointer and the stream are passed as ``c_void_p``.
Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``. Every kernel wrapper calls its entry point
through ``launch``, which makes the tensors' device the current CUDA
device for the call (the kernel then runs in that device's context, on
that device's current stream) and raises when the error is not 0.
Nothing here runs at import: the CPU tests import every module of the
package.
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
        # x, out0, out1, dtype, B, H, W, C, cp, wl0, wl1, w_out0, w_out1,
        # stream
        "apfp_to_planar_phases": [_P] * 3 + [_I] * 10 + [_P],
        # the same arguments as apfp_to_planar
        "apfp_to_planar_tiled": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P],
        # xp, out, dtype, B, H, cp, wl, w_img, c, stream
        "apfp_from_planar": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # the same arguments
        "apfp_from_planar_narrow": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # which (narrow / tiled to_planar, narrow / tiled from_planar),
        # dtype, info[3] (registers, static shared bytes, blocks/SM)
        "apfp_planar_info": [_I, _I, _P],
    },
    "stem_fused": {
        # xe, xo, w0, w1, w2, w3, w5, b0, b1, b2, b3, b5, f0, f1, f2, f3,
        # f5 (bfloat16 weights packed for wgmma, or null), y5, m0e, m0o,
        # m1, m2, m3 (save_acts masks or null), dtype, B, H, wlh, wl5, stream
        "apfp_fused_stem_fwd": [_P] * 23 + [_I] * 5 + [_P],
        # dtype, save, info[3] (registers, dynamic shared bytes, blocks/SM)
        "apfp_fused_stem_fwd_info": [_I, _I, _P],
        # a, b in fragment order, b packed, d_mma, d_wgmma, K, stream
        "apfp_wgmma_bitcheck": [_P] * 5 + [_I, _P],
    },
    "stem_bwd": {
        # m0e, m0o, m1, m2, m3, y5, g5, v0, v1, v2, v3, v5, u0, u1, u2, u3,
        # u5 (bfloat16 weights packed for wgmma, or null), gxe, gxo, dtype,
        # B, H, wlh, wl5, stream
        "apfp_fused_stem_bwd": [_P] * 19 + [_I] * 5 + [_P],
        # dtype, info[3]
        "apfp_fused_stem_bwd_info": [_I, _P],
    },
    "stem_remat": {
        # xe, xo, w0, w1, w2, w3, b0, b1, b2, b3, y5, g5, v0, v1, v2, v3,
        # v5, f0, f1, f2, f3, u0, u1, u2, u3, u5 (bfloat16 weights packed
        # for wgmma, K1's and K2's, or null), gxe, gxo, dtype, B, H, wlh,
        # wl5, stream
        "apfp_fused_stem_remat": [_P] * 28 + [_I] * 5 + [_P],
        # dtype, info[3]
        "apfp_fused_stem_remat_info": [_I, _P],
    },
    "planar_conv": {
        # x, w, bias, res, gate, out, dtype, B, H, cin, wl_in, w_img, cout,
        # cout_pad, K, k, stride, has_slope, slope, gate_slope, stream
        "apfp_planar_conv": [_P] * 6 + [_I] * 12 + [_F, _F, _P],
        # g, w, bias, gate, out, dtype, B, Hg, cin, wl_in, w_g, cout,
        # cout_pad, K, gate_slope, stream
        "apfp_planar_conv_t2": [_P] * 5 + [_I] * 9 + [_F, _P],
        # variant (1x1, 3x3 s1, 3x3 s2, adjoint), 16-deep steps a chunk,
        # channels a block, info[3]
        "apfp_planar_conv_info": [_I, _I, _I, _P],
    },
    "res_fused": {
        # x, w6, w7, w9, w10, b6, b7, b9, b10, f6, f7, f9, f10 (bfloat16
        # weights packed for wgmma or null), y11, am, p7m, cm, p10m (masks
        # null without save), dtype, B, H, W, wl, stream
        "apfp_res152_fused": [_P] * 18 + [_I] * 5 + [_P],
        # dtype, save, info[3]
        "apfp_res152_fused_info": [_I, _I, _P],
        # g11, am, p7m, cm, p10m, w6t, w7t, w9t, w10t, f6t, f7t, f9t, f10t
        # (packed for wgmma or null), g5, dtype, B, H, W, wl, stream
        "apfp_res152_fused_grad": [_P] * 14 + [_I] * 5 + [_P],
        # gp12, am, p7m, cm, p10m, w12t, w6t, w7t, w9t, w10t, f12t, f6t,
        # f7t, f9t, f10t (packed for wgmma or null), g5, dtype, B, H, W, wl,
        # wl12, stream
        "apfp_res152_fused_grad12": [_P] * 16 + [_I] * 6 + [_P],
        # dtype, w12, info[3]
        "apfp_res152_fused_grad_info": [_I, _I, _P],
    },
    "median_pool": {
        # x, out, dtype, C, H, W, k, pt, pl, stream
        "apfp_median_pool": [_P, _P] + [_I] * 7 + [_P],
        # k, dtype, info[3] (registers, shared bytes, blocks/SM)
        "apfp_median_pool_info": [_I, _I, _P],
    },
    "stem_batched": {
        # xe, xo, w0, w1, w2, w3, w5, b0, b1, b2, b3, b5, f0, f1, f2, f3,
        # f5 (bfloat16 packed weights or null), y5, a0e, a0o, a1,
        # a2, a3 (save_acts outputs or null), dtype, B, H, seg, stream
        "apfp_fused_stem_fwd_b": [_P] * 23 + [_I] * 4 + [_P],
        # dtype, save, info[3]
        "apfp_fused_stem_fwd_b_info": [_I, _I, _P],
        # gp5dd, y0e, y0o, y1, y2, y3, v0, v1, v2, v3, v5, u0, u1, u2, u3,
        # u5 (bfloat16 weights packed for wgmma, K2's, or null), gxe, gxo,
        # dtype, B, H, seg, stream
        "apfp_fused_stem_bwd_b": [_P] * 18 + [_I] * 4 + [_P],
        # dtype, info[3]
        "apfp_fused_stem_bwd_b_info": [_I, _P],
    },
    "affine_warp": {
        # src, coef [B, 7], out, dtype, B, n, oh, ow, stream
        "apfp_affine_warp_fwd": [_P] * 3 + [_I] * 5 + [_P],
        # g, coef, gsrc, and the rest as the forward's
        "apfp_affine_warp_bwd": [_P] * 3 + [_I] * 5 + [_P],
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
    ``-Xptxas -v`` register, shared-memory and spill lines, kept beside
    the library as ``<lib>.so.log`` so that a cached build reports them
    too)."""
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
            try:
                with open(path + ".log") as f:
                    log = f.read()
            except OSError:
                log = "(cached)"
            BUILD_INFO[name] = {"seconds": 0.0, "log": log, "path": path}
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
        with open(path + ".log", "w") as f:
            f.write(log)
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


# the wgmma kernels' cycle categories (csrc/stem_common.cuh: wg::Prof), in
# order
PROF_CATEGORIES = ("load", "input_wait", "weight_wait", "mma", "epilogue",
                   "masks", "store", "sync")


@contextlib.contextmanager
def profiled(*names: str):
    """While the block runs, the libraries ``names`` are copies built with
    ``-DAPFP_PROFILE`` (``build/lib<name>_prof_<hash>.so``): their wgmma
    kernels keep cycle accounts by category (``prof_take``). The normal
    libraries come back afterwards."""
    digest = _sources_hash()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock:
        paths, procs = {}, {}
        for name in names:
            path = os.path.join(BUILD_DIR, f"lib{name}_prof_{digest}.so")
            paths[name] = path
            if not os.path.exists(path):
                tmp = f"{path}.{os.getpid()}.tmp"
                procs[name] = (subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-DAPFP_PROFILE", "-o", tmp,
                     os.path.join(SRC_DIR, f"{name}.cu")],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp)
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({name}, profiled):\n{log}")
            os.replace(tmp, paths[name])
        saved = {name: _libs.get(name) for name in names}
        for name, path in paths.items():
            so = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                getattr(so, fn).argtypes = argtypes
                getattr(so, fn).restype = ctypes.c_int
            so.apfp_prof_take.argtypes = [_P]
            so.apfp_prof_take.restype = ctypes.c_int
            _libs[name] = so
    try:
        yield
    finally:
        with _lock:
            for name, so in saved.items():
                if so is None:
                    _libs.pop(name, None)
                else:
                    _libs[name] = so


def prof_take(name: str) -> dict:
    """The cycle accounts of profiled library ``name`` since the last take
    ({category: cycles}, summed over the blocks' thread 0), then zeroed."""
    buf = (ctypes.c_ulonglong * len(PROF_CATEGORIES))()
    check(_libs[name].apfp_prof_take(buf), f"{name} prof_take")
    return dict(zip(PROF_CATEGORIES, (int(v) for v in buf)))


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def launch(what: str, name: str, entry: str, t: torch.Tensor, *args) -> None:
    """Call C entry point ``entry`` of kernel library ``name`` with
    ``args`` and the current stream of ``t``'s device, under that device
    as the current CUDA device: ``cudaFuncSetAttribute`` and the launch
    act on the context of the card the tensors live on, not on the
    process's current one. Raises (naming ``what``) when the entry point
    returns an error. The one place the port calls a kernel library."""
    fn = getattr(lib(name), entry)
    with torch.cuda.device(t.device):
        check(fn(*args, stream_ptr(t)), what)


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
