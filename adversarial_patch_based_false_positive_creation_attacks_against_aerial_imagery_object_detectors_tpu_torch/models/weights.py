"""Darknet binary weight I/O, and conversion of JAX parameter trees.

The darknet ``.weights`` format (the reference's
``darknet_v3.py:223-309``): a 5-int32 header (major, minor, revision,
seen, pad) followed by a flat float32 stream. Per convolutional layer, in
block order:

- with batch-norm:   bn_bias(beta), bn_weight(gamma), running_mean,
  running_var, then conv kernel in OIHW order;
- without batch-norm: conv bias, then conv kernel (OIHW).

PyTorch's kernels are OIHW too, so the kernel is kept as the file stores
it and a save -> load round trip is bit-exact.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .darknet import Network, Params, conv_specs


def load_darknet_weights(net: Network, path: str | os.PathLike,
                         dtype=torch.float32) -> Tuple[Params, np.ndarray]:
    """Read a darknet ``.weights`` file into a params tree (CPU tensors).

    Returns ``(params, header)``; ``header`` is the 5-int32 file header.
    """
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=np.int32, count=5)
        buf = np.fromfile(f, dtype=np.float32)

    ptr = 0

    def take(n: int) -> np.ndarray:
        nonlocal ptr
        out = buf[ptr:ptr + n]
        if out.size != n:
            raise ValueError(
                f"weight file truncated: needed {n} floats at offset {ptr}, "
                f"file has {buf.size}")
        ptr += n
        return out

    def tensor(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.copy()).to(dtype)

    params: Params = {}
    for spec in conv_specs(net):
        p: Dict[str, torch.Tensor] = {}
        if spec.bn:
            p["beta"] = tensor(take(spec.filters))
            p["gamma"] = tensor(take(spec.filters))
            p["mean"] = tensor(take(spec.filters))
            p["var"] = tensor(take(spec.filters))
        else:
            p["b"] = tensor(take(spec.filters))
        n_w = spec.filters * spec.in_ch * spec.size * spec.size
        p["w"] = tensor(take(n_w).reshape(
            spec.filters, spec.in_ch, spec.size, spec.size))
        params[f"conv_{spec.index}"] = p

    if ptr != buf.size:
        raise ValueError(
            f"weight file has {buf.size - ptr} unread floats "
            "(architecture mismatch?)")
    return params, header


def save_darknet_weights(net: Network, params: Params,
                         path: str | os.PathLike,
                         header: np.ndarray | None = None) -> None:
    """Write params to the darknet binary format (inverse of the loader)."""
    if header is None:
        header = np.array([0, 2, 0, 0, 0], dtype=np.int32)
    chunks = [np.asarray(header, dtype=np.int32).tobytes()]

    def f32(t) -> np.ndarray:
        return np.ascontiguousarray(
            torch.as_tensor(t).detach().cpu().to(torch.float32).numpy())

    for spec in conv_specs(net):
        p = params[f"conv_{spec.index}"]
        if spec.bn:
            for k in ("beta", "gamma", "mean", "var"):
                chunks.append(f32(p[k]).tobytes())
        else:
            chunks.append(f32(p["b"]).tobytes())
        chunks.append(f32(p["w"]).tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


def params_from_jax(params: Mapping[str, Mapping[str, np.ndarray]]
                    ) -> Params:
    """A JAX package params tree (arrays convertible with ``np.asarray``;
    kernels HWIO) -> this package's tree (float32 CPU tensors; kernels
    OIHW). ``b`` or ``gamma/beta/mean/var`` are carried across as they
    are."""
    out: Params = {}
    for name, p in params.items():
        q: Dict[str, torch.Tensor] = {}
        for k, v in p.items():
            a = np.array(v, np.float32)  # a copy the tensor owns
            if k == "w":
                a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))  # OIHW
            q[k] = torch.from_numpy(a)
        out[name] = q
    return out
