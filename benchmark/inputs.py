"""The inputs a run makes from its seed: smooth tiles on the device and
YOLO label rows. Every seed gets the same set of label counts, in
another order, so the work of a run does not depend on its seed."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PAD = 1e-6          # a label row that is not there


def smooth_tiles(n: int, size: int, seed: int, device, grain: int = 8,
                 chunk: int = 64) -> torch.Tensor:
    """[n, size, size, 3] uint8: uniform noise on a grid ``grain`` pixels
    apart, bilinearly upsampled."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, device=device)
    coarse = -(-size // grain) + 1
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        base = torch.rand((m, 3, coarse, coarse), generator=gen,
                          device=device)
        up = F.interpolate(base, size=(size, size), mode="bilinear",
                           align_corners=False)
        out[lo:lo + m] = torch.round(up * 255.0).clamp(0, 255).to(
            torch.uint8).permute(0, 2, 3, 1)
    return out


def label_counts(n: int, max_rows: int, alpha: float, seed: int
                 ) -> np.ndarray:
    """``n`` counts in [1, max_rows], the quantiles (i + 0.5) / n of a
    Pareto law with tail index ``alpha`` (a few scenes hold hundreds of
    objects, most a handful), shuffled by the seed."""
    q = (np.arange(n) + 0.5) / n
    counts = np.minimum(np.floor((1.0 - q) ** (-1.0 / alpha)), max_rows)
    counts = counts.astype(np.int64)
    np.random.default_rng(seed).shuffle(counts)
    return counts


def labels(counts: np.ndarray, max_rows: int, num_classes: int,
           seed: int) -> np.ndarray:
    """[n, max_rows, 5] float32 (cls, x, y, w, h) rows, padded with
    ``PAD``."""
    rng = np.random.default_rng(seed)
    n = len(counts)
    out = np.full((n, max_rows, 5), PAD, np.float32)
    total = int(counts.sum())
    rows = np.empty((total, 5), np.float32)
    rows[:, 0] = rng.integers(0, num_classes, total)
    rows[:, 1:3] = rng.uniform(0.05, 0.95, (total, 2))
    rows[:, 3:5] = rng.uniform(0.01, 0.15, (total, 2))
    off = 0
    for i, k in enumerate(counts):
        out[i, :k] = rows[off:off + k]
        off += k
    return out


def epoch_plan(n: int, batch: int, epoch: int, seed: int):
    """(idx [K, B] int32, weights [K, B] float32) of one epoch: the tiles
    shuffled by ``(seed, epoch)``, a partial last batch padded with its
    own rows at weight 0 (the trainer's ``epoch_plan`` arithmetic)."""
    order = np.arange(n)
    np.random.default_rng((seed, epoch)).shuffle(order)
    k = -(-n // batch)
    idx = np.empty((k, batch), np.int32)
    weights = np.ones((k, batch), np.float32)
    for b in range(k):
        rows = order[b * batch:(b + 1) * batch]
        real = len(rows)
        if real < batch:
            rows = np.concatenate([rows, rows[np.arange(batch - real)
                                              % real]])
            weights[b, real:] = 0.0
        idx[b] = rows
    return idx, weights


class PlanStream:
    """Consecutive epochs' plans, handed out ``k`` rows at a time."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch, self.seed = n, batch, seed
        self.epoch = 0
        self.idx = np.empty((0, batch), np.int32)
        self.w = np.empty((0, batch), np.float32)

    def take(self, k: int):
        while len(self.idx) < k:
            i, w = epoch_plan(self.n, self.batch, self.epoch, self.seed)
            self.epoch += 1
            self.idx = np.concatenate([self.idx, i])
            self.w = np.concatenate([self.w, w])
        out = self.idx[:k], self.w[:k]
        self.idx, self.w = self.idx[k:], self.w[k:]
        return out
