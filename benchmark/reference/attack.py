"""Plain float32 patch-training step: EOT composite, victim, creation
losses, input gradient and the amsgrad update with its clip.

Each piece follows the published attack (the ``creation_colorful``
recipe of ``paper_obj``): a 7x7 lower-median smoothing of the patch,
per-sample contrast, brightness and uniform noise, a rotation, a zoom set
by the scene's labels and a random centre, the two-pass (x then y)
bilinear warp onto the canvas, the composite where the warped patch is
not zero; then the objectness and class scores of the patch's cell
(whose x and y are swapped, as the attack's own code has it), the
non-printability score, total variation, colourfulness; and
``Adam(amsgrad=True)`` at the step's rate, then a clip to [0, 1].

``replay_draws`` repeats the draw arithmetic of one EOT batch from a
``torch.Generator`` in the order the program consumes it, so that a
generator seeded alike gives the same numbers.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import darknet

COLORS_FILE = os.path.join(os.path.dirname(__file__),
                           "printable_colors_30.txt")
BETAS = (0.9, 0.999)
EPS = 1e-8


def printable_colors(device) -> torch.Tensor:
    return torch.tensor(np.loadtxt(COLORS_FILE, delimiter=","),
                        dtype=torch.float32, device=device)


def replay_draws(gen: torch.Generator, batch: int, patch: int) -> dict:
    """One EOT batch's draws: contrast U(0.8, 1.2), brightness U(-0.1,
    0.1), noise U(-1, 1) [B, P, P, 3], centre U(0, 1) twice, angle
    U(-pi, pi), in that order, each ``lo + (hi - lo) * u``."""
    dev = gen.device

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    return {"contrast": uniform((batch,), 0.8, 1.2),
            "brightness": uniform((batch,), -0.1, 0.1),
            "noise": uniform((batch, patch, patch, 3), -1.0, 1.0),
            "ux": uniform((batch,), 0.0, 1.0),
            "uy": uniform((batch,), 0.0, 1.0),
            "angle": uniform((batch,), -math.pi, math.pi)}


def rows(draws: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in draws.items()}


def median7(patch: torch.Tensor) -> torch.Tensor:
    """Lower median of the 7x7 windows of [P, P, 3], reflect-padded by 3
    on each side; the sort is stable, so its gradient goes to the tied
    element in window order."""
    x = patch.permute(2, 0, 1)[None]
    xp = F.pad(x, (3, 3, 3, 3), mode="reflect")[0]
    p = patch.shape[0]
    wins = torch.stack([xp[:, i:i + p, j:j + p]
                        for i in range(7) for j in range(7)], dim=0)
    med = torch.sort(wins, dim=0, stable=True).values[24]
    return med.permute(1, 2, 0)


def _hat(t):
    return torch.clamp(1.0 - torch.abs(t), min=0.0)


def warp(img: torch.Tensor, angle, scale, tx, ty, size: int,
         quant: Optional[str] = None):
    """The two-pass bilinear warp of per-sample patches [B, P, P, C] onto
    a [size, size] canvas (``quant`` rounds its operands and passes),
    centred at (tx, ty) of the canvas, rotated by ``angle`` and zoomed by
    ``scale``: (out, mask) with the mask the warped ones channel. The inverse affine in pixels is factored as a
    shear along x then one along y; where |d| < |b| the source is
    transposed first."""
    b, p, _, c = img.shape
    sin, cos = torch.sin(angle), torch.cos(angle)
    inv = 1.0 / scale
    ntx, nty = (0.5 - tx) * 2.0, (0.5 - ty) * 2.0
    t00, t01, t02 = cos * inv, sin * inv, (ntx * cos + nty * sin) * inv
    t10, t11, t12 = -sin * inv, cos * inv, (-ntx * sin + nty * cos) * inv
    pad = (size - p) // 2
    a11, a12 = t00, t01
    a21, a22 = t10, t11
    xn0 = 1.0 / size - 1.0
    xs0 = t00 * xn0 + t01 * xn0 + t02
    ys0 = t10 * xn0 + t11 * xn0 + t12
    b1 = ((xs0 + 1.0) * size - 1.0) * 0.5 - pad
    b2 = ((ys0 + 1.0) * size - 1.0) * 0.5 - pad
    swap = torch.abs(a12) > torch.abs(a22)

    def sel(u, v):
        return torch.where(swap, v, u)

    A11, A12, B1 = sel(a11, a21), sel(a12, a22), sel(b1, b2)
    A21, A22, B2 = sel(a21, a11), sel(a22, a12), sel(b2, b1)
    src = torch.where(swap[:, None, None, None], img.transpose(1, 2), img)
    x4 = torch.cat([src, torch.ones_like(src[..., :1])], dim=-1)
    safe = torch.where(torch.abs(A22) < 1e-12, torch.full_like(A22, 1e-12),
                       A22)
    det = A11 * A22 - A12 * A21
    pp, qq = det / safe, A12 / safe
    u1 = B1 - qq * B2
    dev = img.device
    xs = torch.arange(p, dtype=torch.float32, device=dev)
    out_ax = torch.arange(size, dtype=torch.float32, device=dev)
    m1 = _hat((pp[:, None, None] * out_ax[None, None, :]
               + qq[:, None, None] * xs[None, :, None]
               + u1[:, None, None])[..., None] - xs)     # [B, y, X, x]
    m2 = _hat((A21[:, None, None] * out_ax[None, :, None]
               + A22[:, None, None] * out_ax[None, None, :]
               + B2[:, None, None])[..., None] - xs)    # [B, X, Y, y]
    x4, m1, m2 = (darknet.round_to(t, quant) for t in (x4, m1, m2))
    mid = darknet.round_to(torch.einsum("byXx,byxc->byXc", m1, x4), quant)
    out = darknet.round_to(torch.einsum("bXYy,byXc->bYXc", m2, mid), quant)
    return out[..., :c], out[..., c:]


def composite(patch, images, labels, draws, size: int,
              quant: Optional[str] = None):
    """The EOT: (patched images [B, S, S, 3], patch centres [B, 2])."""
    p = patch.shape[0]
    smooth = median7(patch)
    batch = torch.clamp(smooth[None] * draws["contrast"][:, None, None, None]
                        + draws["brightness"][:, None, None, None]
                        + 0.1 * draws["noise"], 0.0, 1.0)
    area = labels[..., 3] * labels[..., 4]
    bi = torch.arange(labels.shape[0], device=labels.device)
    ref = (labels[bi, torch.argmax(area, dim=1)]
           + labels[bi, torch.argmin(area, dim=1)]) / 2.0
    ref = torch.where((torch.amax(area, dim=1) > 0.99)[:, None],
                      torch.full_like(ref, 0.25), ref)
    half = size / 2.0
    scale = torch.sqrt((ref[:, 2] * half) ** 2 + (ref[:, 3] * half) ** 2) / p
    tx = torch.clamp(draws["ux"], min=0.2)
    ty = torch.clamp(draws["uy"], max=0.8)
    batch = darknet.round_to(batch, quant)
    warped, mask = warp(batch, draws["angle"], scale, tx, ty, size, quant)
    adv = darknet.round_to(torch.clamp(warped, 0.0, 1.0) * mask, quant)
    patched = torch.where(adv == 0.0, darknet.round_to(images, quant), adv)
    return patched, torch.stack([tx, ty], dim=1) * size


def cell_scores(heads: List[torch.Tensor], centers, size: int,
                num_classes: int):
    """Sigmoided objectness [B, 9] and class scores [B, 9, C] of the
    patch's cell on each head, the cell's x and y swapped."""
    b = centers.shape[0]
    bi = torch.arange(b, device=centers.device)
    objs, clss = [], []
    for head in heads:
        stride = size // head.shape[1]
        cell = torch.div(centers.to(torch.int32), stride,
                         rounding_mode="floor").long()
        v = torch.sigmoid(head[bi, cell[:, 0], cell[:, 1]].reshape(
            b, 3, 5 + num_classes)[..., 4:])
        objs.append(v[..., 0])
        clss.append(v[..., 1:])
    return torch.cat(objs, dim=1), torch.cat(clss, dim=1)


def patch_terms(patch, colors, nps_factor, tv_factor, tv_floor):
    """(nps, tv, tv floored, colourfulness) of the patch [P, P, 3]."""
    diff = patch[None] - colors[:, None, None, :] + 0.000001
    nps = torch.sum(torch.amin(torch.sqrt(torch.sum(diff * diff, dim=-1)
                                          + 0.000001), dim=0)) / patch.numel()
    dx = torch.abs(patch[:, 1:] - patch[:, :-1] + 0.000001)
    dy = torch.abs(patch[1:] - patch[:-1] + 0.000001)
    tv = (torch.sum(dx) + torch.sum(dy)) / patch.numel() * tv_factor
    r, g, b = patch[..., 0], patch[..., 1], patch[..., 2]
    rg, yb = r - g, 0.5 * (r + g) - b
    colorful = (torch.sqrt(torch.var(rg, correction=1)
                           + torch.var(yb, correction=1))
                + 0.3 * torch.sqrt(torch.mean(rg) ** 2 + torch.mean(yb) ** 2))
    nps = nps * nps_factor
    return nps, tv, torch.clamp(tv, min=tv_floor), colorful


def loss_and_grad(patch: torch.Tensor, images_u8: torch.Tensor,
                  labels: torch.Tensor, weights_row: torch.Tensor,
                  draws: dict, blocks, weights, exp: dict,
                  quant: Optional[str] = None, block_rows: int = 4,
                  inner: Optional[dict] = None):
    """(total loss, d loss / d patch) of one step, the batch in blocks of
    ``block_rows`` rows: the batch terms are weighted sums over rows, so
    each block's share is differentiated on its own and added. With
    ``inner`` (a dict) it also fills in the step's inner tensors, each
    over the whole batch: ``composite`` (the patched images), ``heads``,
    ``head_grads`` (d loss / d heads) and ``input_grad`` (d loss / d the
    patched images)."""
    size, nc, target = exp["img_size"], exp["num_classes"], exp["target_id"]
    colors = printable_colors(patch.device)
    wsum = torch.clamp(torch.sum(weights_row), min=1.0)
    p = patch.detach().clone().requires_grad_(True)
    nps, _, tv_f, colorful = patch_terms(p, colors, exp["nps_factor"],
                                         exp["tv_factor"], exp["tv_floor"])
    total = nps + tv_f + colorful + 4.0
    total.backward()
    grad = p.grad.clone()
    total = total.detach()
    blocks_seen = []
    for lo in range(0, images_u8.shape[0], block_rows):
        sl = slice(lo, lo + block_rows)
        q = patch.detach().clone().requires_grad_(True)
        images = images_u8[sl].float() / 255.0
        patched, centers = composite(q, images, labels[sl], rows(draws, sl),
                                     size, quant)
        heads = darknet.forward(blocks, weights, patched, quant)
        if inner is not None:
            for t in [patched] + heads:
                t.retain_grad()
        obj, cls = cell_scores(heads, centers, size, nc)
        w = weights_row[sl]
        part = (-4.0 * torch.sum(torch.amax(obj, dim=1) * w)
                - torch.sum(torch.mean(torch.log_softmax(cls, dim=-1)
                                       [..., target], dim=1) * w)) / wsum
        part.backward()
        grad += q.grad
        total = total + part.detach()
        if inner is not None:
            blocks_seen.append((patched.detach(), patched.grad,
                                [h.detach() for h in heads],
                                [h.grad for h in heads]))
    if inner is not None:
        inner["composite"] = torch.cat([b[0] for b in blocks_seen])
        inner["input_grad"] = torch.cat([b[1] for b in blocks_seen])
        inner["heads"] = [torch.cat([b[2][i] for b in blocks_seen])
                          for i in range(len(blocks_seen[0][2]))]
        inner["head_grads"] = [torch.cat([b[3][i] for b in blocks_seen])
                               for i in range(len(blocks_seen[0][3]))]
    return total, grad


class AmsGrad:
    """``torch.optim.Adam(amsgrad=True)`` on one tensor, then the clip."""

    def __init__(self, patch: torch.Tensor):
        self.m = torch.zeros_like(patch)
        self.v = torch.zeros_like(patch)
        self.vmax = torch.zeros_like(patch)
        self.t = 0

    def step(self, patch: torch.Tensor, grad: torch.Tensor,
             lr: float) -> torch.Tensor:
        b1, b2 = BETAS
        self.t += 1
        self.m = b1 * self.m + (1 - b1) * grad
        self.v = b2 * self.v + (1 - b2) * grad * grad
        self.vmax = torch.maximum(self.vmax, self.v)
        denom = torch.sqrt(self.vmax) / math.sqrt(1 - b2 ** self.t) + EPS
        new = patch - lr / (1 - b1 ** self.t) * self.m / denom
        return torch.clamp(new, 0.0, 1.0)


def three_steps(patch0, batches, gen_state, blocks, weights, exp: dict,
                lr: float, quant: Optional[str] = None) -> Dict[str, object]:
    """The first steps of training from ``patch0``: each of ``batches``
    (uint8 images, labels, plan weights) with its replayed draws. Returns
    the losses, the first gradient, the first step's inner tensors
    (``loss_and_grad``) and the patch after the last step."""
    gen = torch.Generator(device=patch0.device)
    gen.set_state(gen_state)
    opt = AmsGrad(patch0)
    patch = patch0.detach().clone()
    losses, first_grad, first = [], None, {}
    for images, labels, wrow in batches:
        draws = replay_draws(gen, images.shape[0], patch.shape[0])
        loss, grad = loss_and_grad(patch, images, labels, wrow, draws,
                                   blocks, weights, exp, quant,
                                   inner=first if first_grad is None
                                   else None)
        if first_grad is None:
            first_grad = grad
        losses.append(float(loss))
        patch = opt.step(patch, grad, lr)
    return {"losses": losses, "grad": first_grad, "first": first,
            "patch": patch}
