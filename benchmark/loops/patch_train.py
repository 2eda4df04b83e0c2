"""Patch training on a device store: the program's epoch program
(``train/trainer.py: make_epoch_scan_fn``'s ``epoch_fn``, what
``PatchTrainer.train_store`` and ``cli/train_patch.py --device-store``
run), fed a plan of ``steps_per_call`` batches a call.

Set-up builds one trainer state (victim, patch, amsgrad state, EOT
generator, store) from the seed and drives it through its first three
steps, one call each, keeping each step's loss, the first gradient (from
the optimizer's first moment), the first step's inner tensors (a hook on
the program's victim module: the EOT composite it is handed, its three
heads, and the gradients the backward sends into both) and the patch
after the third; then one call of ``steps_per_call`` steps warms the
window's shape. The window keeps one call in flight: it issues a call,
then waits for the one before to end, reading the host clock there. The
reference then repeats the three steps in float32 from the same patch,
batches and draws.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs, port
from benchmark.core import Env, WindowResult, derive, log
from benchmark.reference import attack as ref_attack
from benchmark.weights import victim

CHECK_STEPS = 3


def _exp_dict(exp) -> dict:
    return {"img_size": exp.img_size, "num_classes": exp.num_classes,
            "target_id": exp.target_id, "nps_factor": exp.nps_factor,
            "tv_factor": exp.tv_factor, "tv_floor": exp.tv_floor}


def setup(env: Env) -> dict:
    cfg, tr, dev = env.config, env.traffic, env.device
    marks = [time.perf_counter()]
    T = port.mod("train")
    exp = T.get_experiment(tr["experiment"], batch_size=tr["batch"],
                           img_size=cfg["img_size"],
                           num_classes=cfg["num_classes"],
                           target_id=cfg["target_id"],
                           patch_size=cfg["patch_size"],
                           max_labels=tr["max_labels"])
    if exp.loss_recipe != "creation_colorful":
        raise ValueError("the reference follows the creation_colorful recipe")
    blocks, weights = victim(cfg, env.seed, dev)
    net = port.network(cfg)
    model = port.mod("models.darknet").Darknet(
        net, port.params(weights), T.compute_dtype(exp), device=dev).eval()
    epoch_fn = T.make_epoch_scan_fn(model, exp)
    marks.append(time.perf_counter())
    n = tr["store_tiles"]
    images = inputs.smooth_tiles(n, exp.img_size, derive(env.seed, 2), dev)
    counts = inputs.label_counts(n, exp.max_labels, tr["label_tail"],
                                 derive(env.seed, 3))
    labels = torch.from_numpy(inputs.labels(
        counts, exp.max_labels, exp.num_classes, derive(env.seed, 4))).to(dev)
    pgen = torch.Generator(device=dev)
    pgen.manual_seed(derive(env.seed, 5))
    patch0 = torch.rand((exp.patch_size, exp.patch_size, 3), generator=pgen,
                        device=dev)
    patch = patch0.clone().requires_grad_(True)
    optimizer = T.make_optimizer(patch, exp.learning_rate)
    gen = torch.Generator(device=dev)
    gen.manual_seed(derive(env.seed, 6))
    gen_state = gen.get_state()
    plan = inputs.PlanStream(n, exp.batch_size, derive(env.seed, 7))
    lr = exp.learning_rate
    _sync(dev)
    marks.append(time.perf_counter())
    st = dict(exp=exp, blocks=blocks, weights=weights, model=model,
              epoch_fn=_faulty(epoch_fn, env.faults, patch), images=images,
              labels=labels, patch=patch, patch0=patch0,
              optimizer=optimizer, gen=gen, gen_state=gen_state, plan=plan,
              lr=lr, dev=dev)

    # the first steps, one call each, through the window's own call
    losses, batches = [], []
    for k in range(CHECK_STEPS):
        idx, w = plan.take(1)
        ib = torch.from_numpy(idx).to(dev)
        rows = ib[0].long()
        batches.append((images[rows].clone(), labels[rows].clone(),
                        torch.from_numpy(w[0]).to(dev)))
        inner = _Inner(model) if k == 0 else None
        means = st["epoch_fn"](patch, optimizer, gen, images, labels, ib,
                               torch.from_numpy(w).to(dev), lr)
        losses.append(float(means["loss"]))
        if k == 0:
            st["first"] = inner.take()
            m1 = optimizer.state[patch]["exp_avg"]
            st["grad1"] = (m1 / (1.0 - 0.9)).detach().clone()
    st["losses"] = losses
    st["patch3"] = patch.detach().clone()
    st["batches"] = batches
    marks.append(time.perf_counter())
    # one call of the window's shape
    _call(st, tr["steps_per_call"])
    _sync(dev)
    marks.append(time.perf_counter())
    log("[train] set-up s: victim %.3f, store %.3f, first steps %.3f, "
        "warm call %.3f" % tuple(b - a for a, b in zip(marks, marks[1:])))
    return st


class _Inner:
    """The inner tensors of one step of the program, read from the
    benchmark's side by a forward hook on the victim module and tensor
    hooks on what it is handed and returns: the patched images, the three
    heads, and the gradients the step's backward sends into both. Kept on
    the host, so that the window runs on the program's own memory."""

    def __init__(self, model):
        self.got = {}
        self.handle = model.register_forward_hook(self._forward)

    def _forward(self, module, args, heads):
        if self.got:
            raise RuntimeError("the victim ran twice in one checked step")
        x = args[0]
        self.got.update(composite=x.detach().cpu(),
                        heads=[h.detach().cpu() for h in heads],
                        head_grads=[None] * len(heads))
        x.register_hook(self._keep("input_grad"))
        for i, h in enumerate(heads):
            h.register_hook(self._keep("head_grads", i))

    def _keep(self, key, i=None):
        def hook(g):
            if i is None:
                self.got[key] = g.detach().cpu()
            else:
                self.got[key][i] = g.detach().cpu()
        return hook

    def take(self) -> dict:
        self.handle.remove()
        got = self.got
        if "input_grad" not in got or any(g is None
                                          for g in got["head_grads"]):
            raise RuntimeError("the checked step's backward left the "
                               "victim's heads or its input without a "
                               "gradient")
        return got


def _faulty(epoch_fn, faults, patch):
    """``epoch_fn`` with the faults a test plants under the timed path."""
    if not faults:
        return epoch_fn

    def call(p, opt, gen, images, labels, idx, w, lr):
        if "half_batch" in faults:
            w = w.clone()
            w[:, w.shape[1] // 2:] = 0.0
        before = p.detach().clone()
        out = epoch_fn(p, opt, gen, images, labels, idx, w, lr)
        if "state_unchanged" in faults:
            with torch.no_grad():
                p.copy_(before)
        return out
    return call


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _call(st, k):
    idx, w = st["plan"].take(k)
    dev = st["dev"]
    means = st["epoch_fn"](st["patch"], st["optimizer"], st["gen"],
                           st["images"], st["labels"],
                           torch.from_numpy(idx).to(dev),
                           torch.from_numpy(w).to(dev), st["lr"])
    return means, float(w.sum()), k


class _Call:
    __slots__ = ("t_issue", "t_issued", "t_end", "images", "steps",
                 "event", "loss", "traced")


def window(st: dict, env: Env, tracer) -> WindowResult:
    dev = st["dev"]
    k = env.traffic["steps_per_call"]
    trace_s = env.traffic["trace_seconds"]
    cuda = dev.type == "cuda"
    calls = []
    _sync(dev)
    t0 = time.perf_counter()
    deadline = t0 + env.seconds
    prev = None
    while True:
        if tracer is not None and tracer.prof is None:
            if time.perf_counter() >= deadline - trace_s:
                tracer.start()
        elif tracer is not None and tracer.mark is None:
            # the annotated window opens at the second traced call, with
            # the first one's work on the device
            tracer.open()
        c = _Call()
        c.traced = tracer is not None and tracer.active
        c.t_issue = time.perf_counter()
        means, c.images, c.steps = _call(st, k)
        c.t_issued = time.perf_counter()
        c.loss = means["loss"]
        if cuda:
            c.event = torch.cuda.Event()
            c.event.record()
        calls.append(c)
        if prev is not None:
            _wait(prev, cuda)
        prev = c
        if time.perf_counter() >= deadline:
            break
    _wait(prev, cuda)
    if tracer is not None and tracer.active:
        tracer.stop()
    done = [c for c in calls if c.t_end <= deadline]
    if not done:
        raise RuntimeError("no epoch call ended inside the window: "
                           "lengthen --seconds")
    rate = sum(c.images for c in done) / (max(c.t_end for c in done) - t0)
    # host counters of the untraced calls that ended in the window
    plain = [c for c in done if not c.traced]
    host = {}
    if plain:
        host["img_per_s"] = (sum(c.images for c in plain)
                             / (max(c.t_end for c in plain) - t0))
        host["issue_ms_per_step"] = 1e3 * (
            sum(c.t_issued - c.t_issue for c in plain)
            / sum(c.steps for c in plain))
    losses = torch.stack([c.loss for c in calls]).float().cpu().numpy()
    bad = int(np.sum(~np.isfinite(losses)))
    log(f"[train] {len(calls)} calls of {k} steps issued, {len(done)} ended "
        f"in the {env.seconds:.0f} s window; {rate:.3f} img/s; "
        f"{host.get('issue_ms_per_step', float('nan')):.3f} host ms issued "
        f"a step; non-finite call losses {bad}")
    return WindowResult(e2e={"train_img_per_s": rate},
                        attempted=sum(c.steps for c in calls),
                        failed=bad * k, host=host)


def _wait(c, cuda):
    if cuda:
        c.event.synchronize()
    c.t_end = time.perf_counter()


def release(st: dict) -> None:
    """Free the program's state before the reference runs."""
    for key in ("model", "epoch_fn", "images", "labels", "optimizer",
                "patch"):
        st.pop(key, None)
    if st["dev"].type == "cuda":
        torch.cuda.empty_cache()


def _gap(got, want, rows: bool = False) -> float:
    """The relative L2 gap of ``got`` from ``want``: over the whole
    tensor, or with ``rows`` the worst row's."""
    d = (got.to(want.device, torch.float32) - want).flatten(int(rows))
    w = want.flatten(int(rows))
    return float(torch.max(torch.linalg.vector_norm(d, dim=-1)
                           / torch.linalg.vector_norm(w, dim=-1)))


def _row_norm_gap(got, want) -> float:
    """The worst row's relative gap between the norms of ``got``'s and
    ``want``'s rows."""
    g = torch.linalg.vector_norm(got.to(want.device, torch.float32)
                                 .flatten(1), dim=-1)
    w = torch.linalg.vector_norm(want.flatten(1), dim=-1)
    return float(torch.max(torch.abs(g - w) / w))


def _rows(tensors):
    return torch.cat([t.flatten(1) for t in tensors], dim=1)


def _class_part(heads):
    """Of each head [B, S, S, 3 (5 + C)], the entries of the class
    logits."""
    return [h.reshape(*h.shape[:-1], 3, -1)[..., 5:] for h in heads]


def _numbers(got: dict, ref: dict, patch0) -> dict:
    """The step's numbers against the reference's. Of the first step:
    ``composite_gap``, the worst row's relative gap of the patched images
    (the EOT); ``heads_gap``, the worst row's of a head (the victim's
    forward); ``head_grad_gap``, the relative gap of d loss / d heads over
    the batch (the loss parts), and ``head_grad_row_gap``, the worst
    row's relative gap of its norm, which an ``amax`` over anchors that
    picks a near-equal other anchor leaves unmoved, and
    ``cls_grad_row_gap``, that of the class logits' entries alone (the
    class part reaches all nine anchors of a row, so a row's norm is a
    sum over many entries whose rounding errors take both signs);
    ``input_grad_gap`` and ``input_grad_row_gap``, the same of d loss / d
    the patched images (the victim's input backward); ``grad_rel_err``,
    the relative gap of the patch's gradient, and ``grad_norm_gap``, that
    of its norm. Of the three steps: ``loss_gap``, the worst step's relative loss gap;
    ``change_norm_gap``, the relative gap of the norm of the patch's
    change (amsgrad and the clip), and ``change_rel_err``, the change's
    relative gap as a vector."""
    a, b = got["first"], ref["first"]
    loss_gap = max(abs(x - y) / abs(y)
                   for x, y in zip(got["losses"], ref["losses"]))
    g_ref = float(torch.linalg.vector_norm(ref["grad"]))
    g = float(torch.linalg.vector_norm(got["grad"]))
    d_ref, d = ref["patch"] - patch0, got["patch"] - patch0
    d_ref_norm = float(torch.linalg.vector_norm(d_ref))
    return {
        "composite_gap": _gap(a["composite"], b["composite"], rows=True),
        "heads_gap": max(_gap(x, y, rows=True)
                         for x, y in zip(a["heads"], b["heads"])),
        "head_grad_gap": _gap(torch.cat([x.flatten() for x in
                                         a["head_grads"]]),
                              torch.cat([y.flatten() for y in
                                         b["head_grads"]])),
        "head_grad_row_gap": _row_norm_gap(_rows(a["head_grads"]),
                                           _rows(b["head_grads"])),
        "cls_grad_row_gap": _row_norm_gap(
            _rows(_class_part(a["head_grads"])),
            _rows(_class_part(b["head_grads"]))),
        "input_grad_gap": _gap(a["input_grad"], b["input_grad"]),
        "input_grad_row_gap": _row_norm_gap(a["input_grad"],
                                            b["input_grad"]),
        "grad_rel_err": _gap(got["grad"], ref["grad"]),
        "grad_norm_gap": abs(g - g_ref) / g_ref,
        "loss_gap": loss_gap,
        "change_norm_gap": abs(float(torch.linalg.vector_norm(d))
                               - d_ref_norm) / d_ref_norm,
        "change_rel_err": _gap(d, d_ref)}


def check(st: dict, env: Env, lower=None):
    """(numbers, and with ``lower`` ("fp8" or "bf16") those of the
    reference put in the program's place in that precision, else None).
    Only the numbers the configuration's limits name are compared."""
    release(st)
    args = (st["patch0"], st["batches"], st["gen_state"], st["blocks"],
            st["weights"], _exp_dict(st["exp"]), st["lr"])
    ref = ref_attack.three_steps(*args)
    prog = {"losses": st["losses"], "grad": st["grad1"],
            "first": st["first"], "patch": st["patch3"]}
    got = _numbers(prog, ref, st["patch0"])
    log(f"[train] losses program {st['losses']} reference {ref['losses']}")
    log(f"[train] numbers {got}")
    ctl = None
    if lower:
        low = ref_attack.three_steps(*args, quant=lower)
        ctl = _numbers(low, ref, st["patch0"])
        log(f"[train] losses {lower} {low['losses']}")
    got = {k: (v if math.isfinite(v) else float("inf"))
           for k, v in got.items()}
    return got, ctl
