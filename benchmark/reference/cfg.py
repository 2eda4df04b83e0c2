"""A darknet ``.cfg`` read into the reference's block dicts, with its
own parser (plain Python: neither the program's nor darknet's code).

``parse(text)`` gives the ``[net]`` block's input size and the layer
blocks after it, each a dict the forward (``darknet.forward``) walks:

- ``conv``: ``filters``, ``size``, ``stride``, ``pad`` (pixels a side:
  ``size // 2`` under ``pad=1``, else 0, darknet's rule), ``bn`` and
  ``act`` (``leaky``, ``mish`` or ``linear``);
- ``shortcut``: ``from`` (relative or absolute) and ``act``;
- ``route``: ``layers``, any number of them, relative or absolute;
- ``maxpool``: ``size``, ``stride`` and ``padding`` (the total over a
  side pair: darknet's ``size - 1``);
- ``upsample``: ``stride``;
- ``yolo``: ``scale`` (its place among the heads) and ``classes``.

Every key of a layer section is either one the forward implements or
one that does not touch the forward's mathematics (a ``[yolo]`` layer's
keys all act on decode or on the detector's own training). Any other
key, activation or section raises, naming it: none is ever ignored.
``[net]`` keys other than the input size are the detector's training
schedule and augmentation, which the forward does not read.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

ACTIVATIONS = ("leaky", "mish", "linear")
# per layer section, the keys the forward implements
KEYS = {
    "convolutional": ("filters", "size", "stride", "pad", "batch_normalize",
                      "activation"),
    "shortcut": ("from", "activation"),
    "route": ("layers",),
    "maxpool": ("size", "stride"),
    "upsample": ("stride",),
}


def sections(text: str) -> List[Tuple[str, Dict[str, str]]]:
    """(section name, raw key/value strings) of each ``[section]`` in
    order; ``#`` and ``;`` lines are comments."""
    out: List[Tuple[str, Dict[str, str]]] = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line[0] in "#;":
            continue
        if line.startswith("["):
            out.append((line[1:line.index("]")].strip(), {}))
        elif "=" in line and out:
            key, _, value = line.partition("=")
            out[-1][1][key.strip()] = value.strip()
        else:
            raise ValueError(f"cfg line {n}: {raw!r} is neither a section "
                             "nor key=value")
    return out


def _ints(value: str) -> List[int]:
    return [int(v) for v in value.replace(",", " ").split()]


def _check_keys(i: int, kind: str, opts: Dict[str, str]) -> None:
    for key, value in opts.items():
        if key not in KEYS[kind]:
            raise ValueError(f"layer {i} [{kind}]: key {key}={value} is not "
                             "implemented by the reference's forward")


def _activation(i: int, kind: str, opts: Dict[str, str],
                default: str) -> str:
    act = opts.get("activation", default)
    if act not in ACTIVATIONS:
        raise ValueError(f"layer {i} [{kind}]: activation {act!r} is not "
                         "implemented by the reference's forward")
    return act


def _layer(i: int, kind: str, opts: Dict[str, str], heads: int) -> dict:
    if kind == "yolo":
        return {"type": "yolo", "scale": heads,
                "classes": int(opts.get("classes", 20))}
    if kind not in KEYS:
        raise ValueError(f"layer {i}: section [{kind}] is not implemented "
                         "by the reference's forward")
    _check_keys(i, kind, opts)
    if kind == "convolutional":
        size = int(opts.get("size", 1))
        return {"type": "conv", "filters": int(opts.get("filters", 1)),
                "size": size, "stride": int(opts.get("stride", 1)),
                "pad": size // 2 if int(opts.get("pad", 0)) else 0,
                "bn": bool(int(opts.get("batch_normalize", 0))),
                # darknet's default activation, which the forward lacks
                "act": _activation(i, kind, opts, "logistic")}
    if kind == "shortcut":
        src = _ints(opts["from"])
        if len(src) != 1:
            raise ValueError(f"layer {i} [shortcut]: from={opts['from']}: "
                             "one source only")
        return {"type": "shortcut", "from": src[0],
                "act": _activation(i, kind, opts, "linear")}
    if kind == "route":
        return {"type": "route", "layers": _ints(opts["layers"])}
    if kind == "maxpool":
        stride = int(opts.get("stride", 1))
        size = int(opts.get("size", stride))
        return {"type": "maxpool", "size": size, "stride": stride,
                "padding": size - 1}
    return {"type": "upsample", "stride": int(opts.get("stride", 2))}


def parse(text: str) -> Tuple[dict, List[dict]]:
    """(``{"width", "height", "channels"}`` of ``[net]``, the layer
    blocks) of darknet cfg text."""
    secs = sections(text)
    if not secs or secs[0][0] != "net":
        raise ValueError("the cfg's first section must be [net]")
    net = secs[0][1]
    info = {k: int(net.get(k, d)) for k, d in
            (("width", 0), ("height", 0), ("channels", 3))}
    blocks: List[dict] = []
    for i, (kind, opts) in enumerate(secs[1:]):
        heads = sum(b["type"] == "yolo" for b in blocks)
        blocks.append(_layer(i, kind, opts, heads))
    return info, blocks


def check(config: dict, info: dict, blocks: List[dict]) -> None:
    """Raise, naming it, where the cfg disagrees with its configuration
    file: the input size, a head's classes, or a head conv's filters."""
    bad = []
    if (info["width"], info["height"]) != (config["img_size"],) * 2:
        bad.append(f"[net] width x height {info['width']} x "
                   f"{info['height']} against img_size {config['img_size']}")
    for i, blk in enumerate(blocks):
        if blk["type"] != "yolo":
            continue
        if blk["classes"] != config["num_classes"]:
            bad.append(f"layer {i} [yolo] classes {blk['classes']} against "
                       f"num_classes {config['num_classes']}")
        head = blocks[i - 1] if i else {}
        if head.get("type") != "conv":
            bad.append(f"layer {i} [yolo] follows no convolution")
        elif head["filters"] != config["head_filters"]:
            bad.append(f"layer {i - 1} head conv filters {head['filters']} "
                       f"against head_filters {config['head_filters']}")
    if bad:
        raise ValueError(f"{config.get('cfgfile')} against "
                         f"{config.get('name')}: " + "; ".join(bad))
