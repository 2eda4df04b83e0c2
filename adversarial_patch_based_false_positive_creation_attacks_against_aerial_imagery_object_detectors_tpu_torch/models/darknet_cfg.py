"""Darknet ``.cfg`` network-description handling.

Parses the INI-style darknet format into a list of block dicts (the same
semantics the reference consumes via its parser, ``cfg.py:37-56`` in the
reference repo: ``[section]`` headers open a new block, ``key=value`` lines
populate it, ``#`` lines are comments, and convolutional blocks default
``batch_normalize`` to 0), plus a writer and a programmatic generator for
the YOLOv3-DOTA victim architecture so no external ``.cfg`` file is needed.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List, Union

Block = Dict[str, str]


def parse_darknet_cfg(source: Union[str, os.PathLike, io.TextIOBase]) -> List[Block]:
    """Parse darknet cfg text (path, raw string, or file object) into blocks.

    Each block is a dict with a ``"type"`` key naming the section plus the
    raw string key/value pairs of the section body. Convolutional blocks get
    ``batch_normalize = "0"`` by default (darknet semantics: a conv without
    an explicit batch_normalize line has a bias and no BN).
    """
    if isinstance(source, io.TextIOBase):
        text = source.read()
    elif isinstance(source, str) and "\n" in source:
        text = source
    else:
        with open(source, "r") as f:
            text = f.read()

    blocks: List[Block] = []
    for raw in text.split("\n"):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            block: Block = {"type": line[1 : line.index("]")].strip()}
            if block["type"] == "convolutional":
                block["batch_normalize"] = "0"
            blocks.append(block)
        else:
            key, _, value = line.partition("=")
            # Strip trailing inline content after the value (darknet files
            # occasionally carry trailing comments/whitespace).
            blocks[-1][key.strip()] = value.strip()
    return blocks


def write_darknet_cfg(blocks: List[Block], path: Union[str, os.PathLike]) -> None:
    """Serialize blocks back to darknet cfg text (round-trips with the parser)."""
    lines = []
    for block in blocks:
        lines.append(f"[{block['type']}]")
        for key, value in block.items():
            if key != "type":
                lines.append(f"{key}={value}")
        lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines))


# ---------------------------------------------------------------------------
# Programmatic YOLOv3 generator
# ---------------------------------------------------------------------------

# The nine DOTA anchors, small to large, as listed in the cfg `anchors=` line
# (reference cfg/yolov3-dota.cfg:610). NOTE: this is the *cfg* ordering; the
# anchors *file* used at decode time lists the groups large->small and the
# reference reverses the group order on load -- see data/assets and
# ops/decode.py for that (deliberately replicated) quirk.
DOTA_ANCHORS = "15, 31,  19, 12,  28, 40,  40, 20,  43, 38,  42, 87,  78, 54,  95, 102,  181, 206"
DOTA_NUM_CLASSES = 15


def _conv(filters: int, size: int, stride: int = 1, activation: str = "leaky",
          bn: bool = True) -> Block:
    block = {
        "type": "convolutional",
        "batch_normalize": "1" if bn else "0",
        "filters": str(filters),
        "size": str(size),
        "stride": str(stride),
        "pad": "1",
        "activation": activation,
    }
    return block


def _residual(blocks: List[Block], filters: int) -> None:
    """One darknet53 residual unit: 1x1 bottleneck, 3x3 expand, shortcut -3."""
    blocks.append(_conv(filters // 2, 1))
    blocks.append(_conv(filters, 3))
    blocks.append({"type": "shortcut", "from": "-3", "activation": "linear"})


def yolov3_blocks(num_classes: int = DOTA_NUM_CLASSES,
                  anchors: str = DOTA_ANCHORS,
                  width: int = 608, height: int = 608,
                  width_mult: float = 1.0) -> List[Block]:
    """Generate the YOLOv3 block list (darknet53 backbone + 3-scale head).

    Structurally identical to the reference's cfg/yolov3-dota.cfg (75 conv,
    23 shortcut, 4 route, 2 upsample, 3 yolo; classes=15 -> head filters=60),
    expressed in code rather than as a data file.

    ``width_mult`` scales every channel count EXCEPT the final per-scale
    60-filter detection convs (params scale ~width_mult^2; 0.25 -> ~3.9M).
    The layer graph — depth, routes, strides, heads — is unchanged, which
    is what makes the slim variant a committable full-DEPTH parity fixture
    (tests/fixtures/refparity_slim) standing in for the 247MB full one.
    """
    head_filters = 3 * (5 + num_classes)

    def w(f: int) -> int:
        if width_mult == 1.0:
            return f
        return max(8, int(round(f * width_mult / 8)) * 8)
    b: List[Block] = [{
        "type": "net",
        "batch": "1", "subdivisions": "1",
        "width": str(width), "height": str(height), "channels": "3",
        "momentum": "0.9", "decay": "0.0005",
        "learning_rate": "0.0005", "burn_in": "1000",
        "max_batches": "500200", "policy": "steps",
        "steps": "300000,400000", "scales": ".1,.1",
    }]
    # darknet53 backbone
    b.append(_conv(w(32), 3))
    for filters, n_res in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        b.append(_conv(w(filters), 3, stride=2))  # downsample
        for _ in range(n_res):
            _residual(b, w(filters))

    def _yolo(mask: str) -> Block:
        return {
            "type": "yolo", "mask": mask, "anchors": anchors,
            "classes": str(num_classes), "num": "9", "jitter": ".3",
            "ignore_thresh": ".7", "truth_thresh": "1", "random": "1",
        }

    # scale 1 head (stride 32)
    for filters, size in ((512, 1), (1024, 3), (512, 1), (1024, 3), (512, 1)):
        b.append(_conv(w(filters), size))
    b.append(_conv(w(1024), 3))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append(_yolo("6,7,8"))
    # scale 2 head (stride 16)
    b.append({"type": "route", "layers": "-4"})
    b.append(_conv(w(256), 1))
    b.append({"type": "upsample", "stride": "2"})
    b.append({"type": "route", "layers": "-1, 61"})
    for filters, size in ((256, 1), (512, 3), (256, 1), (512, 3), (256, 1)):
        b.append(_conv(w(filters), size))
    b.append(_conv(w(512), 3))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append(_yolo("3,4,5"))
    # scale 3 head (stride 8)
    b.append({"type": "route", "layers": "-4"})
    b.append(_conv(w(128), 1))
    b.append({"type": "upsample", "stride": "2"})
    b.append({"type": "route", "layers": "-1, 36"})
    for filters, size in ((128, 1), (256, 3), (128, 1), (256, 3), (128, 1)):
        b.append(_conv(w(filters), size))
    b.append(_conv(w(256), 3))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append(_yolo("0,1,2"))
    return b


def tiny_test_blocks(num_classes: int = DOTA_NUM_CLASSES,
                     width: int = 64, height: int = 64) -> List[Block]:
    """A miniature 3-scale network exercising every block type (conv+BN,
    conv-linear, shortcut, route, upsample, maxpool, yolo) for fast tests
    and the multi-chip dry run."""
    head_filters = 3 * (5 + num_classes)
    anchors = DOTA_ANCHORS
    b: List[Block] = [{
        "type": "net", "batch": "1", "subdivisions": "1",
        "width": str(width), "height": str(height), "channels": "3",
    }]
    b.append(_conv(8, 3))
    b.append(_conv(16, 3, stride=2))      # /2
    b.append(_conv(8, 1))
    b.append(_conv(16, 3))
    b.append({"type": "shortcut", "from": "-3", "activation": "linear"})
    b.append(_conv(32, 3, stride=2))      # /4
    b.append({"type": "maxpool", "size": "2", "stride": "2"})  # /8
    b.append(_conv(32, 3))
    b.append(_conv(64, 3, stride=2))      # /16
    b.append(_conv(64, 3, stride=2))      # /32  (idx 10)
    # scale 1
    b.append(_conv(32, 1))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append({"type": "yolo", "mask": "6,7,8", "anchors": anchors,
              "classes": str(num_classes)})
    b.append({"type": "route", "layers": "-3"})
    b.append(_conv(16, 1))
    b.append({"type": "upsample", "stride": "2"})
    b.append({"type": "route", "layers": "-1, 8"})
    b.append(_conv(32, 3))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append({"type": "yolo", "mask": "3,4,5", "anchors": anchors,
              "classes": str(num_classes)})
    b.append({"type": "route", "layers": "-3"})
    b.append(_conv(16, 1))
    b.append({"type": "upsample", "stride": "2"})
    b.append({"type": "route", "layers": "-1, 7"})
    b.append(_conv(32, 3))
    b.append(_conv(head_filters, 1, activation="linear", bn=False))
    b.append({"type": "yolo", "mask": "0,1,2", "anchors": anchors,
              "classes": str(num_classes)})
    return b
