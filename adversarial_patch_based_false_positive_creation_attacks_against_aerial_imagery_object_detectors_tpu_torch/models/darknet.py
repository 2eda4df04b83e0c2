"""The darknet/YOLOv3 victim detector as a PyTorch module.

- The network structure is compiled from the cfg block list once
  (``build_network``); ``Darknet`` walks it layer by layer.
- **BN folding**: the victim only ever runs in eval mode, so each
  conv+BN pair is folded into the conv kernel and bias (``fold_bn``) and
  the module holds the folded weights as buffers, in ``channels_last``.
- **Raw heads out**, in the JAX package's layout: NHWC images in, the
  three raw prediction maps ``[B, S, S, 3*(5+C)]`` float32 out in cfg
  order (stride 32, 16, 8), with no sigmoid or box decode. An NHWC
  tensor's ``permute(0, 3, 1, 2)`` already has ``channels_last``
  strides, and the heads go back with ``permute(0, 2, 3, 1)``, so the
  anchor-major channel order ``a*(5+C)+c`` is the reference's.
- Numerics match the JAX package's ``_conv_layer``: in the compute dtype
  the conv output, the bias add and the leaky are all in that dtype; the
  float32 path runs with TF32 off.
- ``fused_stem=True`` routes layers 0-5 through the fused stem kernels
  (``ops/stem_fused.py``) when ``fused_applicable`` holds; the Detector
  and the trainer ask for it on CUDA. An input that requires grad goes
  through ``FusedStem``, whose backward is the K2 kernel. Where the
  network allows the fused stem, the module also holds the stem's
  weights in both kernels' layouts, prepared once at build.
  ``last_routes()`` reports which route the last forward on this thread
  took.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _cuda, stem_fused
from .darknet_cfg import Block, parse_darknet_cfg
from .stem_planar import STEM_CONVS, _stem_params, stem_shape_ok

Params = Dict[str, Dict[str, torch.Tensor]]

BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    index: int          # module index (for params key / weight file order)
    in_ch: int
    filters: int
    size: int
    stride: int
    pad: int
    bn: bool
    activation: str     # "leaky" | "mish" | "linear"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str           # convolutional | maxpool | upsample | route | shortcut | yolo
    conv: Optional[ConvSpec] = None
    # maxpool
    pool_size: int = 0
    pool_stride: int = 0
    # upsample
    scale: int = 0
    # route: absolute module indices to concat; shortcut: absolute source index
    route_from: Tuple[int, ...] = ()
    shortcut_from: int = -1
    # yolo
    mask: Tuple[int, ...] = ()
    anchors: Tuple[Tuple[int, int], ...] = ()
    num_classes: int = 0


@dataclasses.dataclass(frozen=True)
class Network:
    """Compiled network structure: static layer specs + bookkeeping."""
    layers: Tuple[LayerSpec, ...]
    width: int
    height: int
    channels: int
    num_classes: int
    yolo_indices: Tuple[int, ...]
    # module indices whose outputs are needed later (route/shortcut sources)
    saved_outputs: Tuple[int, ...]


def build_network(blocks: Sequence[Block]) -> Network:
    """Compile a parsed block list into a static ``Network`` description."""
    net_info = blocks[0]
    if net_info["type"] != "net":
        raise ValueError("the first cfg block must be [net]")
    width = int(net_info.get("width", 608))
    height = int(net_info.get("height", 608))
    channels = int(net_info.get("channels", 3))

    layers: List[LayerSpec] = []
    out_channels: List[int] = []
    yolo_indices: List[int] = []
    needed: set = set()
    num_classes = 0

    for i, block in enumerate(blocks[1:]):
        kind = block["type"]
        if kind == "convolutional":
            bn = bool(int(block.get("batch_normalize", 0)))
            filters = int(block["filters"])
            size = int(block["size"])
            in_ch = out_channels[-1] if out_channels else channels
            spec = ConvSpec(
                index=i, in_ch=in_ch, filters=filters, size=size,
                stride=int(block["stride"]), pad=(size - 1) // 2, bn=bn,
                activation=block.get("activation", "linear"),
            )
            layers.append(LayerSpec("convolutional", conv=spec))
            out_channels.append(filters)
        elif kind == "maxpool":
            layers.append(LayerSpec(
                "maxpool", pool_size=int(block["size"]),
                pool_stride=int(block["stride"])))
            out_channels.append(out_channels[-1])
        elif kind == "upsample":
            layers.append(LayerSpec("upsample", scale=int(block["stride"])))
            out_channels.append(out_channels[-1])
        elif kind == "route":
            srcs = tuple(
                (i + int(x)) if int(x) < 0 else int(x)
                for x in block["layers"].split(","))
            needed.update(srcs)
            layers.append(LayerSpec("route", route_from=srcs))
            out_channels.append(sum(out_channels[s] for s in srcs))
        elif kind == "shortcut":
            frm = int(block["from"])
            src = i + frm if frm < 0 else frm
            needed.add(src)
            needed.add(i - 1)
            layers.append(LayerSpec("shortcut", shortcut_from=src))
            out_channels.append(out_channels[-1])
        elif kind == "yolo":
            mask = tuple(int(x) for x in block["mask"].split(","))
            flat = [int(x) for x in block["anchors"].replace(",", " ").split()]
            anchors = tuple(
                (flat[2 * m], flat[2 * m + 1]) for m in mask)
            num_classes = int(block["classes"])
            layers.append(LayerSpec(
                "yolo", mask=mask, anchors=anchors, num_classes=num_classes))
            yolo_indices.append(i)
            out_channels.append(out_channels[-1])
        else:
            raise ValueError(f"unsupported block type: {kind!r}")

    return Network(
        layers=tuple(layers), width=width, height=height, channels=channels,
        num_classes=num_classes, yolo_indices=tuple(yolo_indices),
        saved_outputs=tuple(sorted(needed)),
    )


def network_from_cfg(source) -> Network:
    return build_network(parse_darknet_cfg(source))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def conv_specs(net: Network) -> List[ConvSpec]:
    return [l.conv for l in net.layers if l.kind == "convolutional"]


def init_params(net: Network, seed: int = 0) -> Params:
    """Random-init parameters (He-normal kernels, identity BN), drawn with
    ``np.random.default_rng(seed)`` in the JAX package's HWIO layout and
    then transposed to OIHW. CPU float32 tensors."""
    rng = np.random.default_rng(seed)
    params: Params = {}
    for spec in conv_specs(net):
        fan_in = spec.in_ch * spec.size * spec.size
        w = rng.standard_normal(
            (spec.size, spec.size, spec.in_ch, spec.filters),
            dtype=np.float32) * np.float32(np.sqrt(2.0 / fan_in))
        p = {"w": torch.from_numpy(
            np.ascontiguousarray(w.transpose(3, 2, 0, 1)))}
        ones = torch.ones(spec.filters)
        zeros = torch.zeros(spec.filters)
        if spec.bn:
            p.update(gamma=ones, beta=zeros.clone(), mean=zeros.clone(),
                     var=ones.clone())
        else:
            p["b"] = zeros
        params[f"conv_{spec.index}"] = p
    return params


def fold_bn(net: Network, params: Params) -> Params:
    """Fold eval-mode batch-norm into conv kernel + bias.

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x; w * s) + (beta - mean * s),   s = gamma / sqrt(var + eps)

    Returns a params tree with only {"w", "b"} per conv.
    """
    folded: Params = {}
    for spec in conv_specs(net):
        p = {k: torch.as_tensor(v) for k, v in
             params[f"conv_{spec.index}"].items()}
        if "gamma" in p:
            s = p["gamma"] / torch.sqrt(p["var"] + BN_EPS)
            folded[f"conv_{spec.index}"] = {
                "w": p["w"] * s[:, None, None, None],   # s over O (axis 0)
                "b": p["beta"] - p["mean"] * s,
            }
        else:
            folded[f"conv_{spec.index}"] = {"w": p["w"], "b": p["b"]}
    return folded


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _leaky_slope(dtype: torch.dtype) -> float:
    # 0.1 rounded to the compute dtype, as JAX's weakly typed ``0.1 * x``
    return float(torch.tensor(0.1, dtype=dtype))


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return torch.where(x > 0, x, x * _leaky_slope(x.dtype))
    if activation == "mish":
        return x * torch.tanh(torch.logaddexp(x, torch.zeros_like(x)))
    return x


def _maxpool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    if size == 2 and stride == 1:
        # darknet quirk: pad right/bottom by one, then 2x2/1 valid pool
        x = F.pad(x, (0, 1, 0, 1), value=float("-inf"))
        return F.max_pool2d(x, 2, 1)
    return F.max_pool2d(x, size, stride, padding=(size - 1) // 2)


def _upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    return F.interpolate(x, scale_factor=scale, mode="nearest")


# Per-thread route breadcrumb: which stem route the most recent forward
# on this thread took, so a test or benchmark can tell the kernel path
# from the conv walk.
_routes_tls = threading.local()


def _last_routes() -> Dict[str, str]:
    d = getattr(_routes_tls, "d", None)
    if d is None:
        d = {"stem": "conv"}
        _routes_tls.d = d
    return d


def last_routes() -> Dict[str, str]:
    """Routes taken by the most recent forward on this thread:
    ``{"stem": "fused" | "conv"}``."""
    return dict(_last_routes())


class Darknet(nn.Module):
    """The detector, holding BN-folded weights as buffers on ``device``
    (kernels in the compute dtype and ``channels_last``, biases in
    float32 and in the compute dtype; where ``fused_net_applicable``
    holds, the stem convs' kernels also as contiguous HWIO ``sw{i}`` and,
    for the backward kernel, channel-swapped ``sbw{i}``)."""

    def __init__(self, net: Network, params: Params,
                 compute_dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        dev = _cuda.resolve_device(device)
        self.net = net
        self.compute_dtype = compute_dtype
        if any("gamma" in p for p in params.values()):
            params = fold_bn(net, params)
        for spec in conv_specs(net):
            p = params[f"conv_{spec.index}"]
            w = torch.as_tensor(p["w"], dtype=torch.float32)
            b = torch.as_tensor(p["b"], dtype=torch.float32).to(dev)
            self.register_buffer(
                f"w{spec.index}", w.to(dev, compute_dtype).contiguous(
                    memory_format=torch.channels_last))
            self.register_buffer(f"b{spec.index}", b)
            self.register_buffer(f"bc{spec.index}", b.to(compute_dtype))
        self.has_fused_stem = stem_fused.fused_net_applicable(net, params)
        if self.has_fused_stem:
            sp = _stem_params(self.folded_params(), compute_dtype)
            sbp = stem_fused.stem_bwd_params(sp)
            for i, (w, _), v in zip(STEM_CONVS, sp, sbp):
                self.register_buffer(f"sw{i}", w)
                self.register_buffer(f"sbw{i}", v)

    def folded_params(self) -> Params:
        """The held weights as a params tree (kernels in the compute
        dtype, biases float32)."""
        return {f"conv_{s.index}": {"w": getattr(self, f"w{s.index}"),
                                    "b": getattr(self, f"b{s.index}")}
                for s in conv_specs(self.net)}

    def stem_params(self):
        """The fused stem kernel's (HWIO weight, float32 bias) pairs for
        convs 0,1,2,3,5 (``has_fused_stem`` only)."""
        return [(getattr(self, f"sw{i}"), getattr(self, f"b{i}"))
                for i in STEM_CONVS]

    def stem_bwd_params(self):
        """The fused stem backward kernel's weights for convs 0,1,2,3,5
        (``stem_fused.stem_bwd_params``; ``has_fused_stem`` only)."""
        return [getattr(self, f"sbw{i}") for i in STEM_CONVS]

    def forward(self, x: torch.Tensor, fused_stem: bool = False
                ) -> List[torch.Tensor]:
        """``x``: [B, H, W, 3] float in [0, 1] (NHWC) on the module's
        device. Returns the three raw heads [B, S, S, 3*(5+C)] float32."""
        dt = self.compute_dtype
        routes = _last_routes()
        routes["stem"] = "conv"
        tf32 = (_cuda.no_tf32() if dt == torch.float32
                else contextlib.nullcontext())
        with tf32:
            outputs: Dict[int, torch.Tensor] = {}
            xc = x.to(dt)
            if (fused_stem and self.has_fused_stem
                    and stem_shape_ok(tuple(x.shape))):
                prev = stem_fused.fused_stem(xc.contiguous(),
                                             self.stem_params(),
                                             self.stem_bwd_params())
                prev = prev.permute(0, 3, 1, 2)
                outputs[5] = prev
                routes["stem"] = "fused"
                return self.walk(prev, 6, outputs)
            return self.walk(xc.permute(0, 3, 1, 2), 0, outputs)

    def walk(self, prev: torch.Tensor, start: int,
             outputs: Dict[int, torch.Tensor]) -> List[torch.Tensor]:
        """Run layers ``start..`` on ``prev`` (NCHW view, channels_last),
        with ``outputs`` holding the saved outputs of earlier layers."""
        layers = self.net.layers
        saved = set(self.net.saved_outputs)
        heads: List[torch.Tensor] = []
        for i in range(start, len(layers)):
            layer = layers[i]
            if layer.kind == "convolutional":
                spec = layer.conv
                y = F.conv2d(prev, getattr(self, f"w{i}"), None,
                             spec.stride, spec.pad)
                y = y + getattr(self, f"bc{i}").view(1, -1, 1, 1)
                prev = _activate(y, spec.activation)
            elif layer.kind == "maxpool":
                prev = _maxpool(prev, layer.pool_size, layer.pool_stride)
            elif layer.kind == "upsample":
                prev = _upsample(prev, layer.scale)
            elif layer.kind == "route":
                prev = torch.cat([outputs[s] for s in layer.route_from],
                                 dim=1)
            elif layer.kind == "shortcut":
                prev = outputs[i - 1] + outputs[layer.shortcut_from]
            elif layer.kind == "yolo":
                heads.append(prev.float().permute(0, 2, 3, 1).contiguous())
            if i in saved or (i + 1 < len(layers)
                              and layers[i + 1].kind == "shortcut"):
                outputs[i] = prev
        return heads


def apply(net: Network, params: Params, x: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32,
          fused_stem: Optional[bool] = None) -> List[torch.Tensor]:
    """Run the detector once on ``x`` ([B, H, W, 3] NHWC, on its device):
    builds a ``Darknet`` on ``x.device`` and calls it. ``fused_stem``
    routes layers 0-5 through the fused stem kernel where applicable
    (default off)."""
    model = Darknet(net, params, compute_dtype, device=x.device)
    return model(x, fused_stem=bool(fused_stem))
