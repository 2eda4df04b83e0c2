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
- Kernel routes, as the JAX package's ``darknet.apply`` tries them:
  layers 0-5 on the fused stem kernels (``fused_stem=True``, K1/K2,
  ``ops/stem_fused.py``) where ``fused_applicable`` holds, else on the
  per-layer planar stem (``planar_stem=True``, K4,
  ``models/stem_planar.py``) where ``stem_applicable`` holds, else on the
  conv walk. Only after a kernel stem, ``res152="fused"`` runs layers
  6-11 on the whole-stage kernels (K6a/K6b) and ``res152="planar"`` on
  K4 (``models/res_planar.py``), each where its own test holds. Inputs
  that require grad take each route's autograd Function (input
  cotangent only). The Detector asks for both stems on CUDA; the trainer
  for the fused stem. Each route's weights, in its kernels' layouts, are
  prepared once at build where the network allows the route.
  ``last_routes()`` reports which routes the last forward on this thread
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

from ..ops import _cuda, res_fused, stem_fused
from . import res_planar, stem_planar
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


# Per-thread route breadcrumb: which routes the most recent forward on
# this thread took, so a test or benchmark can tell the kernel paths from
# the conv walk.
_routes_tls = threading.local()

RES152_ROUTES = (None, "fused", "planar")


def _last_routes() -> Dict[str, str]:
    d = getattr(_routes_tls, "d", None)
    if d is None:
        d = {"stem": "conv", "res152": "conv"}
        _routes_tls.d = d
    return d


def last_routes() -> Dict[str, str]:
    """Routes taken by the most recent forward on this thread:
    ``{"stem": "fused" | "planar" | "conv",
    "res152": "fused" | "planar" | "conv"}``."""
    return dict(_last_routes())


class Darknet(nn.Module):
    """The detector, holding BN-folded weights as buffers on ``device``
    (kernels in the compute dtype and ``channels_last``, biases in
    float32 and in the compute dtype) and, for each kernel route the
    network allows, that route's weights in its kernels' layouts: the
    fused stem's contiguous HWIO ``sw{i}`` and channel-swapped ``sbw{i}``,
    the planar stem's ``pw{i}`` and flipped ``pwt{i}``, the 152^2 stage's
    HWIO ``rw{i}`` and flipped ``rwt{i}`` (K4 and K6 read the same)."""

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
        self.has_planar_stem = stem_planar.stem_net_applicable(net, params)
        self.has_res152 = (self.has_planar_stem
                           and res_planar.res152_applicable(net, params))
        self.has_fused_res = (self.has_res152 and
                              res_planar.fused_res_net_applicable(net, params))
        folded = self.folded_params()
        if self.has_fused_stem:
            sp = _stem_params(folded, compute_dtype)
            sbp = stem_fused.stem_bwd_params(sp)
            for i, (w, _), v in zip(STEM_CONVS, sp, sbp):
                self.register_buffer(f"sw{i}", w)
                self.register_buffer(f"sbw{i}", v)
        if self.has_planar_stem:
            fwd, bwd = stem_planar.planar_stem_params(
                _stem_params(folded, compute_dtype))
            for i, (w, _), (wt, z) in zip(STEM_CONVS, fwd, bwd):
                self.register_buffer(f"pw{i}", w)
                self.register_buffer(f"pwt{i}", wt)
                self.register_buffer(f"pzb{i}", z)
        if self.has_res152:
            fwd, bwd = res_fused.res_weights(
                _stem_params(folded, compute_dtype,
                             res_planar.RES152_CONVS))
            for i, (w, _), wt in zip(res_planar.RES152_CONVS, fwd, bwd):
                self.register_buffer(f"rw{i}", w)
                self.register_buffer(f"rwt{i}", wt)
                self.register_buffer(f"rzb{i}", torch.zeros(
                    wt.shape[-1], dtype=torch.float32, device=dev))

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

    def planar_stem_params(self):
        """``stem_planar.planar_stem_params``'s (forward, backward) pairs
        for convs 0,1,2,3,5 (``has_planar_stem`` only)."""
        return ([(getattr(self, f"pw{i}"), getattr(self, f"b{i}"))
                 for i in STEM_CONVS],
                [(getattr(self, f"pwt{i}"), getattr(self, f"pzb{i}"))
                 for i in STEM_CONVS])

    def res_params(self):
        """The 152^2 stage's weights for convs 6, 7, 9, 10
        (``has_res152`` only): ``res_fused.res_weights``'s forward pairs
        and flipped kernels (K6's), and the flipped kernels with zero
        biases (K4's backward)."""
        convs = res_planar.RES152_CONVS
        return ([(getattr(self, f"rw{i}"), getattr(self, f"b{i}"))
                 for i in convs],
                [getattr(self, f"rwt{i}") for i in convs],
                [(getattr(self, f"rwt{i}"), getattr(self, f"rzb{i}"))
                 for i in convs])

    def forward(self, x: torch.Tensor, fused_stem: bool = False,
                planar_stem: bool = False, res152: Optional[str] = None
                ) -> List[torch.Tensor]:
        """``x``: [B, H, W, 3] float in [0, 1] (NHWC) on the module's
        device. Returns the three raw heads [B, S, S, 3*(5+C)] float32.
        ``fused_stem`` / ``planar_stem`` ask for the stem kernels (tried in
        that order), ``res152`` (None, "fused" or "planar") for the 152^2
        stage's after a kernel stem; each is taken where it applies."""
        if res152 not in RES152_ROUTES:
            raise ValueError(f"res152={res152!r}, expected one of "
                             f"{RES152_ROUTES}")
        dt = self.compute_dtype
        routes = _last_routes()
        routes.update(stem="conv", res152="conv")
        tf32 = (_cuda.no_tf32() if dt == torch.float32
                else contextlib.nullcontext())
        with tf32:
            outputs: Dict[int, torch.Tensor] = {}
            xc = x.to(dt)
            shape_ok = stem_shape_ok(tuple(x.shape))
            if fused_stem and self.has_fused_stem and shape_ok:
                prev = stem_fused.fused_stem(xc.contiguous(),
                                             self.stem_params(),
                                             self.stem_bwd_params())
                routes["stem"] = "fused"
            elif planar_stem and self.has_planar_stem and shape_ok:
                prev = stem_planar.planar_stem(xc.contiguous(),
                                               *self.planar_stem_params())
                routes["stem"] = "planar"
            else:
                return self.walk(xc.permute(0, 3, 1, 2), 0, outputs)
            # prev: the stem's NHWC output; the res152 routes follow a
            # kernel stem only (the JAX package's start == 6)
            start = 6
            if res152 == "fused" and self.has_fused_res \
                    and res_planar.fused_res_shape_ok(tuple(x.shape)):
                fwd, bwd, _ = self.res_params()
                prev = res_planar.res152_fused_stage(prev, fwd, bwd)
                routes["res152"], start = "fused", 12
            elif res152 == "planar" and self.has_res152:
                fwd, _, bwd = self.res_params()
                prev = res_planar.res152_planar(prev, fwd, bwd)
                routes["res152"], start = "planar", 12
            prev = prev.permute(0, 3, 1, 2)
            outputs[start - 1] = prev
            return self.walk(prev, start, outputs)

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
          fused_stem: Optional[bool] = None,
          planar_stem: Optional[bool] = None,
          res152: Optional[str] = None) -> List[torch.Tensor]:
    """Run the detector once on ``x`` ([B, H, W, 3] NHWC, on its device):
    builds a ``Darknet`` on ``x.device`` and calls it. ``fused_stem``,
    ``planar_stem`` and ``res152`` pick the kernel routes where they apply
    (default: the conv walk)."""
    model = Darknet(net, params, compute_dtype, device=x.device)
    return model(x, fused_stem=bool(fused_stem),
                 planar_stem=bool(planar_stem), res152=res152)
