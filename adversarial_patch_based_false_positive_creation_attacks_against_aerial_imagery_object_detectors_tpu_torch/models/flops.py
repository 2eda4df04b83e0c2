"""Analytic conv FLOP counts for a compiled ``Network`` and the card's
peak, for the training step's model FLOP utilization (``mfu``).

The patch-training step's FLOPs are the detector's convolutions, run
forward once and once more as the input-cotangent (dgrad) chain: the
victim's weights are frozen, so no weight-gradient convolutions run.
dgrad FLOPs equal forward FLOPs. The count is conv-only (the EOT warp,
median, losses and optimizer are O(patch or canvas) elementwise), so the
derived MFU is a slight under-estimate.
"""

from __future__ import annotations

from typing import Optional

from .darknet import Network

# dense bfloat16 tensor-core peak, FLOP/s (NVIDIA's H100 SXM data sheet);
# the SXM part reports itself as "NVIDIA H100 80GB HBM3"
H100_SXM_BF16 = 989e12


def peak_flops_bf16(device_name: str) -> Optional[float]:
    """Dense bf16 peak for a ``torch.cuda.get_device_name``, else None
    (an unknown card, or the H100's PCIe and NVL parts, whose peaks
    differ)."""
    if ("H100" in device_name and "PCIe" not in device_name
            and "NVL" not in device_name):
        return H100_SXM_BF16
    return None


def conv_fwd_flops_per_image(net: Network) -> float:
    """Total forward conv FLOPs (2*MACs) for ONE image at the network's
    configured input size, tracking spatial dims as ``Darknet`` does."""
    h, w = net.height, net.width
    dims = []
    total = 0.0
    for layer in net.layers:
        if layer.kind == "convolutional":
            s = layer.conv.stride
            oh, ow = -(-h // s), -(-w // s)
            total += 2.0 * oh * ow * layer.conv.filters * \
                layer.conv.in_ch * layer.conv.size ** 2
            h, w = oh, ow
        elif layer.kind == "maxpool":
            s = layer.pool_stride
            h, w = -(-h // s), -(-w // s)
        elif layer.kind == "upsample":
            h, w = h * layer.scale, w * layer.scale
        elif layer.kind == "route":
            h, w = dims[layer.route_from[0]]
        elif layer.kind == "shortcut":
            h, w = dims[layer.shortcut_from]
        dims.append((h, w))
    return total


def train_step_flops_per_image(net: Network) -> float:
    """Conv FLOPs of one patch-optimization step per image: forward + the
    input-cotangent chain."""
    return 2.0 * conv_fwd_flops_per_image(net)


def mfu(step_seconds: float, batch: int, net: Network,
        device_name: str, n_devices: int = 1) -> Optional[float]:
    """Model FLOP utilization of the training step of a global ``batch``
    on ``n_devices`` cards (each card's share of the batch's FLOPs over
    its peak), or None where the card has no known peak."""
    peak = peak_flops_bf16(device_name)
    if peak is None or step_seconds <= 0:
        return None
    flops = train_step_flops_per_image(net) * batch
    return flops / step_seconds / (peak * n_devices)
