"""The crafted brightness victim of the warp A/B tools: the port's own
copy of the repository's ``craft_brightness_victim``
(``tests/test_attack_closed_loop.py``), which the JAX tools import from
the tests.

The victim's objectness is a calibrated function of local brightness:
``tiny_test_blocks(width=64, height=64)`` with centre-tap identity
kernels carrying channel 0 through the backbone, and each head's
objectness a per-scale linear map of that feature. It makes an attack
measurable end to end without trained weights: dark scenes give no
detection, a bright patch does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import apply, build_network, conv_specs, tiny_test_blocks

IMG = 64


def craft_brightness_victim():
    """``(net, params)``, the params in the port's folded ``{w, b}`` form
    (OIHW float32 CPU tensors, as ``init_params`` gives them): channel 0
    carries local brightness through the backbone (centre-tap identity
    kernels), and each head's objectness is a per-scale linear map of
    that feature, calibrated through the port's float32 forward so that
    brightness 0.2 -> logit -6 and 0.9 -> logit +3. Class 3 has a
    constant +2 logit so obj*cls crosses thresholds."""
    net = build_network(tiny_test_blocks(width=IMG, height=IMG))
    params = {}
    for spec in conv_specs(net):
        w = np.zeros((spec.filters, spec.in_ch, spec.size, spec.size),
                     np.float32)
        c = spec.size // 2
        w[0, 0, c, c] = 1.0      # pass channel 0 through
        params[f"conv_{spec.index}"] = {
            "w": torch.from_numpy(w),
            "b": torch.zeros(spec.filters),
        }

    # calibrate each head: read the channel-0 feature under constant
    # brightness (head conv currently copies feature ch0 into out ch0)
    def feature_at_heads(v):
        x = torch.full((1, IMG, IMG, 3), v)
        with torch.no_grad():
            heads = apply(net, params, x)
        return [float(h[0, 0, 0, 0]) for h in heads]

    f_lo = feature_at_heads(0.2)
    f_hi = feature_at_heads(0.9)
    head_specs = [s for s in conv_specs(net) if s.filters == 60]
    for spec, lo, hi in zip(head_specs, f_lo, f_hi):
        alpha = 9.0 / (hi - lo)
        beta = 3.0 - alpha * hi
        w = np.zeros((60, spec.in_ch, 1, 1), np.float32)
        b = np.zeros((60,), np.float32)
        for a in range(3):
            w[20 * a + 4, 0, 0, 0] = alpha        # obj logit
            b[20 * a + 4] = beta
            b[20 * a + 5 + 3] = 2.0               # class 3 logit
            b[20 * a + 5:20 * a + 20] += np.where(
                np.arange(15) == 3, 0.0, -4.0)    # other classes low
        params[f"conv_{spec.index}"] = {"w": torch.from_numpy(w),
                                        "b": torch.from_numpy(b)}
    return net, params
