"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit)."""

from __future__ import annotations

# name as torch.cuda.get_device_name() gives it -> peaks
PEAKS = {
    # H100 SXM5: 989 TFLOP/s bfloat16 dense, 3.35 TB/s HBM3
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str, key: str):
    """The peak ``key`` of the card, or None for a card not in the
    table (a metric built on it is then left out)."""
    return PEAKS.get(device_name, {}).get(key)


def roofline_ms(device_name: str, bytes_moved: float, flops: float):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of bytes over the HBM rate and bfloat16 operations over the
    tensor-core rate; None for a card not in the table."""
    bw, fl = peak(device_name, "hbm_bytes"), peak(device_name, "bf16_flops")
    if bw is None or fl is None:
        return None
    t_bytes, t_ops = bytes_moved / bw * 1e3, flops / fl * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
