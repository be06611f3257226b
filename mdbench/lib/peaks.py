"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense rates), the
bound of a kernel's work, and the card's own power limit, written beside
every share of a peak."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12  # HBM3, 80 GB
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take for the work, and what bounds it:
    max(bytes / HBM bandwidth, flops / fp32 peak)."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOPS_PER_S
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "flops")


def power_limit_w() -> float | None:
    """The first card's power limit in watts, from ``nvidia-smi`` (None where
    it cannot be read)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
