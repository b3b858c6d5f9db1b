"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W), and the card's power limit
as ``nvidia-smi`` reads it: a card set below 700 W runs slower under
load, so every roofline share is stated against these peaks with the
limit beside it."""
from __future__ import annotations

import subprocess

__all__ = ["HBM", "PEAK_OPS", "power_limit_w"]

HBM = 3.35e12                  # bytes/s, HBM3
PEAK_OPS = {                   # operations/s
    "bf16": 989e12, "fp16": 989e12, "fp8": 1979e12, "int8": 1979e12,
    "tf32": 495e12, "fp32": 67e12,
}


def power_limit_w():
    """The first card's power limit in watts, or None where
    ``nvidia-smi`` cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
