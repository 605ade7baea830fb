"""Published peaks per card, by ``torch.cuda.get_device_name()``.

NVIDIA H100 SXM data sheet, dense rates: float32 outside the tensor cores
67 TFLOP/s, HBM3 3.35 TB/s, at the full 700 W power limit. The configured
precision of every cell is IEEE float32 (TF32 off), so float32 is the
rate a share of the peak is taken against. A card that is not listed has
no peak, and every share of a peak is then left out of the line.
"""

from __future__ import annotations

import subprocess
from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)


def bound_seconds(flop: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 rate and the bytes over the HBM bandwidth."""
    return max(flop / pk["fp32_flops"], nbytes / pk["hbm_bytes"])


def card_label(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (a card set below
    its maximum power runs slower); copied from the program's
    ``benchmark.device_label``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        lines = out.stdout.strip().splitlines()
        return lines[index] if index < len(lines) else lines[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"
