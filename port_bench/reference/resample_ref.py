"""Plain rational resampler: ``scipy.signal.resample_poly`` with its
default filter (a Kaiser-windowed sinc, beta 5.0, half-length
``10 * max(up, down)``, unit DC gain times ``up``), as zero-stuffing, one
full convolution and decimation in float64. It imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def kaiser_sinc(up: int, down: int, half_width: int = 10, beta: float = 5.0) -> np.ndarray:
    """``firwin(2*half_width*max(up, down)+1, 1/max(up, down),
    window=('kaiser', beta)) * up``."""
    m = max(up, down)
    half = half_width * m
    n = np.arange(-half, half + 1, dtype=np.float64)
    h = (1.0 / m) * np.sinc(n / m) * np.kaiser(2 * half + 1, beta)
    return h / h.sum() * up


@torch.no_grad()
def resample_poly(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """(T,) -> (ceil(T * up / down),) float64, on ``x``'s device."""
    h = kaiser_sinc(up, down)
    half = (len(h) - 1) // 2
    pre_pad = (down - half % down) % down
    pre_remove = (half + pre_pad) // down
    h = np.concatenate([np.zeros(pre_pad), h])
    n = x.shape[-1]
    n_out = -(-n * up // down)
    stuffed = torch.zeros(n * up, dtype=torch.float64, device=x.device)
    stuffed[::up] = x.double()
    taps = torch.from_numpy(h[::-1].copy()).to(x.device)
    full = F.conv1d(stuffed[None, None], taps[None, None], padding=len(h) - 1)[0, 0]
    return full[::down][pre_remove: pre_remove + n_out]
