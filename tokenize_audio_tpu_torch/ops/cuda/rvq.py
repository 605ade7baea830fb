"""Chained residual-vector-quantization search: CUDA kernel and plain version.

``rvq_quantize`` has the contract of the JAX package's
``rvq_quantize_pallas`` (ops/pallas/rvq.py): x (N, D) float32 projected
embeddings and embeds (K, V, D) float32 -> codes (N, K) int32, each book
searched on the residual the previous books left. On a CUDA tensor it
launches the hand-written kernel (csrc/rvq.cu); on a CPU tensor it runs
``rvq_quantize_reference``, the same chain in PyTorch ops.

The kernel reads the codebooks for its distance products in a packed
layout (``pack_codebooks``: (K, D, V) and the codewords' squared norms).
The engine packs its codebooks once, when it puts them on the device, and
passes them as ``packed``; a caller that passes none pays for a packing on
every launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tokenize_audio_tpu_torch.config import ieee_fp32
from tokenize_audio_tpu_torch.ops.cuda import _build


def rvq_quantize_reference(x: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Per-book matmul + first-index argmin + gather:
    d2 = (|r|^2 - 2 r.e) + |e|^2, the expansion torch.cdist uses at these
    sizes (mimi/model.py:315-336 of the JAX package), in IEEE fp32."""
    residual = x
    codes = []
    with ieee_fp32():
        for e in embeds:  # (V, D)
            x2 = (residual * residual).sum(-1, keepdim=True)  # (N, 1)
            e2 = (e * e).sum(-1)  # (V,)
            d2 = x2 - 2.0 * (residual @ e.T) + e2[None, :]
            idx = torch.argmin(d2, dim=-1)  # first minimal index
            codes.append(idx.to(torch.int32))
            residual = residual - e[idx]
    if not codes:
        return torch.zeros((x.shape[0], 0), dtype=torch.int32, device=x.device)
    return torch.stack(codes, dim=1)


def pack_codebooks(embeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, V, D) codebooks -> the kernel's inputs: cb (K, D, VP) with
    cb[k, d, v] = embeds[k, v, d], zero-padded to VP = ceil4(V) so each
    depth row of a codebook chunk loads as 16-byte copies, and e2 (K, V),
    the codewords' squared norms by the plain version's expression."""
    k, v, d = embeds.shape
    cb = embeds.new_zeros((k, d, -(-v // 4) * 4))
    cb[:, :, :v] = embeds.transpose(1, 2)
    return cb, (embeds * embeds).sum(-1).contiguous()


def first_divergence_margins(x, embeds, got, want):
    """For each row whose codes ``got`` differ from the plain codes
    ``want``, replay the plain chain up to the first differing book and
    return the rows, the relative margin (d2[got idx] - d2[want idx]) /
    |d2[want idx]| there, and the absolute distance gap. A kernel that only
    sums in another order differs at near-ties alone."""
    rows = torch.nonzero((got != want).any(dim=1)).flatten().tolist()
    margins, gaps = [], []
    with ieee_fp32():
        for r in rows:
            k = int(torch.nonzero(got[r] != want[r])[0])
            res = x[r].clone()
            for j in range(k):
                res = res - embeds[j, want[r, j].long()]
            e = embeds[k]
            d2 = (res * res).sum() - 2.0 * (e @ res) + (e * e).sum(-1)
            a, b = d2[got[r, k].long()], d2[want[r, k].long()]
            gaps.append(float((a - b).abs()))
            margins.append(float((a - b) / b.abs()))
    return rows, margins, gaps


_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rvq_quantize(
    x: torch.Tensor,
    embeds: torch.Tensor,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Codes (N, K) int32 for x (N, D) and embeds (K, V, D), both float32.
    A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
    plain version. ``packed`` is ``pack_codebooks(embeds)``, made once by
    the caller."""
    if x.device.type == "cpu" and embeds.device.type == "cpu":
        return rvq_quantize_reference(x, embeds)
    if x.device.type != "cuda" or embeds.device != x.device:
        raise ValueError(
            f"rvq_quantize: x on {x.device} and embeds on {embeds.device}; "
            "both must lie on one CUDA device (or both on the CPU)"
        )
    if x.dtype != torch.float32 or embeds.dtype != torch.float32:
        raise TypeError(f"rvq_quantize takes float32 (got {x.dtype}, {embeds.dtype})")
    if x.ndim != 2 or embeds.ndim != 3 or embeds.shape[2] != x.shape[1]:
        raise ValueError(
            f"rvq_quantize wants x (N, D) and embeds (K, V, D); got "
            f"{tuple(x.shape)} and {tuple(embeds.shape)}"
        )
    if not (x.is_contiguous() and embeds.is_contiguous()):
        raise ValueError("rvq_quantize takes contiguous tensors")
    n, d = x.shape
    k, v, _ = embeds.shape
    out = torch.empty((n, k), dtype=torch.int32, device=x.device)
    if n == 0 or k == 0:
        return out
    cb, e2 = pack_codebooks(embeds) if packed is None else packed
    if (
        tuple(cb.shape) != (k, d, -(-v // 4) * 4)
        or tuple(e2.shape) != (k, v)
        or any(p.device != x.device or p.dtype != torch.float32 or not p.is_contiguous()
               for p in (cb, e2))
    ):
        raise ValueError("rvq_quantize: packed is not pack_codebooks(embeds) on x's device")
    fn = _build.load("rvq", "rvq_quantize_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), cb.data_ptr(), e2.data_ptr(), embeds.data_ptr(), out.data_ptr(),
            n, d, k, v, stream,
        )
    if err != 0:
        raise RuntimeError(f"rvq kernel launch failed: cudaError {err}")
    rvq_quantize.launches += 1
    return out


rvq_quantize.launches = 0
