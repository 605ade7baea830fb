"""Fused SEANet residual block + ELU: CUDA kernel and plain version.

``resblock_elu`` has the contract of the JAX package's
``resblock_elu_pallas`` (ops/pallas/seanet.py):

    ye = elu(mask_valid(x + conv1(elu(conv3(elu(x)) + b3)) + b1))

for x (B, C, T) float32, valid (B,) int32 and HF-layout conv weights w3
(C/2, C, 3), b3 (C/2,), w1 (C, C/2, 1), b1 (C,). On a CUDA tensor it
launches the hand-written kernel (csrc/seanet_resblock.cu); on a CPU tensor
it runs ``resblock_elu_reference``, the model's causal_conv1d chain.
``seanet_stage`` adds the stage's strided causal down-conv in PyTorch after
it. The kernel's summation order need not match the convolution library's,
so its agreement with the plain version is measured (chip_smoke.py), not
bit-guaranteed.

The kernel reads the conv weights in a packed layout (``pack_weights``).
The engine packs its parameters once, when it puts them on the device, and
passes them as ``packed``; a caller that passes none pays for a packing on
every launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tokenize_audio_tpu_torch.config import ieee_fp32
from tokenize_audio_tpu_torch.ops.cuda import _build


def resblock_elu_reference(
    x: torch.Tensor,
    valid: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
) -> torch.Tensor:
    """elu -> causal conv3 -> elu -> causal conv1 -> add -> mask -> elu,
    with masked per-row semantics (stage_reference of the JAX package
    without its down-conv), in IEEE fp32."""
    from tokenize_audio_tpu_torch.mimi.model import _elu, _positions, causal_conv1d

    with ieee_fp32():
        h, _ = causal_conv1d(_elu(x), valid, w3, b3)
        h, _ = causal_conv1d(_elu(h), valid, w1, b1)
    y = x + h
    pos = _positions(y.shape[-1], y.device)[None, None, :]
    y = torch.where(pos < valid[:, None, None], y, 0.0)
    return _elu(y)


def pack_weights(w3: torch.Tensor, w1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF-layout w3 (C2, C, 3) and w1 (C, C2, 1) -> the kernel's layouts:
    w3p (C, 3, ld3) with w3p[c, k, m] = w3[m, c, k] and w1p (C2, ld1) with
    w1p[j, m] = w1[m, j, 0], zero-padded to ld3 = ceil4(C2), ld1 = ceil4(C)
    so each row of output channels loads as 16-byte copies."""
    c2, c, _ = w3.shape
    w3p = w3.new_zeros((c, 3, -(-c2 // 4) * 4))
    w3p[:, :, :c2] = w3.permute(1, 2, 0)
    w1p = w1.new_zeros((c2, -(-c // 4) * 4))
    w1p[:, :c] = w1[:, :, 0].T
    return w3p, w1p


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def resblock_elu(
    x: torch.Tensor,
    valid: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, C, T) float32 -> (B, C, T) float32. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain version. ``packed`` is
    ``pack_weights(w3, w1)``, made once by the caller."""
    args = (x, valid, w3, b3, w1, b1)
    if all(a.device.type == "cpu" for a in args):
        return resblock_elu_reference(*args)
    if x.device.type != "cuda" or any(a.device != x.device for a in args):
        raise ValueError(
            "resblock_elu: every tensor must lie on one CUDA device (or all "
            f"on the CPU); got {[str(a.device) for a in args]}"
        )
    if valid.dtype != torch.int32 or any(
        a.dtype != torch.float32 for a in (x, w3, b3, w1, b1)
    ):
        raise TypeError("resblock_elu takes float32 tensors and int32 valid")
    if x.ndim != 3:
        raise ValueError(f"resblock_elu wants x (B, C, T); got {tuple(x.shape)}")
    b, c, t = x.shape
    c2 = w3.shape[0]
    if (
        tuple(valid.shape) != (b,)
        or tuple(w3.shape) != (c2, c, 3)
        or tuple(b3.shape) != (c2,)
        or tuple(w1.shape) != (c, c2, 1)
        or tuple(b1.shape) != (c,)
    ):
        raise ValueError(
            "resblock_elu wants valid (B,), w3 (C2, C, 3), b3 (C2,), "
            f"w1 (C, C2, 1), b1 (C,) for x {tuple(x.shape)}; got "
            f"{[tuple(a.shape) for a in args[1:]]}"
        )
    if not all(a.is_contiguous() for a in args):
        raise ValueError("resblock_elu takes contiguous tensors")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    w3p, w1p = pack_weights(w3, w1) if packed is None else packed
    if (
        tuple(w3p.shape) != (c, 3, -(-c2 // 4) * 4)
        or tuple(w1p.shape) != (c2, -(-c // 4) * 4)
        or any(p.device != x.device or p.dtype != torch.float32 or not p.is_contiguous()
               for p in (w3p, w1p))
    ):
        raise ValueError("resblock_elu: packed is not pack_weights(w3, w1) on x's device")
    fn = _build.load("seanet_resblock", "resblock_elu_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), valid.data_ptr(), w3p.data_ptr(), b3.data_ptr(),
            w1p.data_ptr(), b1.data_ptr(), out.data_ptr(), b, c, c2, t, stream,
        )
    if err != 0:
        raise RuntimeError(f"resblock kernel launch failed: cudaError {err}")
    resblock_elu.launches += 1
    return out


resblock_elu.launches = 0


def seanet_stage(
    x: torch.Tensor,
    valid: torch.Tensor,
    w3: torch.Tensor,
    b3: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    wd: torch.Tensor,
    bd: torch.Tensor,
    stride: int,
    packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full stage: fused resblock + ELU, then the strided causal down-conv
    (PyTorch). Returns (z (B, 2C, T//stride), new_valid). The down-conv
    runs in IEEE fp32 whatever the caller's precision, as the JAX
    package's ``seanet_stage_pallas`` runs it at HIGHEST."""
    from tokenize_audio_tpu_torch.mimi.model import causal_conv1d

    ye = resblock_elu(x.contiguous(), valid, w3, b3, w1, b1, packed=packed)
    with ieee_fp32():
        return causal_conv1d(ye, valid, wd, bd, stride=stride)
