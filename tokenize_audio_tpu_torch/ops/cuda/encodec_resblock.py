"""EnCodec's SEANet resnet block + the ELU after it: CUDA kernel and plain
version.

``resblock_elu`` maps x (B, C, T) float32, per-row valid lengths (or None)
and HF-layout conv weights w3 (C/2, C, 3), b3, w1 (C, C/2, 1), b1 and the
conv shortcut wsc (C, C, 1), bsc to

    ye = elu(mask_valid(shortcut(x) + conv1(elu(conv3(elu(x))))))

with each conv causal and reflect-padded as transformers' ``EncodecConv1d``
pads it (only the k3 conv pads: two columns, the reflection of columns 2
and 1), one resnet block of ``EncodecEncoder`` (dilation 1, conv shortcut)
and the stage's ELU before its strided down-conv. On a CUDA tensor it
launches the hand-written kernel (csrc/encodec_resblock.cu); on a CPU
tensor it runs ``resblock_elu_reference``, the model's causal_conv1d chain.
The kernel replaces no TPU kernel: the JAX package has no EnCodec. It
takes C of 32, 64, 128 or 256, the 24 kHz model's stages.

The kernel reads the weights in a packed layout (``pack_weights``), which
the engine makes once when it puts the parameters on the device
(``encodec.weights.prepare``); a caller that passes none pays for a packing
on every launch. Its sums run in another order than cuDNN's, so its
agreement with the plain version is measured (tests/test_torch_encodec_resblock.py,
chip_smoke.py), not bit-guaranteed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.ops.cuda import _build

WIDTHS = (32, 64, 128, 256)  # the channel counts the kernel takes (csrc: pick())


def resblock_elu_reference(
    x: torch.Tensor,
    valid: Optional[torch.Tensor],
    w3: torch.Tensor,
    b3: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    wsc: torch.Tensor,
    bsc: torch.Tensor,
) -> torch.Tensor:
    """The resnet block and the ELU after it as ``encodec.model`` chains
    them: the k3 conv on elu(x), the k1 conv on its elu, the k1 shortcut
    on x, their sum masked past each row's valid length, its ELU. In the
    precision the caller holds (``encodec.model.encode`` holds IEEE)."""
    from tokenize_audio_tpu_torch.encodec.model import _mask, causal_conv1d

    h, _ = causal_conv1d(F.elu(x), None, w3, b3)
    h, _ = causal_conv1d(F.elu(h), None, w1, b1)
    sc, _ = causal_conv1d(x, None, wsc, bsc)
    return F.elu(_mask(sc + h, valid))


def pack_weights(
    w3: torch.Tensor, b3: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
    wsc: torch.Tensor, bsc: torch.Tensor,
) -> Dict[str, torch.Tensor]:
    """HF-layout weights -> the kernel's, on their device: ``w3`` (C, 3, C2)
    with w3p[c, k, m] = w3[m, c, k]; ``wy`` (C + C2, C), the shortcut's
    wsc[m, c, 0] at [c, m] and then conv1's w1[m, j, 0] at [C + j, m], the
    rows one input channel (or one row of h) multiplies; ``b3`` (C2,);
    ``by`` (C,) = bsc + b1. One thread's output rows are contiguous in each
    row, so they load as 16-byte copies."""
    return {
        "w3": w3.permute(1, 2, 0).contiguous(),
        "wy": torch.cat([wsc[:, :, 0].T, w1[:, :, 0].T]).contiguous(),
        "b3": b3.contiguous(),
        "by": (bsc + b1).contiguous(),
    }


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def resblock_elu(
    x: torch.Tensor,
    valid: Optional[torch.Tensor],
    w3: torch.Tensor,
    b3: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    wsc: torch.Tensor,
    bsc: torch.Tensor,
    packed: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, C, T) float32 -> (B, C, T) float32. A CUDA tensor launches the
    kernel (or raises); a CPU tensor takes the plain version. ``valid``
    None masks nothing. ``packed`` is ``pack_weights(...)``, made once by
    the caller. On either device the tensors' device, float type and shapes
    are checked first: every shape names the block's form (a k3 conv to
    C/2, a k1 conv back, a k1 shortcut)."""
    weights = (w3, b3, w1, b1, wsc, bsc)
    args = (x, *weights) if valid is None else (x, valid, *weights)
    on_cpu = all(a.device.type == "cpu" for a in args)
    if not on_cpu and (x.device.type != "cuda" or any(a.device != x.device for a in args)):
        raise ValueError(
            "encodec resblock_elu: every tensor must lie on one CUDA device (or all "
            f"on the CPU); got {[str(a.device) for a in args]}"
        )
    if any(a.dtype != torch.float32 for a in (x, *weights)) or (
        not on_cpu and valid is not None and valid.dtype != torch.int32
    ):
        raise TypeError("encodec resblock_elu takes float32 tensors (and on the card int32 valid)")
    if x.ndim != 3:
        raise ValueError(f"encodec resblock_elu wants x (B, C, T); got {tuple(x.shape)}")
    b, c, t = x.shape
    c2 = c // 2
    if (
        (valid is not None and tuple(valid.shape) != (b,))
        or tuple(w3.shape) != (c2, c, 3)
        or tuple(b3.shape) != (c2,)
        or tuple(w1.shape) != (c, c2, 1)
        or tuple(b1.shape) != (c,)
        or tuple(wsc.shape) != (c, c, 1)
        or tuple(bsc.shape) != (c,)
    ):
        raise ValueError(
            "encodec resblock_elu wants valid (B,), w3 (C/2, C, 3), b3 (C/2,), "
            f"w1 (C, C/2, 1), b1 (C,), wsc (C, C, 1), bsc (C,) for x {tuple(x.shape)}; got "
            f"{[tuple(a.shape) for a in args[1:]]}"
        )
    if on_cpu:
        return resblock_elu_reference(x, valid, *weights)
    if c not in WIDTHS:
        raise ValueError(f"the EnCodec resblock kernel takes C in {WIDTHS} (got {c})")
    if t < 3:
        raise ValueError(f"the k3 conv's reflect pad needs T >= 3 (got {t})")
    if not x.is_contiguous() or (valid is not None and not valid.is_contiguous()):
        raise ValueError("encodec resblock_elu takes contiguous tensors")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    if packed is None:
        packed = pack_weights(*weights)
    want = {"w3": (c, 3, c2), "wy": (c + c2, c), "b3": (c2,), "by": (c,)}
    if any(
        k not in packed or tuple(packed[k].shape) != s or packed[k].device != x.device
        or packed[k].dtype != torch.float32 or not packed[k].is_contiguous()
        or packed[k].data_ptr() % 16 != 0
        for k, s in want.items()
    ):
        raise ValueError("encodec resblock_elu: packed is not pack_weights(...) on x's device")
    fn = _build.load("encodec_resblock", "encodec_resblock_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), None if valid is None else valid.data_ptr(),
            packed["w3"].data_ptr(), packed["b3"].data_ptr(), packed["wy"].data_ptr(),
            packed["by"].data_ptr(), out.data_ptr(), b, c, t, stream,
        )
    if err != 0:
        raise RuntimeError(f"encodec resblock kernel launch failed: cudaError {err}")
    resblock_elu.launches += 1
    return out


resblock_elu.launches = 0
