"""EnCodec's two-layer LSTM with its input added back: CUDA kernel and plain
version.

``lstm_residual`` maps x (B, C, T) float32 to ``lstm(x) + x`` (B, C, T): the
unidirectional multi-layer LSTM of transformers ``EncodecLSTM`` from a zero
state, one step a frame, with its input added back. On a CUDA tensor it
computes layer 0's input gates for every frame as one matrix product
(``x W_ih0^T + b_ih0 + b_hh0``, in the precision the caller holds) and then
launches the persistent kernel (csrc/lstm.cu) once, which steps both layers
through every frame and writes the sum. On a CPU tensor it runs
``lstm_residual_reference``, cuDNN's and oneDNN's ``torch.lstm`` call. The
kernel replaces no TPU kernel: the JAX package has no EnCodec.

The kernel takes one shape, EnCodec 24 kHz's: 2 layers of width 512. It
reads the weights in a packed layout (``pack_weights``), which the engine
makes once when it puts the parameters on the device
(``encodec.weights.prepare``). Its sums run in another order than cuDNN's,
so its agreement with the plain version is measured (tests/test_torch_cuda.py,
chip_smoke.py), not bit-guaranteed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from tokenize_audio_tpu_torch.config import ieee_fp32
from tokenize_audio_tpu_torch.ops.cuda import _build

HIDDEN = 512  # the kernel's width (csrc/lstm.cu: H)
LAYERS = 2
UNITS = 4  # hidden units of each layer one block owns
BLOCKS = HIDDEN // UNITS
THREADS = 512
MAX_ROWS = 256  # batch rows a launch takes (shared memory holds up to ~400); more go in blocks


def lstm_residual_reference(x: torch.Tensor, weights: Sequence[torch.Tensor], layers: int) -> torch.Tensor:
    """x (B, C, T) -> lstm(x) + x by ``torch.lstm`` over the frames, with
    ``weights`` [w_ih_l0, w_hh_l0, b_ih_l0, b_hh_l0, ...] in its order, in
    IEEE fp32 (cuDNN's LSTM runs TF32 unless told otherwise)."""
    h = x.permute(2, 0, 1)  # (T, B, C)
    zeros = h.new_zeros((layers, h.shape[1], weights[1].shape[1]))
    with ieee_fp32():
        y = torch.lstm(h, (zeros, zeros), list(weights), True, layers, 0.0, False, False, False)[0]
    return (y + h).permute(1, 2, 0)


def _gate_order(device) -> torch.Tensor:
    """The packed gate order: position ``16 j + 4 gate + u`` holds torch's
    gate row ``gate * 512 + 4 j + u`` (gates i, f, g, o), so block j's 16
    rows, all four gates of units 4j..4j+3, lie together."""
    blk = torch.arange(BLOCKS, device=device)[:, None, None]
    gate = torch.arange(4, device=device)[None, :, None]
    u = torch.arange(UNITS, device=device)[None, None, :]
    return (gate * HIDDEN + blk * UNITS + u).reshape(-1)


def _rec_index(device):
    """Where each of the kernel's register weights comes from: (matrix,
    gate row, input) index tensors broadcast to (block, part, j, warp,
    row group, input group), which reshape to ``rec``'s (BLOCKS, 48,
    THREADS). Part p of a thread (lane = 4 row group + input group) holds
    block row ``row group + 8 (p % 2)`` of W_hh0 (p = 0, 1), W_ih1 (2, 3) or
    W_hh1 (4, 5) at inputs ``32 warp + 8 input group + j``, j < 8."""
    def ax(n, dim):
        shape = [1] * 6
        shape[dim] = n
        return torch.arange(n, device=device).reshape(shape)

    blk, part, j, warp, rg, kg = ax(BLOCKS, 0), ax(6, 1), ax(8, 2), ax(16, 3), ax(8, 4), ax(4, 5)
    lr = rg + 8 * (part % 2)  # the block's gate row: 4 gate + unit
    row = (lr // 4) * HIDDEN + blk * UNITS + lr % 4
    return part // 2, row, warp * 32 + kg * 8 + j


def pack_weights(weights: Sequence[torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torch.lstm's [w_ih_l0, w_hh_l0, b_ih_l0, b_hh_l0, w_ih_l1, ...] for 2
    layers of 512 -> the kernel's inputs, on the weights' device:
    ``w_in0`` (2048, 512) W_ih0's rows and ``b_in0`` (2048,) b_ih0 + b_hh0
    in the packed gate order (``_gate_order``), for the input product;
    ``rec`` (128, 48, 512), the recurrent weights W_hh0, W_ih1 and W_hh1 as
    the kernel's threads hold them (``_rec_index``); ``b1`` (2048,)
    b_ih1 + b_hh1 in the packed gate order."""
    weights = list(weights)
    want = [(4 * HIDDEN, HIDDEN), (4 * HIDDEN, HIDDEN), (4 * HIDDEN,), (4 * HIDDEN,)] * LAYERS
    if [tuple(w.shape) for w in weights] != want:
        raise ValueError(
            f"the LSTM kernel runs {LAYERS} layers of {HIDDEN} (EnCodec 24 kHz's); got "
            f"{[tuple(w.shape) for w in weights]}"
        )
    w_ih0, w_hh0, b_ih0, b_hh0, w_ih1, w_hh1, b_ih1, b_hh1 = weights
    order = _gate_order(w_ih0.device)
    mat, row, k = _rec_index(w_ih0.device)
    mats = torch.stack([w_hh0, w_ih1, w_hh1])
    return {
        "w_in0": w_ih0[order].contiguous(),
        "b_in0": (b_ih0 + b_hh0)[order].contiguous(),
        "rec": mats[mat, row, k].reshape(BLOCKS, 6 * 8, THREADS).contiguous(),
        "b1": (b_ih1 + b_hh1)[order].contiguous(),
    }


def unpack_weights(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``pack_weights``'s inverse: the four matrices in torch's layout and
    each layer's summed biases."""
    dev = packed["rec"].device
    order = _gate_order(dev)
    mat, row, k = _rec_index(dev)
    shape = torch.broadcast_shapes(mat.shape, row.shape, k.shape)
    mats = packed["rec"].new_zeros((3, 4 * HIDDEN, HIDDEN))
    mats[mat.expand(shape), row.expand(shape), k.expand(shape)] = packed["rec"].reshape(shape)

    def unorder(t):
        out = torch.empty_like(t)
        out[order] = t
        return out

    return {"w_ih0": unorder(packed["w_in0"]), "w_hh0": mats[0], "w_ih1": mats[1],
            "w_hh1": mats[2], "b0": unorder(packed["b_in0"]), "b1": unorder(packed["b1"])}


_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_void_p]


def lstm_residual(
    x: torch.Tensor,
    weights: Sequence[torch.Tensor],
    layers: int,
    packed: Optional[Dict[str, torch.Tensor]],
) -> torch.Tensor:
    """lstm(x) + x (B, C, T) for x (B, C, T) float32. A CUDA tensor launches
    the kernel, once per ``MAX_ROWS`` rows (or raises); a CPU tensor takes
    the plain version with
    ``weights`` and ``layers``. ``packed`` is ``pack_weights(weights)``,
    made once by the caller, on x's device."""
    if x.device.type == "cpu":
        return lstm_residual_reference(x, weights, layers)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_residual: x on {x.device}; it takes a CUDA or a CPU tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"lstm_residual takes float32 (got {x.dtype})")
    if layers != LAYERS or x.ndim != 3 or x.shape[1] != HIDDEN:
        raise ValueError(
            f"the LSTM kernel runs {LAYERS} layers of {HIDDEN} on x (B, {HIDDEN}, T); got "
            f"{layers} layers and x {tuple(x.shape)}"
        )
    want = {"w_in0": (4 * HIDDEN, HIDDEN), "b_in0": (4 * HIDDEN,),
            "rec": (BLOCKS, 48, THREADS), "b1": (4 * HIDDEN,)}
    if packed is None or any(
        k not in packed or tuple(packed[k].shape) != s or packed[k].device != x.device
        or packed[k].dtype != torch.float32 or not packed[k].is_contiguous()
        for k, s in want.items()
    ):
        raise ValueError("lstm_residual: packed is not pack_weights(weights) on x's device")
    b, c, t = x.shape
    if b > MAX_ROWS:  # rows are independent: one launch a block of them
        return torch.cat([lstm_residual(x[i:i + MAX_ROWS], weights, layers, packed)
                          for i in range(0, b, MAX_ROWS)])
    x = x.contiguous()
    out = torch.empty_like(x)
    if b == 0 or t == 0:
        return out
    # layer 0's input gates of every frame, (T, B, 4H) in the packed order
    gx = torch.addmm(packed["b_in0"], x.permute(2, 0, 1).reshape(t * b, c), packed["w_in0"].t())
    hbuf = torch.empty((4, b, HIDDEN), dtype=torch.float32, device=x.device)
    count = torch.empty((1,), dtype=torch.int32, device=x.device)
    fn = _build.load("lstm", "lstm2_launch", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            gx.data_ptr(), x.data_ptr(), packed["rec"].data_ptr(), packed["b1"].data_ptr(),
            out.data_ptr(), hbuf.data_ptr(), count.data_ptr(), b, t, stream,
        )
    if err != 0:
        raise RuntimeError(f"lstm kernel launch failed: cudaError {err}")
    lstm_residual.launches += 1
    return out


lstm_residual.launches = 0
