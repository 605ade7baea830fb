"""Functional PyTorch EnCodec encoder (and RVQ), for the batch engine.

Re-implements the encode path of ``transformers`` ``EncodecModel`` (the
``facebook/encodec_24khz`` model) as plain functions over the param tree of
``encodec.weights``:

    raw 24 kHz audio (B, T)
      -> SEANet causal conv stack   (strides 2, 4, 5, 8 -> 75 Hz; resblocks
                                     with a k1 conv shortcut, ELU)
      -> 2-layer LSTM, skip added   (width 512, one step a frame)
      -> ELU + k7 conv              (512 -> 128)
      -> residual VQ                (K books of 1024 x 128, Euclidean)
      -> codes (B, K, T/320)

Every function runs on the device its input tensors lie on, in IEEE
float32 (``encode`` holds TF32 off for cuDNN's convolutions and cuBLAS's
matmuls); on the card the LSTM is one launch of a persistent kernel a
batch (``ops/cuda/lstm.py``), with its weights packed once
(``weights.prepare``), and the RVQ the RVQ kernel. On the CPU
the codes match ``EncodecModel.encode``'s for each utterance encoded
alone; tests/test_torch_encodec.py pins this.

Padding (``valid`` lengths). Every conv pads by reflection, as
transformers' ``EncodecConv1d`` does: ``k_eff - stride`` on the left and,
on the right, up to a whole stride. So, unlike Mimi's zero padding, an
utterance's padding depends on its own end, not on its bucket's. Masked
mode (default) keeps each row's columns past its valid length at zero
after every layer, and before each strided conv writes the standalone
right padding into them: ``x[L - 2 - j]`` at column ``L + j`` up to a whole
stride. A row no longer than the left pad is padded as ``_pad1d`` pads it:
by zeros on the right, which the masked columns already are. So each
utterance's codes are those of its standalone encode, whatever its batch
and bucket. ``masked=False`` encodes the batch as transformers encodes a
padded batch: reflection at the bucket's end.

Only the 24 kHz model's form is ported: causal convs, weight norm, no
input normalization and no chunking, in float32 at IEEE precision
(``check_modes``). There is no decoder and no streaming encoder.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision
from tokenize_audio_tpu_torch.core.contract import encode_epilogue, encode_prologue
from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
from tokenize_audio_tpu_torch.ops.cuda import lstm as lstm_ops
from tokenize_audio_tpu_torch.ops.cuda import rvq as rvq_ops
from tokenize_audio_tpu_torch.ranges import span

Params = Dict[str, Any]


def check_modes(cfg: EncodecConfig) -> None:
    """Refuse what the port does not run for EnCodec, with the reason."""
    if cfg.compute_dtype != "float32":
        raise ValueError(
            f"EnCodec runs in float32 only; compute_dtype {cfg.compute_dtype!r} "
            "(bfloat16) is not ported for it"
        )
    if cfg.matmul_precision != "highest":
        raise ValueError(
            f"EnCodec runs at IEEE float32 only; matmul_precision "
            f"{cfg.matmul_precision!r} (TF32) is not ported for it"
        )
    if (
        not cfg.use_causal_conv
        or cfg.norm_type != "weight_norm"
        or cfg.pad_mode != "reflect"
        or cfg.normalize
        or cfg.chunk_length_s is not None
    ):
        raise ValueError(
            "only the 24 kHz EnCodec's form is ported: causal, weight-normed, "
            "reflect-padded convs, no normalization and no chunking"
        )


def _mask(x: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, C, T) with each row's columns past its valid length at zero."""
    if valid is None:
        return x
    pos = torch.arange(x.shape[-1], device=x.device, dtype=torch.int32)[None, None, :]
    return torch.where(pos < valid[:, None, None], x, 0.0)


def _reflect_tails(xp: torch.Tensor, valid: torch.Tensor, left: int, stride: int) -> torch.Tensor:
    """Write each row's standalone right padding into ``xp``, the input
    already padded by ``left`` columns: ``x[L - 2 - j]`` at column
    ``L + j`` for ``j < ceil(L / stride) * stride - L``, where the row's
    length L exceeds the left pad; zeros otherwise (``_pad1d`` extends a
    row no longer than its pad with zeros first), which the masked columns
    hold already. ``xp`` has ``stride - 1`` spare columns on the right, so
    every row writes the same ``stride - 1`` columns without a bound."""
    b, c, _ = xp.shape
    j = torch.arange(stride - 1, device=xp.device)[None, :]
    n = valid.long()[:, None]
    extra = (-n) % stride
    src = (n - 2 - j).clamp(min=0) + left
    vals = torch.gather(xp, 2, src[:, None, :].expand(b, c, stride - 1))
    keep = (j < extra) & (n > left)
    vals = torch.where(keep[:, None, :], vals, 0.0)
    return xp.scatter_(2, (n + j + left)[:, None, :].expand(b, c, stride - 1), vals)


def causal_conv1d(
    x: torch.Tensor,
    valid: Optional[torch.Tensor],
    w: torch.Tensor,
    b: torch.Tensor,
    stride: int = 1,
    dilation: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """transformers ``EncodecConv1d`` (causal, reflect): x (B, I, T), w
    (O, I, K) folded -> ((B, O, T // stride), valid // stride rounded up).

    With ``valid``, x's columns past each row's length must be zero; the
    output's are zeroed, and a strided conv first writes each row's own
    right padding (``_reflect_tails``). T must divide by the stride
    (bucket lengths are whole frames, so every stage's does)."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    left = k_eff - stride
    t = x.shape[-1]
    if stride == 1:
        if left:
            x = F.pad(x, (left, 0), mode="reflect")
        new_valid = valid
    else:
        if t % stride != 0:
            raise ValueError(f"length {t} not divisible by stride {stride}")
        if w.shape[-1] != 2 * stride or dilation != 1:
            raise ValueError("a strided EnCodec conv has kernel 2 * stride and no dilation")
        # the right columns are never read by the conv: they only take the
        # writes _reflect_tails makes past a full row
        x = F.pad(x, (left, stride - 1), mode="reflect")
        new_valid = None
        if valid is not None:
            x = _reflect_tails(x, valid, left, stride)
            new_valid = (valid + stride - 1) // stride
    y = F.conv1d(x, w, b, stride=stride, dilation=dilation)
    return _mask(y, new_valid), new_valid


def seanet_encode(
    params: Params, cfg: EncodecConfig, x: torch.Tensor, valid: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, 1, T) audio -> (B, 512, T/320): the input conv and the four
    stages of transformers ``EncodecEncoder`` (each resblock
    ``shortcut(x) + conv1(elu(conv3(elu(x))))``, then ELU and the strided
    conv)."""
    x, valid = causal_conv1d(x, valid, params["enc_in"]["w"], params["enc_in"]["b"])
    for block, stride in zip(params["blocks"], cfg.encoder_strides):
        for j, res in enumerate(block["res"]):
            h, _ = causal_conv1d(
                F.elu(x), None, res["c1"]["w"], res["c1"]["b"],
                dilation=cfg.dilation_growth_rate**j,
            )
            h, _ = causal_conv1d(F.elu(h), None, res["c2"]["w"], res["c2"]["b"])
            sc = res.get("shortcut")
            if sc is not None:
                x, _ = causal_conv1d(x, None, sc["w"], sc["b"])
            x = _mask(x + h, valid)
        x, valid = causal_conv1d(F.elu(x), valid, block["down"]["w"], block["down"]["b"], stride=stride)
    return x, valid


def lstm_apply(params: Params, cfg: EncodecConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, T): ``lstm(x) + x`` over the frames, the
    unidirectional multi-layer LSTM of transformers ``EncodecLSTM`` from a
    zero state, one step a frame. Columns past a row's length come out
    nonzero; ``project`` masks them.

    On the card: one matrix product for layer 0's input gates and one
    launch of the persistent LSTM kernel (``ops/cuda/lstm.py``), which
    steps both layers through every frame with the weights ``prepare``
    packed. On the CPU: ``torch.lstm``."""
    return lstm_ops.lstm_residual(x, params["weights"], cfg.num_lstm_layers, params.get("packed"))


def project(
    params: Params, cfg: EncodecConfig, x: torch.Tensor, valid: Optional[torch.Tensor]
) -> torch.Tensor:
    """(B, 512, T) -> (B, 128, T): ELU and the final k7 conv."""
    y, _ = causal_conv1d(F.elu(_mask(x, valid)), None, params["enc_out"]["w"], params["enc_out"]["b"])
    return y


def rvq_encode(params: Params, x: torch.Tensor, num_quantizers: int) -> torch.Tensor:
    """(B, D, T) float32 -> int32 codes (B, K, T) of the first K books: the
    chained nearest-codeword search of transformers
    ``EncodecResidualVectorQuantizer.encode``, on the RVQ kernel
    (``ops/cuda/rvq.py``; plain PyTorch ops on the CPU) with the codebooks
    the engine packed once."""
    avail = params["embed"].shape[0]
    if not 1 <= num_quantizers <= avail:
        raise ValueError(f"num_quantizers {num_quantizers} not in 1..{avail} (the books kept)")
    b, d, t = x.shape
    flat = x.transpose(1, 2).reshape(b * t, d).contiguous()
    packed = params.get("packed")
    if packed is not None:
        packed = (packed[0][:num_quantizers], packed[1][:num_quantizers])
    codes = rvq_ops.rvq_quantize(flat, params["embed"][:num_quantizers].contiguous(), packed=packed)
    return codes.reshape(b, t, -1).transpose(1, 2)


@torch.no_grad()
def encode(
    params: Params,
    cfg: EncodecConfig,
    audio: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_quantizers: int = 8,
    masked: bool = True,
    code_dtype: str = "int32",
    resample: Optional[Tuple[int, int]] = None,
    transfer: str = "padded",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode (B, T) float32 or int16 24 kHz audio -> (codes, frame valid),
    on the device the audio and params lie on: the contract of
    ``mimi.model.encode``, which the engine relies on. ``valid`` are
    per-row int32 sample counts (None, or ``masked=False``, for
    transformers' pad-to-length semantics); a row of L samples has
    ``ceil(L / 320)`` frames. ``resample`` is the engine's fused on-device
    resample (rows at the source rate); ``transfer`` and ``code_dtype``
    shape the codes as ``mimi.model.encode``'s do (the same packing).

    While a profiler records, each stage runs in a
    ``tokenize_audio::encodec.*`` range (``ranges.span``): ``resample``
    (the fused one), ``seanet_encode``, ``lstm``, ``project``, ``rvq`` and
    ``pack``."""
    check_modes(cfg)
    with fp32_precision("ieee"):
        return _encode(
            params, cfg, audio, valid, num_quantizers, masked, code_dtype, resample, transfer
        )


def _encode(params, cfg, audio, valid, num_quantizers, masked, code_dtype, resample, transfer):
    audio, valid, frames = encode_prologue(
        "encodec", audio, valid, masked, resample, cfg.samples_per_frame
    )
    audio = audio.to(torch.float32)
    # the masked invariant from the first layer on: zero past each row's
    # length (the fused resample rings there)
    x = _mask(audio[:, None, :], valid)
    with span("encodec.seanet_encode"):
        x, valid = seanet_encode(params, cfg, x, valid)
    with span("encodec.lstm"):
        x = lstm_apply(params["lstm"], cfg, x)
    with span("encodec.project"):
        x = project(params, cfg, x, valid)
    with span("encodec.rvq"):
        codes = rvq_encode(params["rvq"], x, num_quantizers)
    return encode_epilogue("encodec", codes, valid, frames, num_quantizers, code_dtype, transfer)
