"""Functional PyTorch DAC encoder (and its quantizer), for the batch engine.

Re-implements the encode path of ``transformers`` ``DacModel`` (the
``descript/dac_44khz`` model) as plain functions over the param tree of
``dac.weights``:

    raw 44.1 kHz audio (B, T), zero-padded to whole 512-sample frames
      -> k7 conv                    (1 -> 64)
      -> 4 blocks, C = 64 .. 512    (3 residual units at dilations 1, 3, 9:
                                     x + k1(Snake(k7 dilated(Snake(x))));
                                     Snake, then a conv of kernel 2s and
                                     stride s to 2C, s = 2, 4, 8, 8)
      -> Snake + k3 conv            (1024 -> 1024)
      -> 9 factorized books         (a k1 projection to 8, cosine search
                                     over 1024 codewords, the codeword
                                     projected back and subtracted)
      -> codes (B, K, T/512)

Every conv pads with zeros on both sides ("same"), as transformers'
``nn.Conv1d(padding=...)`` does: the encoder is non-causal. Every function
runs on the device its input tensors lie on, in IEEE float32 (``encode``
holds TF32 off for cuDNN's convolutions and cuBLAS's matmuls). Snake is
transformers' expression ``x + (alpha + 1e-9)^-1 * sin(alpha * x)^2``
evaluated in its order, each pass writing the one buffer it allocates.
On the CPU the codes match ``DacModel.encode``'s for each utterance
encoded alone; tests/test_torch_dac.py pins this.

Padding (``valid`` lengths). A row of n samples is encoded as DAC's own
``preprocess`` pads it: with zeros up to ceil(n / 512) * 512 samples, so
every stage's length is exact and the row has ceil(n / 512) frames. In a
batch the convs' biases make the columns past a row's end nonzero, and the
non-causal kernels read them back into its last columns (each block's
units look 3 + 9 + 27 positions ahead). So the encode keeps each row's
columns past its whole-frame length at zero after the input conv, every
residual unit and every strided conv (``_mask``), which the standalone
encode's zero padding reads there; Snake(0) = 0 keeps them zero through
the activations. Each utterance's codes are then those of its standalone
encode, whatever its batch and bucket. Unmasked mode would not keep that,
and is refused.

Only the encoder and quantizer are ported, in float32 at IEEE precision
(``check_modes``): no decoder, no streaming encoder, no mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision
from tokenize_audio_tpu_torch.core.contract import encode_epilogue, encode_prologue
from tokenize_audio_tpu_torch.dac.config import DacConfig
from tokenize_audio_tpu_torch.ranges import span

Params = Dict[str, Any]

DILATIONS = (1, 3, 9)

# Snake calls since import (29 a batch at the published four blocks: 7 a
# block and the last one); a wrapper put on ``snake`` does not hide them
launches = 0


def check_modes(cfg: DacConfig) -> None:
    """Refuse what the port does not run for DAC, with the reason."""
    if cfg.compute_dtype != "float32":
        raise ValueError(
            f"DAC runs in float32 only; compute_dtype {cfg.compute_dtype!r} "
            "(bfloat16) is not ported for it"
        )
    if cfg.matmul_precision != "highest":
        raise ValueError(
            f"DAC runs at IEEE float32 only; matmul_precision "
            f"{cfg.matmul_precision!r} (TF32) is not ported for it"
        )


def _past(valid: Optional[torch.Tensor], t: int) -> Optional[torch.Tensor]:
    """(B, 1, t) True at each row's columns past its valid length."""
    if valid is None:
        return None
    pos = torch.arange(t, device=valid.device, dtype=valid.dtype)
    return (pos[None, :] >= valid[:, None])[:, None, :]


def _mask(x: torch.Tensor, past: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, C, T) with the columns ``past`` marks zeroed, in place."""
    return x if past is None else x.masked_fill_(past, 0.0)


def snake(x: torch.Tensor, p: Params) -> torch.Tensor:
    """transformers ``Snake1d``: ``x + inv * sin(alpha * x) ** 2`` with
    ``inv = (alpha + 1e-9) ** -1`` (``weights.prepare``), per channel, in
    one new buffer."""
    global launches
    launches += 1
    with span("dac.snake"):
        y = x * p["alpha"]
        return y.sin_().pow_(2).mul_(p["inv"]).add_(x)


def encoder(
    params: Params, cfg: DacConfig, x: torch.Tensor, valid: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, 1, T) audio, T a whole number of frames, zero past each row's
    ``valid`` whole-frame length -> ((B, hidden, T / hop), frame valid):
    transformers ``DacEncoder``, each row's columns past its length kept
    at zero after every conv that writes them."""
    past = _past(valid, x.shape[-1])
    x = F.conv1d(x, params["enc_in"]["w"], params["enc_in"]["b"], padding=3)
    _mask(x, past)
    for block, stride in zip(params["blocks"], cfg.downsampling_ratios):
        for unit, d in zip(block["res"], DILATIONS):
            h = F.conv1d(snake(x, unit["snake1"]), unit["c1"]["w"], unit["c1"]["b"],
                         padding=3 * d, dilation=d)
            h = F.conv1d(snake(h, unit["snake2"]), unit["c2"]["w"], unit["c2"]["b"])
            x = _mask(h.add_(x), past)
        x = F.conv1d(snake(x, block["snake"]), block["down"]["w"], block["down"]["b"],
                     stride=stride, padding=(stride + 1) // 2)
        if valid is not None:
            valid = valid // stride
            past = _past(valid, x.shape[-1])
        _mask(x, past)
    y = F.conv1d(snake(x, params["snake_out"]), params["enc_out"]["w"], params["enc_out"]["b"],
                 padding=1)
    return y, valid


def rvq_encode(books: list, x: torch.Tensor, num_quantizers: int) -> torch.Tensor:
    """(B, hidden, T) float32 -> int64 codes (B, K, T) of the first K books:
    transformers ``DacResidualVectorQuantize`` in eval. Per book the
    residual is projected to the codebook's width, normalized, and scored
    against the normalized codebook by ``decode_latents``' expression,
    ``-(|e|^2 - 2 e.c) + |c|^2``, the first largest score winning; the raw
    codeword goes through the straight-through sum and the output
    projection, and is subtracted from the residual (not after the last
    book, whose residual nothing reads)."""
    if not 1 <= num_quantizers <= len(books):
        raise ValueError(f"num_quantizers {num_quantizers} not in 1..{len(books)} (the books kept)")
    b, _, t = x.shape
    residual = x
    codes = []
    for k, book in enumerate(books[:num_quantizers]):
        latents = F.conv1d(residual, book["in"]["w"], book["in"]["b"])
        enc = F.normalize(latents.permute(0, 2, 1).reshape(b * t, latents.shape[1]))
        l2 = enc.pow(2).sum(1, keepdim=True)
        dist = -(l2 - 2 * enc @ book["normed"].t()) + book["norm2"]
        idx = dist.max(1)[1].reshape(b, t)
        codes.append(idx)
        if k + 1 < num_quantizers:
            q = F.embedding(idx, book["codebook"]).transpose(1, 2)
            q = latents + (q - latents)
            residual = residual - F.conv1d(q, book["out"]["w"], book["out"]["b"])
    return torch.stack(codes, dim=1)


@torch.no_grad()
def encode(
    params: Params,
    cfg: DacConfig,
    audio: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_quantizers: int = 9,
    masked: bool = True,
    code_dtype: str = "int32",
    resample: Optional[Tuple[int, int]] = None,
    transfer: str = "padded",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode (B, T) float32 or int16 44.1 kHz audio -> (codes, frame
    valid), on the device the audio and params lie on: the contract of
    ``mimi.model.encode``, which the engine relies on. ``valid`` are
    per-row sample counts (None: every row is T long); a row of n samples
    has ``ceil(n / 512)`` frames. ``masked=False`` is refused: DAC's
    non-causal convs would read the batch's padding into a row's codes.
    ``resample`` is the engine's fused on-device resample; ``transfer``
    and ``code_dtype`` shape the codes as ``mimi.model.encode``'s do.

    While a profiler records, the stages run in ``tokenize_audio::dac.*``
    ranges (``ranges.span``): ``resample`` (the fused one), ``encoder``,
    ``snake`` (each of its 29 Snakes), ``rvq`` and ``pack``."""
    check_modes(cfg)
    if not masked:
        raise ValueError(
            "DAC encodes masked batches only: its non-causal convs read a row's padding "
            "into its last frames unless each layer masks it"
        )
    with fp32_precision("ieee"):
        return _encode(params, cfg, audio, valid, num_quantizers, code_dtype, resample, transfer)


def _encode(params, cfg, audio, valid, num_quantizers, code_dtype, resample, transfer):
    audio, valid, _ = encode_prologue("dac", audio, valid, True, resample, cfg.samples_per_frame)
    hop = cfg.hop_length
    x = audio.to(torch.float32)[:, None, :]
    # zero past each row's length (the fused resample rings there), then
    # up to whole frames of zeros, as DAC's preprocess pads a row
    past = _past(valid, x.shape[-1])
    if past is not None:
        x = x.masked_fill(past, 0.0)
    extra = -x.shape[-1] % hop
    if extra:
        x = F.pad(x, (0, extra))
    if valid is not None:
        valid = (valid + hop - 1) // hop * hop
    # looked up at each call, so a wrapper put on a name sees every call
    with span("dac.encoder"):
        x, valid = encoder(params, cfg, x, valid)
    with span("dac.rvq"):
        codes = rvq_encode(params["rvq"], x, num_quantizers)
    return encode_epilogue("dac", codes, valid, None, num_quantizers, code_dtype, transfer)
