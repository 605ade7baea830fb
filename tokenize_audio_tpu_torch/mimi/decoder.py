"""Functional PyTorch Mimi decoder: codes -> waveform.

Completes the codec round trip used by the reference's ``str_to_audio``
(librispeech-mimi/utils.py:72-81). Mirrors transformers' decode path
(modeling_mimi.py:1595-1661):

    codes (B, K, T) -> split-RVQ decode (embedding sums + output projs)
      -> depthwise ConvTranspose 12.5 -> 25 Hz (groups=hidden, causal trim)
      -> 8-layer decoder transformer (same architecture as the encoder's)
      -> SEANet decoder (ConvTranspose upsampling x [8,6,5,4], resnets)
      -> audio (B, T*1920)

IEEE fp32 like the encoder (``ieee_fp32``: TF32 off for the convs, the
transposed convs and the transformer's matmuls); parity with HF and the JAX
package is tolerance-based (a float waveform, not discrete codes). The
decoder has no hand-written kernel: its convs are PyTorch calls.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import ieee_fp32
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.model import _elu, causal_conv1d, transformer_apply

Params = Dict[str, Any]


def conv_transpose1d(
    x: torch.Tensor,
    wt: torch.Tensor,
    stride: int,
    groups: int = 1,
    bias: Optional[torch.Tensor] = None,
    trim_right_ratio: float = 1.0,
) -> torch.Tensor:
    """MimiConvTranspose1d (modeling_mimi.py:344-399): torch transpose conv
    then causal trim — padding_total = k - stride trimmed from the right
    (ceil(pt * trim_right_ratio)) and the rest from the left.

    ``wt`` is the HF layout (in_ch, out_ch // groups, K), which is
    ``F.conv_transpose1d``'s own.
    """
    k = wt.shape[-1]
    y = F.conv_transpose1d(x, wt, bias, stride=stride, groups=groups)
    pad_total = k - stride
    pad_right = math.ceil(pad_total * trim_right_ratio)
    pad_left = pad_total - pad_right
    return y[:, :, pad_left : y.shape[-1] - pad_right]


def split_rvq_decode(params: Params, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, K, T) -> embeddings (B, hidden, T)
    (MimiSplitResidualVectorQuantizer.decode, modeling_mimi.py:1347-1356)."""
    sem, ac = params["semantic"], params["acoustic"]
    n_sem = sem["embed"].shape[0]
    codes = codes.long()

    def rvq(embeds, out_proj, c):  # c (B, n, T)
        acc = embeds[0][c[:, 0]]  # (B, T, D)
        for i in range(1, c.shape[1]):
            acc = acc + embeds[i][c[:, i]]
        # out_proj (hidden, D): HF's 1x1 output_proj conv
        return F.conv1d(acc.transpose(1, 2), out_proj[:, :, None])

    out = rvq(sem["embed"], sem["out_proj"], codes[:, :n_sem])
    if codes.shape[1] > n_sem:
        out = out + rvq(ac["embed"], ac["out_proj"], codes[:, n_sem:])
    return out


def seanet_decode(params: Params, cfg: MimiConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, hidden, T25) -> (B, 1, T_samples). MimiDecoder
    (modeling_mimi.py:1150-1180)."""
    pad = cfg.pad_mode
    x, _ = causal_conv1d(x, None, params["conv_in"]["w"], params["conv_in"]["b"], pad_mode=pad)
    for block, stride in zip(params["blocks"], cfg.upsampling_ratios):
        x = _elu(x)
        x = conv_transpose1d(x, block["up"]["w"], stride=stride, bias=block["up"]["b"])
        for j, res in enumerate(block["res"]):
            residual = x
            h = _elu(x)
            h, _ = causal_conv1d(
                h, None, res["c1"]["w"], res["c1"]["b"],
                dilation=cfg.dilation_growth_rate**j, pad_mode=pad,
            )
            h = _elu(h)
            h, _ = causal_conv1d(h, None, res["c2"]["w"], res["c2"]["b"], pad_mode=pad)
            x = residual + h
    x = _elu(x)
    x, _ = causal_conv1d(x, None, params["conv_out"]["w"], params["conv_out"]["b"], pad_mode=pad)
    return x


@torch.no_grad()
def decode(params: Params, cfg: MimiConfig, codes: torch.Tensor) -> torch.Tensor:
    """codes (B, K, T) integer -> audio (B, T * samples_per_frame) float32,
    on the device the codes and params lie on.

    Equivalent of HF ``model.decode(codes).audio_values`` (the consumer-side
    helper str_to_audio, librispeech-mimi/utils.py:72-81)."""
    with ieee_fp32():
        emb = split_rvq_decode(params["rvq"], codes)
        emb = conv_transpose1d(emb, params["upsample"]["w"], stride=2, groups=cfg.upsample_groups)
        h = transformer_apply(params["dec_tfm"], cfg, emb.transpose(1, 2))
        audio = seanet_decode(params["dec"], cfg, h.transpose(1, 2))
    return audio[:, 0, :]
