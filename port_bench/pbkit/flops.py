"""Operations and bytes of the Mimi encode, from the configuration's
shapes and each row's valid length. Frozen: later changes to the program
do not change what a row of audio costs.

Operations count a multiply and an add as two. A causal conv of kernel
``k`` from ``cin`` to ``cout`` channels costs ``2 * cout * cin * k`` per
output sample; a strided conv has ``ceil(n / stride)`` outputs for ``n``
inputs (HF ``MimiConv1d`` pads the input up to a whole stride). Attention
counts the causal pairs only, ``t * (t + 1) / 2`` per head, for the score
and the value products: what the inputs need, not what an implementation
that computes the masked half spends. The RVQ counts the input projection
of each head it uses and ``2 * D * V`` per frame and book for the
distances. Bytes count each input byte read once, each output byte
written once and the weights once per call.

At the published widths one second of 24 kHz audio costs 4.032 GFLOP in
the SEANet, about 1.26 in the transformer, 0.026 in the downsample and
1.05 M per frame and book in the RVQ (12.5 frames a second).
"""

from __future__ import annotations

from typing import Dict, Iterable


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def strides(cfg: Dict) -> list:
    return list(reversed(cfg["upsampling_ratios"]))


def seanet_flops(cfg: Dict, n: int) -> float:
    """One row of ``n`` valid samples through the SEANet encoder."""
    nf = cfg["num_filters"]
    total = 2.0 * nf * cfg["audio_channels"] * cfg["kernel_size"] * n
    c, length = nf, n
    for s in strides(cfg):
        hidden = c // cfg["compress"]
        total += 2.0 * hidden * c * cfg["residual_kernel_size"] * length
        total += 2.0 * c * hidden * length
        length = _ceil(length, s)
        total += 2.0 * (2 * c) * c * (2 * s) * length
        c *= 2
    total += 2.0 * cfg["hidden_size"] * c * cfg["last_kernel_size"] * length
    return total


def seanet_frames(cfg: Dict, n: int) -> int:
    """25 Hz frames of a row of ``n`` samples."""
    for s in strides(cfg):
        n = _ceil(n, s)
    return n


def transformer_flops(cfg: Dict, t: int) -> float:
    hs, nh, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["head_dim"]
    proj = 2.0 * t * hs * nh * hd * 4  # q, k, v, o
    mlp = 2.0 * t * hs * cfg["intermediate_size"] * 2
    attn = 2.0 * 2 * nh * hd * (t * (t + 1) / 2)
    return cfg["num_hidden_layers"] * (proj + mlp + attn)


def downsample_flops(cfg: Dict, t: int) -> float:
    hs = cfg["hidden_size"]
    return 2.0 * hs * hs * 4 * _ceil(t, 2)


def rvq_flops(cfg: Dict, frames: int, books: int) -> float:
    d, v, hs = cfg["vector_quantization_hidden_dimension"], cfg["codebook_size"], cfg["hidden_size"]
    heads = 1 + (books > cfg["num_semantic_quantizers"])
    return 2.0 * frames * hs * d * heads + 2.0 * frames * d * v * books


def model_flops(cfg: Dict, n: int, books: int) -> float:
    """One row of ``n`` valid 24 kHz samples through the whole encode."""
    t = seanet_frames(cfg, n)
    return (
        seanet_flops(cfg, n)
        + transformer_flops(cfg, t)
        + downsample_flops(cfg, t)
        + rvq_flops(cfg, _ceil(t, 2), books)
    )


def _seanet_weight_count(cfg: Dict) -> int:
    nf = cfg["num_filters"]
    w = nf * cfg["audio_channels"] * cfg["kernel_size"] + nf
    c = nf
    for s in strides(cfg):
        h = c // cfg["compress"]
        w += h * c * cfg["residual_kernel_size"] + h + c * h + c
        w += 2 * c * c * 2 * s + 2 * c
        c *= 2
    return w + cfg["hidden_size"] * c * cfg["last_kernel_size"] + cfg["hidden_size"]


def seanet_call(cfg: Dict, rows: Iterable[int]) -> tuple:
    """(operations, bytes) of one ``seanet_encode`` call on the valid
    columns of ``rows`` (valid samples per row)."""
    rows = list(rows)
    flop = sum(seanet_flops(cfg, n) for n in rows)
    out = sum(seanet_frames(cfg, n) for n in rows) * cfg["hidden_size"]
    nbytes = 4.0 * (sum(rows) + out + _seanet_weight_count(cfg))
    return flop, nbytes


def rvq_call(cfg: Dict, rows: Iterable[int], books: int) -> tuple:
    """(operations, bytes) of one ``split_rvq_encode`` call: the input
    projections and the chained distance search of ``books`` books."""
    frames = sum(_ceil(seanet_frames(cfg, n), 2) for n in rows)
    d, v, hs = cfg["vector_quantization_hidden_dimension"], cfg["codebook_size"], cfg["hidden_size"]
    heads = 1 + (books > cfg["num_semantic_quantizers"])
    nbytes = 4.0 * (frames * hs + heads * hs * d + books * v * (d + 1) + frames * books)
    return rvq_flops(cfg, frames, books), nbytes


def per_audio_second(cfg: Dict, books: int, seconds: float = 1.0, rate: int = 24_000) -> float:
    """Operations per second of audio for one row of ``seconds``."""
    n = int(round(seconds * rate))
    return model_flops(cfg, n, books) / seconds
