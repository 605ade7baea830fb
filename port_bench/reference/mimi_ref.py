"""Plain PyTorch Mimi encoder: the encode path of transformers
``MimiModel`` (modeling_mimi.py of transformers 4.57), one utterance at a
time, in IEEE float32 with TF32 off.

It reads the weights under their checkpoint names and imports nothing of
the program. Departures from the published model, each on purpose:

- The transformer attends with a full causal mask, as the one-shot
  ``MimiModel.encode`` of transformers 4.57 does; kyutai's own code keeps
  a 250-frame sliding window, which the configuration's
  ``use_sliding_window: false`` turns off.
- Only the encoder is here: no decoder, no streaming caches, no batching
  and no padding masks. An utterance is encoded alone at its own length.
- The quantizer is not run to pick codes. ``code_gaps`` follows the codes
  it is given through each head's residual chain and measures, at every
  frame and book, how far the given code's squared distance lies above
  the nearest codeword's, in float64, relative to the mean distance over
  the codebook.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def ieee_fp32():
    """Both TF32 switches off for the enclosed convolutions and matmuls."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv1d(x, w, b, stride: int = 1, dilation: int = 1, pad_mode: str = "constant"):
    """``MimiConv1d`` with causal padding: ``k_eff - stride`` on the left,
    and on the right what makes the length a whole number of strides."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    extra = (-x.shape[-1]) % stride
    mode = "replicate" if pad_mode == "replicate" else "constant"
    x = F.pad(x, (k_eff - stride, extra), mode=mode)
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def seanet(sd: Dict[str, torch.Tensor], cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """(1, 1, T) audio -> (1, hidden, frames at 25 Hz), ``MimiEncoder``."""

    def conv(name, h, **kw):
        return conv1d(h, sd[f"{name}.weight"], sd.get(f"{name}.bias"), pad_mode=cfg["pad_mode"], **kw)

    x = conv("encoder.layers.0.conv", x)
    idx = 1
    n_res = cfg["num_residual_layers"]
    for s in reversed(cfg["upsampling_ratios"]):
        for j in range(n_res):
            p = f"encoder.layers.{idx + j}.block"
            h = conv(f"{p}.1.conv", F.elu(x), dilation=cfg["dilation_growth_rate"] ** j)
            h = conv(f"{p}.3.conv", F.elu(h))
            x = x + h
        down = idx + n_res + 1
        x = conv(f"encoder.layers.{down}.conv", F.elu(x), stride=s)
        idx = down + 1
    return conv(f"encoder.layers.{idx + 1}.conv", F.elu(x))


def transformer(sd: Dict[str, torch.Tensor], cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    """(1, T, C) -> (1, T, C), ``MimiTransformerModel`` with eager
    attention: pre-LayerNorm, RoPE, float32 softmax under an additive
    ``finfo.min`` causal mask, LayerScale residuals, erf GELU."""
    _, t, c = h.shape
    nh, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    dev = h.device
    inv_freq = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, hd, 2, dtype=torch.int64, device=dev).float() / hd))
    freqs = torch.arange(t, device=dev).float()[:, None] * inv_freq[None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = emb.cos()[None, None], emb.sin()[None, None]
    i = torch.arange(t, device=dev)
    mask = torch.where(i[None, :] <= i[:, None], 0.0, torch.finfo(torch.float32).min)

    def rot(x):
        return torch.cat([-x[..., hd // 2:], x[..., : hd // 2]], dim=-1)

    for n in range(cfg["num_hidden_layers"]):
        p = f"encoder_transformer.layers.{n}"
        x = F.layer_norm(h, (c,), sd[f"{p}.input_layernorm.weight"], sd[f"{p}.input_layernorm.bias"], cfg["norm_eps"])
        q = F.linear(x, sd[f"{p}.self_attn.q_proj.weight"]).view(1, t, nh, hd).transpose(1, 2)
        k = F.linear(x, sd[f"{p}.self_attn.k_proj.weight"]).view(1, t, nkv, hd).transpose(1, 2)
        v = F.linear(x, sd[f"{p}.self_attn.v_proj.weight"]).view(1, t, nkv, hd).transpose(1, 2)
        q = q * cos + rot(q) * sin
        k = k * cos + rot(k) * sin
        k = k.repeat_interleave(nh // nkv, dim=1)
        v = v.repeat_interleave(nh // nkv, dim=1)
        aw = torch.matmul(q, k.transpose(2, 3)) / math.sqrt(hd) + mask
        aw = F.softmax(aw, dim=-1, dtype=torch.float32)
        att = torch.matmul(aw, v).transpose(1, 2).reshape(1, t, nh * hd)
        h = h + sd[f"{p}.self_attn_layer_scale.scale"] * F.linear(att, sd[f"{p}.self_attn.o_proj.weight"])
        x = F.layer_norm(h, (c,), sd[f"{p}.post_attention_layernorm.weight"],
                         sd[f"{p}.post_attention_layernorm.bias"], cfg["norm_eps"])
        x = F.linear(F.gelu(F.linear(x, sd[f"{p}.mlp.fc1.weight"])), sd[f"{p}.mlp.fc2.weight"])
        h = h + sd[f"{p}.mlp_layer_scale.scale"] * x
    return h


@torch.no_grad()
def embeddings(sd: Dict[str, torch.Tensor], cfg: Dict, audio: torch.Tensor) -> torch.Tensor:
    """(T,) float32 audio at 24 kHz -> (hidden, frames at 12.5 Hz), the
    quantizer's input: SEANet, transformer, replicate-padded stride-2
    downsample."""
    with ieee_fp32():
        x = seanet(sd, cfg, audio.reshape(1, 1, -1).float())
        x = transformer(sd, cfg, x.transpose(1, 2)).transpose(1, 2)
        x = conv1d(x, sd["downsample.conv.weight"], None, stride=2, pad_mode="replicate")
    return x[0]


def codebooks(sd: Dict[str, torch.Tensor], head: str, n: int) -> torch.Tensor:
    """(n, V, D) codewords of a head's first ``n`` books:
    ``embed_sum / clamp(cluster_usage, 1e-5)``."""
    p = f"quantizer.{head}_residual_vector_quantizer.layers"
    return torch.stack([
        sd[f"{p}.{i}.codebook.embed_sum"]
        / sd[f"{p}.{i}.codebook.cluster_usage"].clamp(min=1e-5)[:, None]
        for i in range(n)
    ])


@torch.no_grad()
def code_gaps(sd: Dict[str, torch.Tensor], cfg: Dict, emb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per book, the widest relative distance gap of ``codes`` (K, frames)
    on the quantizer input ``emb`` (hidden, frames): 0 where every code is
    the reference's nearest codeword."""
    n_sem = cfg["num_semantic_quantizers"]
    k_all = codes.shape[0]
    out = []
    for head, lo, hi in (("semantic", 0, min(n_sem, k_all)), ("acoustic", n_sem, k_all)):
        if hi <= lo:
            continue
        w = sd[f"quantizer.{head}_residual_vector_quantizer.input_proj.weight"]
        with ieee_fp32():
            proj = F.conv1d(emb[None], w)[0].T  # (frames, D)
        r = proj.double()
        for k, e in zip(range(lo, hi), codebooks(sd, head, hi - lo).double()):
            d = (r * r).sum(-1, keepdim=True) - 2.0 * (r @ e.T) + (e * e).sum(-1)[None, :]
            c = codes[k].long()
            gap = (d.gather(1, c[:, None])[:, 0] - d.min(dim=1).values) / d.mean(dim=1)
            out.append(gap.max() if gap.numel() else torch.zeros((), dtype=torch.float64, device=d.device))
            r = r - e[c]
    return torch.stack(out)
