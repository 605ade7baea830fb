"""Plain PyTorch EnCodec encoder: the encode path of transformers
``EncodecModel`` (modeling_encodec.py of transformers 4.57) for
``facebook/encodec_24khz``, one utterance at a time, in IEEE float32 with
TF32 off.

It reads the weights under their checkpoint names and imports nothing of
the program. Departures from the published model, each on purpose:

- Weight norm is folded from the state dict's ``g`` and ``v`` by its
  formula, ``g * v / ||v||`` with the norm over all but the output
  channel, not by torch's ``_weight_norm`` op: the same weight to
  rounding.
- The LSTM is written out as its cell equations (the input products of a
  layer as one matmul over all frames, then a Python loop over the frames
  with ``i, f, g, o`` in torch's gate order), not ``nn.LSTM``, so it shares
  neither cuDNN's nor oneDNN's recurrence with the program.
- Only the encoder is here: no decoder, no normalization (the 24 kHz
  model has none), no chunking, no batching and no padding masks. An
  utterance is encoded alone at its own length, with transformers'
  ``_pad1d`` reflect padding (zero-extended first where the utterance is
  no longer than the pad).
- The quantizer is not run to pick codes. ``code_gaps`` follows the codes
  it is given through the residual chain and measures, at every frame and
  book, how far the given code's squared distance lies above the nearest
  codeword's, in float64, relative to the mean distance over the codebook.
"""

from __future__ import annotations

import contextlib
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


def weight(sd: Dict[str, torch.Tensor], prefix: str) -> torch.Tensor:
    """A conv's weight, ``g * v / ||v||`` where the state dict keeps weight
    norm under either of torch's namings."""
    if f"{prefix}.weight" in sd:
        return sd[f"{prefix}.weight"]
    for g_name, v_name in (("weight_g", "weight_v"),
                           ("parametrizations.weight.original0", "parametrizations.weight.original1")):
        if f"{prefix}.{g_name}" in sd:
            g, v = sd[f"{prefix}.{g_name}"], sd[f"{prefix}.{v_name}"]
            return g * v / v.norm(dim=(1, 2), keepdim=True)
    raise KeyError(prefix)


def pad1d(x: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """transformers ``EncodecConv1d._pad1d`` in reflect mode: a signal no
    longer than the larger pad is first extended by zeros, and the
    extension cut off again after the reflection."""
    n = x.shape[-1]
    most = max(left, right)
    extra = most - n + 1 if n <= most else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (left, right), mode="reflect")
    return y[..., : y.shape[-1] - extra]


def conv1d(x, w, b, stride: int = 1, dilation: int = 1):
    """``EncodecConv1d`` with causal padding: ``k_eff - stride`` on the
    left, and on the right what makes the length a whole number of
    strides."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    extra = (-x.shape[-1]) % stride
    return F.conv1d(pad1d(x, k_eff - stride, extra), w, b, stride=stride, dilation=dilation)


def lstm(sd: Dict[str, torch.Tensor], prefix: str, layers: int, x: torch.Tensor) -> torch.Tensor:
    """(T, C) -> (T, C): a unidirectional LSTM from a zero state, layer by
    layer, frame by frame."""
    h_seq = x
    for n in range(layers):
        w_ih, w_hh = sd[f"{prefix}.weight_ih_l{n}"], sd[f"{prefix}.weight_hh_l{n}"]
        gx = h_seq @ w_ih.T + sd[f"{prefix}.bias_ih_l{n}"] + sd[f"{prefix}.bias_hh_l{n}"]
        size = w_hh.shape[1]
        h = x.new_zeros(size)
        c = x.new_zeros(size)
        out = []
        for t in range(gx.shape[0]):
            i, f, g, o = (gx[t] + w_hh @ h).chunk(4)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out.append(h)
        h_seq = torch.stack(out) if out else gx[:, :size]
    return h_seq


def _strides(cfg: Dict) -> list:
    return list(reversed(cfg["upsampling_ratios"]))


@torch.no_grad()
def embeddings(sd: Dict[str, torch.Tensor], cfg: Dict, audio: torch.Tensor) -> torch.Tensor:
    """(T,) float32 audio at 24 kHz -> (codebook_dim, frames at 75 Hz), the
    quantizer's input: ``EncodecEncoder`` (SEANet, LSTM with its skip, ELU
    and the last conv)."""

    def conv(name, h, **kw):
        return conv1d(h, weight(sd, name), sd[f"{name}.bias"], **kw)

    with ieee_fp32():
        x = conv("encoder.layers.0.conv", audio.reshape(1, 1, -1).float())
        idx = 1
        n_res = cfg["num_residual_layers"]
        for s in _strides(cfg):
            for j in range(n_res):
                p = f"encoder.layers.{idx + j}"
                h = conv(f"{p}.block.1.conv", F.elu(x), dilation=cfg["dilation_growth_rate"] ** j)
                h = conv(f"{p}.block.3.conv", F.elu(h))
                sc = conv(f"{p}.shortcut.conv", x) if cfg["use_conv_shortcut"] else x
                x = sc + h
            down = idx + n_res + 1
            x = conv(f"encoder.layers.{down}.conv", F.elu(x), stride=s)
            idx = down + 1
        seq = x[0].T  # (frames, C)
        x = (lstm(sd, f"encoder.layers.{idx}.lstm", cfg["num_lstm_layers"], seq) + seq).T[None]
        x = conv(f"encoder.layers.{idx + 2}.conv", F.elu(x))
    return x[0]


def codebooks(sd: Dict[str, torch.Tensor], n: int) -> torch.Tensor:
    """(n, V, D) codewords of the first ``n`` books."""
    return torch.stack([sd[f"quantizer.layers.{i}.codebook.embed"] for i in range(n)])


@torch.no_grad()
def code_gaps(sd: Dict[str, torch.Tensor], cfg: Dict, emb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per book, the widest relative distance gap of ``codes`` (K, frames)
    on the quantizer input ``emb`` (D, frames): 0 where every code is the
    reference's nearest codeword."""
    r = emb.T.double()
    out = []
    for k, e in enumerate(codebooks(sd, codes.shape[0]).double()):
        d = (r * r).sum(-1, keepdim=True) - 2.0 * (r @ e.T) + (e * e).sum(-1)[None, :]
        c = codes[k].long()
        gap = (d.gather(1, c[:, None])[:, 0] - d.min(dim=1).values) / d.mean(dim=1)
        out.append(gap.max() if gap.numel() else torch.zeros((), dtype=torch.float64, device=d.device))
        r = r - e[c]
    return torch.stack(out)
