"""Plain PyTorch DAC encoder: the encode path of transformers ``DacModel``
(modeling_dac.py of transformers 4.57) for ``descript/dac_44khz``, one
utterance at a time, in IEEE float32 with TF32 off.

It reads the weights under their checkpoint names and imports nothing of
the program. The encoder's convs run inside ``encodec_ref.ieee_fp32``,
which sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False. Departures from the
published model, each on purpose:

- Weight norm is folded from the state dict's ``g`` and ``v`` by its
  formula, ``g * v / ||v||`` with the norm over all but the output
  channel (``encodec_ref.weight``), not by torch's ``_weight_norm`` op:
  the same weight to rounding.
- Snake is written as transformers writes it, on the whole tensor.
- Only the encoder is here: no decoder, no batching and no padding masks.
  An utterance is encoded alone, zero-padded at its end to a whole number
  of frames as DAC's ``preprocess`` pads it.
- The quantizer is not run to pick codes. ``code_gaps`` follows the codes
  it is given through the residual chain, in float64, and measures at
  every frame and book how far the given codeword's score lies below the
  best codeword's, relative to the mean amount by which the codebook's
  scores lie below the best.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

# IEEE float32 for the enclosed convs and matmuls (both TF32 switches off),
# and the weight-norm fold by its formula, as EnCodec's reference has them
from reference.encodec_ref import ieee_fp32, weight


def snake(sd: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor) -> torch.Tensor:
    alpha = sd[f"{prefix}.alpha"]
    return x + (alpha + 1e-9).reciprocal() * torch.sin(alpha * x).pow(2)


def hop(cfg: Dict) -> int:
    return math.prod(cfg["downsampling_ratios"])


@torch.no_grad()
def embeddings(sd: Dict[str, torch.Tensor], cfg: Dict, audio: torch.Tensor) -> torch.Tensor:
    """(T,) float32 audio at 44.1 kHz -> (hidden_size, ceil(T / hop)), the
    quantizer's input: ``DacEncoder`` on the audio zero-padded to whole
    frames."""

    def conv(name, h, **kw):
        return F.conv1d(h, weight(sd, name), sd[f"{name}.bias"], **kw)

    n = audio.shape[-1]
    x = F.pad(audio.reshape(1, 1, -1).float(), (0, -n % hop(cfg)))
    with ieee_fp32():
        x = conv("encoder.conv1", x, padding=3)
        for i, s in enumerate(cfg["downsampling_ratios"]):
            p = f"encoder.block.{i}"
            for j, d in zip((1, 2, 3), (1, 3, 9)):
                u = f"{p}.res_unit{j}"
                h = conv(f"{u}.conv1", snake(sd, f"{u}.snake1", x), padding=3 * d, dilation=d)
                x = x + conv(f"{u}.conv2", snake(sd, f"{u}.snake2", h))
            x = conv(f"{p}.conv1", snake(sd, f"{p}.snake1", x), stride=s, padding=math.ceil(s / 2))
        x = conv("encoder.conv2", snake(sd, "encoder.snake1", x), padding=1)
    return x[0]


@torch.no_grad()
def code_gaps(sd: Dict[str, torch.Tensor], cfg: Dict, emb: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Per book, the widest relative score gap of ``codes`` (K, frames) on
    the quantizer input ``emb`` (hidden, frames): 0 where every code is the
    reference's best codeword. A frame's gap is (best score - the code's
    score) / the mean over the codebook of (best score - score), with
    transformers' score ``-(|e|^2 - 2 e.c) + |c|^2`` of the normalized
    projection e and codeword c."""
    r = emb.double()
    out = []
    for k in range(codes.shape[0]):
        p = f"quantizer.quantizers.{k}"
        w_in, b_in = weight(sd, f"{p}.in_proj").double(), sd[f"{p}.in_proj.bias"].double()
        w_out, b_out = weight(sd, f"{p}.out_proj").double(), sd[f"{p}.out_proj.bias"].double()
        book = sd[f"{p}.codebook.weight"].double()
        e = F.normalize((w_in[:, :, 0] @ r + b_in[:, None]).T)
        c = F.normalize(book)
        score = -((e * e).sum(1, keepdim=True) - 2.0 * (e @ c.T)) + (c * c).sum(1)[None, :]
        best = score.max(dim=1).values
        code = codes[k].long()
        gap = (best - score.gather(1, code[:, None])[:, 0]) / (best[:, None] - score).mean(dim=1)
        out.append(gap.max() if gap.numel() else torch.zeros((), dtype=torch.float64, device=r.device))
        r = r - (w_out[:, :, 0] @ book[code].T + b_out[:, None])
    return torch.stack(out)
