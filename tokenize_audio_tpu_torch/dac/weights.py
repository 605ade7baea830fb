"""HF DAC checkpoint -> the encoder's param tree.

Consumes a ``transformers`` ``DacModel`` state dict (a live model's, a
``.safetensors`` file such as the published ``descript/dac_44khz``
checkpoint, or a plain ``{name: tensor or ndarray}`` mapping) and keeps the
encoder and quantizer. A weight-normed conv is folded as
``encodec.weights.conv_weight`` folds EnCodec's, under either of torch's
namings (``weight_g`` / ``weight_v`` or
``parametrizations.weight.original0`` / ``original1``); a plain ``weight``
is taken as it is.

The tree (``torch`` float32 tensors on the CPU; ``prepare`` puts it on a
device and adds what the encode reads there):

    enc_in            {"w", "b"}                          input k7 conv
    blocks[i]         {"res": [{"snake1", "c1", "snake2", "c2"}] x 3,
                       "snake", "down"}                   the strided conv
    snake_out         {"alpha"}                           the last Snake
    enc_out           {"w", "b"}                          final k3 conv
    rvq[k]            {"in", "out", "codebook"}           per book

where a Snake is ``{"alpha": (1, C, 1)}`` and ``prepare`` adds its
``"inv"``, ``(alpha + 1e-9).reciprocal()``, and a book's normalized
codebook and squared norms.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.dac.config import DacConfig
from tokenize_audio_tpu_torch.encodec.weights import _t, conv_weight

UNITS = 3  # residual units a block, at dilations 1, 3 and 9


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"w": conv_weight(sd, prefix), "b": _t(sd[f"{prefix}.bias"])}


def _snake(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"alpha": _t(sd[f"{prefix}.alpha"])}


def convert_hf_state_dict(sd: Mapping[str, Any], cfg: Optional[DacConfig] = None) -> Dict[str, Any]:
    """The encoder's param tree from an HF DAC state dict, by the module
    names of transformers ``DacEncoder`` and ``DacResidualVectorQuantize``."""
    cfg = cfg or DacConfig()
    blocks = []
    for i in range(len(cfg.downsampling_ratios)):
        p = f"encoder.block.{i}"
        res = [
            {
                "snake1": _snake(sd, f"{p}.res_unit{j}.snake1"),
                "c1": _conv(sd, f"{p}.res_unit{j}.conv1"),
                "snake2": _snake(sd, f"{p}.res_unit{j}.snake2"),
                "c2": _conv(sd, f"{p}.res_unit{j}.conv2"),
            }
            for j in range(1, UNITS + 1)
        ]
        blocks.append({"res": res, "snake": _snake(sd, f"{p}.snake1"), "down": _conv(sd, f"{p}.conv1")})
    rvq = [
        {
            "in": _conv(sd, f"quantizer.quantizers.{k}.in_proj"),
            "out": _conv(sd, f"quantizer.quantizers.{k}.out_proj"),
            "codebook": _t(sd[f"quantizer.quantizers.{k}.codebook.weight"]),
        }
        for k in range(cfg.n_codebooks)
    ]
    return {
        "enc_in": _conv(sd, "encoder.conv1"),
        "blocks": blocks,
        "snake_out": _snake(sd, "encoder.snake1"),
        "enc_out": _conv(sd, "encoder.conv2"),
        "rvq": rvq,
    }


def params_from_safetensors(path: str, cfg: Optional[DacConfig] = None) -> Dict[str, Any]:
    from safetensors.torch import load_file

    return convert_hf_state_dict(load_file(path), cfg)


def prepare(params: Dict[str, Any], cfg: DacConfig, num_codebooks: int, device) -> Dict[str, Any]:
    """The tree the engine keeps on ``device``: the encoder's weights; each
    Snake's ``inv``, the reciprocal transformers' ``Snake1d`` takes of
    ``alpha + 1e-9`` at every call; and the first ``num_codebooks`` books,
    each with its raw codebook (``codebook``, which the output projection
    reads), its copy normalized by the ``F.normalize`` call transformers'
    ``decode_latents`` makes (``normed``) and that copy's squared norms as
    a row (``norm2``)."""
    if not 1 <= num_codebooks <= cfg.n_codebooks:
        raise ValueError(f"num_codebooks {num_codebooks} not in 1..{cfg.n_codebooks} for this DAC")

    def to(tree):
        if isinstance(tree, dict):
            out = {k: to(v) for k, v in tree.items()}
            if "alpha" in out:
                out["inv"] = (out["alpha"] + 1e-9).reciprocal()
            return out
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return _t(tree).to(device)

    out = to({k: params[k] for k in ("enc_in", "blocks", "snake_out", "enc_out")})
    books = []
    for book in params["rvq"][:num_codebooks]:
        b = to(book)
        b["normed"] = F.normalize(b["codebook"])
        b["norm2"] = b["normed"].pow(2).sum(1, keepdim=True).t()
        books.append(b)
    out["rvq"] = books
    return out
