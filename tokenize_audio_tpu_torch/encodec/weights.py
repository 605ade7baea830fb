"""HF EnCodec checkpoint -> the encoder's param tree.

Consumes a ``transformers`` ``EncodecModel`` state dict (a live model's, a
``.safetensors`` file such as the published ``facebook/encodec_24khz``
checkpoint, or a plain ``{name: tensor or ndarray}`` mapping) and keeps the
encoder and quantizer. Every conv of the checkpoint is weight-normed, under
one of two namings: the legacy ``weight_g`` / ``weight_v`` of
``nn.utils.weight_norm`` (the published files) or the
``parametrizations.weight.original0`` / ``original1`` of
``nn.utils.parametrizations.weight_norm`` (what transformers builds on a
current torch). Both fold here to one weight, ``w = g * v / ||v||`` with
the norm per output channel, by the op both of torch's forms call
(``torch._weight_norm``), so the folded weight is the one transformers
convolves with. A plain ``weight`` is taken as it is.

The tree (``torch`` float32 tensors on the CPU; ``prepare`` puts it on a
device):

    enc_in            {"w", "b"}                       input conv
    blocks[i]         {"res": [{"c1", "c2", "shortcut"}], "down"}
    lstm              {"weights": [w_ih_l0, w_hh_l0, b_ih_l0, b_hh_l0, ...]}
    enc_out           {"w", "b"}                       final conv
    rvq               {"embed": (books, V, D)}
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from tokenize_audio_tpu_torch.encodec.config import EncodecConfig
from tokenize_audio_tpu_torch.ops.cuda.rvq import pack_codebooks


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def conv_weight(sd: Mapping[str, Any], prefix: str) -> torch.Tensor:
    """The conv weight at ``prefix``, weight norm folded if the checkpoint
    keeps it (either naming)."""
    if f"{prefix}.weight" in sd:
        return _t(sd[f"{prefix}.weight"])
    for g_name, v_name in (
        ("weight_g", "weight_v"),
        ("parametrizations.weight.original0", "parametrizations.weight.original1"),
    ):
        if f"{prefix}.{g_name}" in sd:
            g, v = _t(sd[f"{prefix}.{g_name}"]), _t(sd[f"{prefix}.{v_name}"])
            return torch._weight_norm(v, g, 0)
    raise KeyError(f"no weight for {prefix} in the state dict")


def _conv(sd: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    return {"w": conv_weight(sd, prefix), "b": _t(sd[f"{prefix}.bias"])}


def lstm_names(cfg: EncodecConfig) -> List[str]:
    """The LSTM's tensors in the order ``torch.lstm`` takes them."""
    return [
        f"{kind}_l{layer}"
        for layer in range(cfg.num_lstm_layers)
        for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
    ]


def convert_hf_state_dict(sd: Mapping[str, Any], cfg: Optional[EncodecConfig] = None) -> Dict[str, Any]:
    """The encoder's param tree from an HF EnCodec state dict. Layer indices
    follow transformers ``EncodecEncoder``: the input conv at layers.0,
    then per stride ``num_residual_layers`` resnet blocks, an ELU and the
    strided conv, then the LSTM, an ELU and the final conv."""
    cfg = cfg or EncodecConfig()
    n_res = cfg.num_residual_layers
    params: Dict[str, Any] = {"enc_in": _conv(sd, "encoder.layers.0.conv")}
    blocks = []
    idx = 1
    for _ in cfg.encoder_strides:
        res = []
        for j in range(n_res):
            p = f"encoder.layers.{idx + j}"
            r = {"c1": _conv(sd, f"{p}.block.1.conv"), "c2": _conv(sd, f"{p}.block.3.conv")}
            if cfg.use_conv_shortcut:
                r["shortcut"] = _conv(sd, f"{p}.shortcut.conv")
            res.append(r)
        down = idx + n_res + 1  # +1 skips the ELU's slot
        blocks.append({"res": res, "down": _conv(sd, f"encoder.layers.{down}.conv")})
        idx = down + 1
    params["blocks"] = blocks
    params["lstm"] = {
        "weights": [_t(sd[f"encoder.layers.{idx}.lstm.{n}"]) for n in lstm_names(cfg)]
    }
    params["enc_out"] = _conv(sd, f"encoder.layers.{idx + 2}.conv")
    params["rvq"] = {
        "embed": torch.stack([
            _t(sd[f"quantizer.layers.{i}.codebook.embed"]) for i in range(cfg.num_quantizers)
        ])
    }
    return params


def params_from_safetensors(path: str, cfg: Optional[EncodecConfig] = None) -> Dict[str, Any]:
    from safetensors.torch import load_file

    return convert_hf_state_dict(load_file(path), cfg)


def _flat_lstm(weights: List[torch.Tensor], cfg: EncodecConfig, device: torch.device) -> List[torch.Tensor]:
    """The LSTM's tensors on ``device`` as cuDNN keeps them: views into one
    buffer, flattened once here (``nn.LSTM.flatten_parameters``), so no
    call copies them into cuDNN's layout again. On the CPU, the tensors."""
    h = cfg.lstm_size
    # made on the meta device and moved empty, so building it draws nothing
    # from the global generator
    lstm = torch.nn.LSTM(h, h, cfg.num_lstm_layers, device="meta").to_empty(device=device)
    with torch.no_grad():
        for name, w in zip(lstm_names(cfg), weights):
            getattr(lstm, name).copy_(w)
    lstm.flatten_parameters()
    return [getattr(lstm, name).detach() for name in lstm_names(cfg)]


def prepare(params: Dict[str, Any], cfg: EncodecConfig, num_codebooks: int, device) -> Dict[str, Any]:
    """The tree the engine keeps on ``device``: the first ``num_codebooks``
    books, packed once for the RVQ kernel (``"packed"``), and the LSTM
    flattened once for cuDNN."""
    if not 1 <= num_codebooks <= cfg.num_quantizers:
        raise ValueError(
            f"num_codebooks {num_codebooks} not in 1..{cfg.num_quantizers} for this EnCodec"
        )

    def to(tree):
        if isinstance(tree, dict):
            return {k: to(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v) for v in tree]
        return _t(tree).to(device)

    out = to({k: params[k] for k in ("enc_in", "blocks", "enc_out")})
    out["lstm"] = {"weights": _flat_lstm([_t(w) for w in params["lstm"]["weights"]], cfg, device)}
    embed = _t(params["rvq"]["embed"])[:num_codebooks].to(device).contiguous()
    out["rvq"] = {"embed": embed, "packed": pack_codebooks(embed)}
    return out
