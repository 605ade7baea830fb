"""Seeded random Mimi encoder weights, made on the device in one draw.

The weights are a state dict under the names of the published
``kyutai/mimi`` checkpoint (transformers ``MimiModel``), so the program
loads them through its own checkpoint converter, as it would the real
weights, and the plain reference reads the same names. Each tensor is a
slice of one ``torch.randn`` on a ``torch.Generator`` seeded from
``--seed``, scaled as the program's own ``random_params`` scales its draws:
conv and linear weights by ``1/sqrt(fan_in)``, biases and codebook entries
at unit scale, LayerNorm at identity and LayerScale at its initial value.
Only the encoder's tensors are made.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _shapes(cfg: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every encoder tensor; init is "fan_in",
    "unit", "one", "zero" or "layer_scale"."""
    out: List[Tuple[str, tuple, str]] = []
    nf, hs, ch = cfg["num_filters"], cfg["hidden_size"], cfg["audio_channels"]

    def conv(prefix, cout, cin, k, bias=True):
        out.append((f"{prefix}.weight", (cout, cin, k), "fan_in"))
        if bias:
            out.append((f"{prefix}.bias", (cout,), "unit"))

    conv("encoder.layers.0.conv", nf, ch, cfg["kernel_size"])
    idx, c = 1, nf
    for s in reversed(cfg["upsampling_ratios"]):
        hidden = c // cfg["compress"]
        for j in range(cfg["num_residual_layers"]):
            conv(f"encoder.layers.{idx + j}.block.1.conv", hidden, c, cfg["residual_kernel_size"])
            conv(f"encoder.layers.{idx + j}.block.3.conv", c, hidden, 1)
        down = idx + cfg["num_residual_layers"] + 1
        conv(f"encoder.layers.{down}.conv", 2 * c, c, 2 * s)
        idx, c = down + 1, 2 * c
    conv(f"encoder.layers.{idx + 1}.conv", hs, c, cfg["last_kernel_size"])
    inner = cfg["num_attention_heads"] * cfg["head_dim"]
    kv = cfg["num_key_value_heads"] * cfg["head_dim"]
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder_transformer.layers.{i}"
        out += [
            (f"{p}.input_layernorm.weight", (hs,), "one"),
            (f"{p}.input_layernorm.bias", (hs,), "zero"),
            (f"{p}.self_attn.q_proj.weight", (inner, hs), "fan_in"),
            (f"{p}.self_attn.k_proj.weight", (kv, hs), "fan_in"),
            (f"{p}.self_attn.v_proj.weight", (kv, hs), "fan_in"),
            (f"{p}.self_attn.o_proj.weight", (hs, inner), "fan_in"),
            (f"{p}.self_attn_layer_scale.scale", (hs,), "layer_scale"),
            (f"{p}.post_attention_layernorm.weight", (hs,), "one"),
            (f"{p}.post_attention_layernorm.bias", (hs,), "zero"),
            (f"{p}.mlp.fc1.weight", (cfg["intermediate_size"], hs), "fan_in"),
            (f"{p}.mlp.fc2.weight", (hs, cfg["intermediate_size"]), "fan_in"),
            (f"{p}.mlp_layer_scale.scale", (hs,), "layer_scale"),
        ]
    out.append(("downsample.conv.weight", (hs, hs, 4), "fan_in"))
    d, v = cfg["vector_quantization_hidden_dimension"], cfg["codebook_size"]
    n_sem = cfg["num_semantic_quantizers"]
    for head, books in (("semantic", n_sem), ("acoustic", cfg["num_quantizers"] - n_sem)):
        p = f"quantizer.{head}_residual_vector_quantizer"
        out.append((f"{p}.input_proj.weight", (d, hs, 1), "fan_in"))
        out.append((f"{p}.output_proj.weight", (hs, d, 1), "fan_in"))
        for i in range(books):
            out.append((f"{p}.layers.{i}.codebook.embed_sum", (v, d), "unit"))
            out.append((f"{p}.layers.{i}.codebook.cluster_usage", (v,), "one"))
    return out


def state_dict(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The encoder's float32 tensors under their checkpoint names, on
    ``device``, from one draw of a generator seeded with ``seed``."""
    specs = _shapes(cfg)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _ in specs]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    sd: Dict[str, torch.Tensor] = {}
    off = 0
    for (name, shape, init), n in zip(specs, sizes):
        t = flat[off: off + n].view(shape)
        off += n
        if init == "fan_in":
            t.mul_(1.0 / float(torch.Size(shape[1:]).numel()) ** 0.5)
        elif init == "one":
            t.fill_(1.0)
        elif init == "zero":
            t.zero_()
        elif init == "layer_scale":
            t.fill_(cfg["layer_scale_initial_scale"])
        sd[name] = t
    return sd
