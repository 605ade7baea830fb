"""HF checkpoint -> param tree conversion, and param tree -> torch tensors.

Consumes a ``transformers`` Mimi state dict — from a live ``MimiModel``, a
``.safetensors`` file (e.g. the published ``kyutai/mimi`` checkpoint), or a
plain ``{name: ndarray}`` mapping — and emits the numpy param tree (the same
layout and, for ``random_params``, the same draws as the JAX package's).
``params_to_torch`` then places it on a device for
``tokenize_audio_tpu_torch.mimi.model``. HF conv weights are (O, I, K),
which is already torch's ``conv1d`` layout: nothing is transposed. Codebook
embeddings are materialized as ``embed_sum / clamp(cluster_usage, eps)``
exactly like the lazy ``embed`` property (transformers
modeling_mimi.py:1198-1209).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import resolve_device
from tokenize_audio_tpu_torch.mimi.config import MimiConfig

_CODEBOOK_EPS = 1e-5


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _conv_weight(sd: Mapping[str, Any], prefix: str) -> np.ndarray:
    """Plain weight, or fold torch weight_norm parametrizations
    (w = g * v / ||v||, norm over all dims but 0) if the checkpoint kept
    them (MimiConv1d.apply_weight_norm, modeling_mimi.py:252-257)."""
    if f"{prefix}.weight" in sd:
        return _np(sd[f"{prefix}.weight"])
    g = _np(sd[f"{prefix}.parametrizations.weight.original0"])
    v = _np(sd[f"{prefix}.parametrizations.weight.original1"])
    norm = np.sqrt(np.sum(v * v, axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)


def _conv(sd: Mapping[str, Any], prefix: str, bias: bool = True) -> Dict[str, np.ndarray]:
    out = {"w": _conv_weight(sd, prefix)}
    out["b"] = _np(sd[f"{prefix}.bias"]) if bias else None
    return out


def _rvq(sd: Mapping[str, Any], prefix: str, n_books: int) -> Dict[str, np.ndarray]:
    embeds = []
    for i in range(n_books):
        base = f"{prefix}.layers.{i}.codebook"
        usage = _np(sd[f"{base}.cluster_usage"])
        embed_sum = _np(sd[f"{base}.embed_sum"])
        embeds.append(embed_sum / np.maximum(usage, _CODEBOOK_EPS)[:, None])
    return {
        "in_proj": _np(sd[f"{prefix}.input_proj.weight"])[:, :, 0],  # (D, hidden, 1)
        "out_proj": _np(sd[f"{prefix}.output_proj.weight"])[:, :, 0],
        "embed": np.stack(embeds, axis=0),  # (n_books, V, D)
    }


def _tfm_layer(sd: Mapping[str, Any], p: str) -> Dict[str, np.ndarray]:
    """One transformer layer's params from a state dict at prefix ``p``
    (shared by the encoder_transformer and decoder_transformer mappings)."""
    return {
        "ln1_w": _np(sd[f"{p}.input_layernorm.weight"]),
        "ln1_b": _np(sd[f"{p}.input_layernorm.bias"]),
        "q": _np(sd[f"{p}.self_attn.q_proj.weight"]),
        "k": _np(sd[f"{p}.self_attn.k_proj.weight"]),
        "v": _np(sd[f"{p}.self_attn.v_proj.weight"]),
        "o": _np(sd[f"{p}.self_attn.o_proj.weight"]),
        "ls1": _np(sd[f"{p}.self_attn_layer_scale.scale"]),
        "ln2_w": _np(sd[f"{p}.post_attention_layernorm.weight"]),
        "ln2_b": _np(sd[f"{p}.post_attention_layernorm.bias"]),
        "fc1": _np(sd[f"{p}.mlp.fc1.weight"]),
        "fc2": _np(sd[f"{p}.mlp.fc2.weight"]),
        "ls2": _np(sd[f"{p}.mlp_layer_scale.scale"]),
    }


def convert_hf_state_dict(
    sd: Mapping[str, Any], cfg: MimiConfig | None = None
) -> Dict[str, Any]:
    """Build the param tree from an HF Mimi state dict.

    Layer indices follow transformers MimiEncoder construction
    (modeling_mimi.py:444-478): conv_in at layers.0, then per downsample
    ratio ``num_residual_layers`` resnet blocks + ELU + strided conv, then a
    final ELU + conv_out.
    """
    cfg = cfg or MimiConfig()
    n_res = cfg.num_residual_layers
    params: Dict[str, Any] = {}
    params["enc_in"] = _conv(sd, "encoder.layers.0.conv")

    blocks = []
    idx = 1
    for _ in cfg.encoder_strides:  # strides are static config, not params
        res = []
        for j in range(n_res):
            res.append(
                {
                    "c1": _conv(sd, f"encoder.layers.{idx + j}.block.1.conv"),
                    "c2": _conv(sd, f"encoder.layers.{idx + j}.block.3.conv"),
                }
            )
        down_idx = idx + n_res + 1  # +1 skips the ELU module slot
        blocks.append({"res": res, "down": _conv(sd, f"encoder.layers.{down_idx}.conv")})
        idx = down_idx + 1
    params["blocks"] = blocks
    params["enc_out"] = _conv(sd, f"encoder.layers.{idx + 1}.conv")

    params["tfm"] = [
        _tfm_layer(sd, f"encoder_transformer.layers.{i}")
        for i in range(cfg.num_hidden_layers)
    ]

    params["downsample"] = {"w": _np(sd["downsample.conv.weight"])}
    params["rvq"] = {
        "semantic": _rvq(
            sd, "quantizer.semantic_residual_vector_quantizer", cfg.num_semantic_quantizers
        ),
        "acoustic": _rvq(
            sd, "quantizer.acoustic_residual_vector_quantizer", cfg.num_acoustic_quantizers
        ),
    }

    # --- decoder side (for codes -> audio round trips) -------------------
    if "upsample.conv.weight" in sd:
        params["upsample"] = {"w": _np(sd["upsample.conv.weight"])}
        params["dec_tfm"] = [
            _tfm_layer(sd, f"decoder_transformer.layers.{i}")
            for i in range(cfg.num_hidden_layers)
        ]
        # MimiDecoder layer indices (modeling_mimi.py:1150-1174): conv_in at 0,
        # then per ratio ELU / ConvTranspose / n_res resnets, final ELU + conv.
        dec: Dict[str, Any] = {"conv_in": _conv(sd, "decoder.layers.0.conv")}
        dblocks = []
        idx = 1
        for _ in cfg.upsampling_ratios:
            up_idx = idx + 1  # skip ELU slot
            up = {
                "w": _np(sd[f"decoder.layers.{up_idx}.conv.weight"]),
                "b": _np(sd[f"decoder.layers.{up_idx}.conv.bias"])
                if f"decoder.layers.{up_idx}.conv.bias" in sd
                else None,
            }
            res = []
            for j in range(n_res):
                base = up_idx + 1 + j
                res.append(
                    {
                        "c1": _conv(sd, f"decoder.layers.{base}.block.1.conv"),
                        "c2": _conv(sd, f"decoder.layers.{base}.block.3.conv"),
                    }
                )
            dblocks.append({"up": up, "res": res})
            idx = up_idx + n_res + 1  # next ELU slot
        dec["blocks"] = dblocks
        dec["conv_out"] = _conv(sd, f"decoder.layers.{idx + 1}.conv")
        params["dec"] = dec
    return params


def params_from_torch_model(model, cfg: MimiConfig | None = None) -> Dict[str, Any]:
    """Convert a live ``transformers.MimiModel`` (the parity oracle)."""
    if cfg is None and getattr(model, "config", None) is not None:
        cfg = config_from_hf(model.config)
    return convert_hf_state_dict(dict(model.state_dict()), cfg)


def params_from_safetensors(path: str, cfg: MimiConfig | None = None) -> Dict[str, Any]:
    """Convert a ``model.safetensors`` checkpoint file (e.g. kyutai/mimi)."""
    from safetensors.numpy import load_file

    return convert_hf_state_dict(load_file(path), cfg)


def random_params(cfg: MimiConfig | None = None, seed: int = 0) -> Dict[str, Any]:
    """Seeded random numpy param tree with the exact converter layout and the
    same ``np.random.default_rng`` draws as the JAX package — for benchmarks
    and smoke runs without a checkpoint in the loop."""
    cfg = cfg or MimiConfig()
    rng = np.random.default_rng(seed)

    def w(*shape, scale=None):
        scale = scale or 1.0 / np.sqrt(np.prod(shape[1:]) if len(shape) > 1 else 1.0)
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    nf, hs = cfg.num_filters, cfg.hidden_size
    params: Dict[str, Any] = {
        "enc_in": {"w": w(nf, cfg.audio_channels, cfg.kernel_size), "b": w(nf)}
    }
    blocks = []
    dim = nf
    for stride in cfg.encoder_strides:
        hidden = dim // cfg.compress
        res = [
            {
                "c1": {"w": w(hidden, dim, cfg.residual_kernel_size), "b": w(hidden)},
                "c2": {"w": w(dim, hidden, 1), "b": w(dim)},
            }
            for _ in range(cfg.num_residual_layers)
        ]
        blocks.append(
            {"res": res, "down": {"w": w(2 * dim, dim, 2 * stride), "b": w(2 * dim)}}
        )
        dim *= 2
    params["blocks"] = blocks
    params["enc_out"] = {"w": w(hs, dim, cfg.last_kernel_size), "b": w(hs)}

    nh, hd, inter = cfg.num_attention_heads, cfg.head_dim, cfg.intermediate_size

    def rand_tfm_layer():
        return {
            "ln1_w": np.ones(hs, np.float32),
            "ln1_b": np.zeros(hs, np.float32),
            "q": w(nh * hd, hs),
            "k": w(nh * hd, hs),
            "v": w(nh * hd, hs),
            "o": w(hs, nh * hd),
            "ls1": np.full(hs, cfg.layer_scale_initial_scale, np.float32),
            "ln2_w": np.ones(hs, np.float32),
            "ln2_b": np.zeros(hs, np.float32),
            "fc1": w(inter, hs),
            "fc2": w(hs, inter),
            "ls2": np.full(hs, cfg.layer_scale_initial_scale, np.float32),
        }

    params["tfm"] = [rand_tfm_layer() for _ in range(cfg.num_hidden_layers)]
    params["downsample"] = {"w": w(hs, hs, 4)}
    d = cfg.vector_quantization_hidden_dimension
    params["rvq"] = {
        "semantic": {
            "in_proj": w(d, hs),
            "out_proj": w(hs, d),
            "embed": w(cfg.num_semantic_quantizers, cfg.codebook_size, d, scale=1.0),
        },
        "acoustic": {
            "in_proj": w(d, hs),
            "out_proj": w(hs, d),
            "embed": w(cfg.num_acoustic_quantizers, cfg.codebook_size, d, scale=1.0),
        },
    }

    # decoder side (codes -> audio)
    # grouped ConvTranspose layout (in, out/groups, k); depthwise when
    # upsample_groups == hidden_size (the kyutai default)
    params["upsample"] = {"w": w(hs, hs // cfg.upsample_groups, 4)}
    params["dec_tfm"] = [rand_tfm_layer() for _ in range(cfg.num_hidden_layers)]
    scaling = 2 ** len(cfg.upsampling_ratios)
    cur = scaling * nf
    dec: Dict[str, Any] = {"conv_in": {"w": w(cur, hs, cfg.kernel_size), "b": w(cur)}}
    dblocks = []
    for r in cfg.upsampling_ratios:
        nxt = cur // 2
        res = [
            {
                "c1": {"w": w(nxt // cfg.compress, nxt, cfg.residual_kernel_size), "b": w(nxt // cfg.compress)},
                "c2": {"w": w(nxt, nxt // cfg.compress, 1), "b": w(nxt)},
            }
            for _ in range(cfg.num_residual_layers)
        ]
        dblocks.append({"up": {"w": w(cur, nxt, 2 * r), "b": w(nxt)}, "res": res})
        cur = nxt
    dec["blocks"] = dblocks
    dec["conv_out"] = {"w": w(cfg.audio_channels, cur, cfg.last_kernel_size), "b": w(cfg.audio_channels)}
    params["dec"] = dec
    return params


def _hf_rope_theta(hf_config) -> float:
    # transformers 4.x keeps ``rope_theta``; 5.x moved it into
    # ``rope_parameters`` (configuration_mimi.py, MimiConfig.rope_parameters)
    theta = getattr(hf_config, "rope_theta", None)
    return theta if theta is not None else hf_config.rope_parameters["rope_theta"]


def config_from_hf(hf_config) -> MimiConfig:
    """Map a ``transformers.MimiConfig`` onto ours."""
    return MimiConfig(
        sampling_rate=hf_config.sampling_rate,
        audio_channels=hf_config.audio_channels,
        hidden_size=hf_config.hidden_size,
        num_filters=hf_config.num_filters,
        num_residual_layers=hf_config.num_residual_layers,
        upsampling_ratios=tuple(hf_config.upsampling_ratios),
        kernel_size=hf_config.kernel_size,
        last_kernel_size=hf_config.last_kernel_size,
        residual_kernel_size=hf_config.residual_kernel_size,
        dilation_growth_rate=hf_config.dilation_growth_rate,
        use_causal_conv=hf_config.use_causal_conv,
        pad_mode=hf_config.pad_mode,
        compress=hf_config.compress,
        codebook_size=hf_config.codebook_size,
        codebook_dim=hf_config.codebook_dim,
        num_quantizers=hf_config.num_quantizers,
        num_semantic_quantizers=hf_config.num_semantic_quantizers,
        vector_quantization_hidden_dimension=hf_config.vector_quantization_hidden_dimension,
        upsample_groups=hf_config.upsample_groups,
        num_hidden_layers=hf_config.num_hidden_layers,
        intermediate_size=hf_config.intermediate_size,
        num_attention_heads=hf_config.num_attention_heads,
        num_key_value_heads=hf_config.num_key_value_heads,
        head_dim=hf_config.head_dim,
        hidden_act=hf_config.hidden_act,
        max_position_embeddings=hf_config.max_position_embeddings,
        norm_eps=hf_config.norm_eps,
        rope_theta=_hf_rope_theta(hf_config),
        sliding_window=hf_config.sliding_window,
        layer_scale_initial_scale=hf_config.layer_scale_initial_scale,
    )


def params_to_torch(params: Any, device: Optional[str | torch.device] = None) -> Any:
    """Map a param tree (numpy arrays or tensors as leaves) onto float
    tensors on ``device`` (CUDA unless the caller names another). The tree
    structure and layouts are kept as they are."""
    dev = resolve_device(device)

    def conv(a):
        if a is None:
            return None
        if isinstance(a, dict):
            return {k: conv(v) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return [conv(v) for v in a]
        if isinstance(a, torch.Tensor):
            return a.to(dev)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return conv(params)
