"""Functional PyTorch Mimi encoder (and RVQ).

Re-implements the encode path of ``transformers`` Mimi (the model the
reference drives at yodas2-mimi/process_shard.py:185-274) as plain functions
over a param tree of tensors (``weights.params_to_torch``):

    raw 24 kHz audio (B, T)
      -> SEANet causal conv stack   (strides 4,5,6,8 -> 25 Hz, ELU, resnets)
      -> 8-layer RoPE transformer   (d=512, 8 heads, LayerScale, full causal)
      -> stride-2 causal conv       (25 -> 12.5 Hz, replicate padding)
      -> split residual VQ          (1 semantic + N acoustic, codebook 2048)
      -> codes (B, K, T/1920)

Every function runs on the device its input tensors lie on. Exactness
contract: in IEEE fp32 (TF32 off, see ``encode``) the emitted code indices
on the CPU match HF ``MimiModel.encode`` and the JAX package's ``encode`` at
every codebook level; tests/test_torch_model.py pins this.

Padding semantics (``valid`` lengths): HF encodes a padded batch with *no*
masking between layers, so an utterance's codes depend on its batch's pad
length. Masked mode (default) tracks per-row valid lengths and re-creates
each layer's exact standalone right-padding (zeros for constant-pad convs,
replicated edge for the 25->12.5 Hz downsample), making codes for any
utterance bit-identical to its standalone unpadded encode regardless of
bucket or batch. ``masked=False`` reproduces HF pad-to-length batch
semantics instead.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision, ieee_fp32
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.ops.cuda import rvq as rvq_ops
from tokenize_audio_tpu_torch.ops.cuda import seanet as seanet_ops
from tokenize_audio_tpu_torch.ranges import span

Params = Dict[str, Any]
_BACKENDS = ("kernel", "torch")


# f32 matmul/conv precision per MimiConfig.matmul_precision, as the mode of
# config.fp32_precision. On an NVIDIA GPU, XLA runs f32 dots and convs at
# Precision.HIGH and DEFAULT in TF32, so both map to "tf32"; "highest" is
# IEEE fp32. On the CPU the TF32 flags change nothing, as XLA:CPU ignores
# precision.
_PRECISIONS = {"highest": "ieee", "high": "tf32", "default": "tf32"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def matmul_precision(cfg: MimiConfig) -> str:
    """The fp32 mode ("ieee" or "tf32") of the SEANet convs, transformer
    matmuls and downsample (MimiConfig.matmul_precision). The resample, the
    quantizer in_proj and the RVQ stay IEEE regardless: they are
    argmin-adjacent."""
    try:
        return _PRECISIONS[cfg.matmul_precision]
    except KeyError:
        raise ValueError(
            f"MimiConfig.matmul_precision {cfg.matmul_precision!r} not in "
            f"{sorted(_PRECISIONS)}"
        ) from None


def compute_dtype(cfg: MimiConfig) -> torch.dtype:
    """The dtype of the SEANet, transformer and downsample compute."""
    try:
        return _DTYPES[cfg.compute_dtype]
    except KeyError:
        raise ValueError(
            f"MimiConfig.compute_dtype {cfg.compute_dtype!r} not in {sorted(_DTYPES)}"
        ) from None


def _check_modes(cfg: MimiConfig) -> None:
    matmul_precision(cfg)
    compute_dtype(cfg)
    for name in ("rvq_backend", "seanet_backend"):
        if getattr(cfg, name) not in _BACKENDS:
            raise ValueError(
                f"MimiConfig.{name} {getattr(cfg, name)!r} not in {_BACKENDS}"
            )


def _cast_tree(tree, dtype: torch.dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(dtype)
    return tree


def cast_for_compute(params: Params, cfg: MimiConfig) -> Params:
    """The encode params with the conv, transformer and downsample weights
    in the compute dtype (the RVQ stays f32); the tree itself in float32
    mode, and a no-op on a tree already cast."""
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return params
    return {
        k: _cast_tree(v, dt) if k in ("enc_in", "blocks", "enc_out", "tfm", "downsample") else v
        for k, v in params.items()
    }


def _positions(t: int, device: torch.device) -> torch.Tensor:
    return torch.arange(t, device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Causal conv primitive
# ---------------------------------------------------------------------------

def causal_conv1d(
    x: torch.Tensor,
    valid: Optional[torch.Tensor],
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int = 1,
    dilation: int = 1,
    pad_mode: str = "constant",
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal Conv1d matching transformers MimiConv1d (modeling_mimi.py:204-341).

    x: (B, C, T); w: (O, I, K) in HF layout; returns ((B, O, T//stride), new valid).

    Left pad = (K_eff - stride); standalone right "extra" pad is re-created
    per row from ``valid`` (see module docstring). T must be divisible by
    stride (bucket lengths are multiples of samples_per_frame, so every
    intermediate length divides evenly).
    """
    k_eff = (w.shape[-1] - 1) * dilation + 1
    pad_total = k_eff - stride
    t = x.shape[-1]
    if t % stride != 0:
        raise ValueError(f"length {t} not divisible by stride {stride}")

    new_valid = None
    if valid is not None:
        new_valid = (valid + stride - 1) // stride  # ceil
        if stride > 1 and pad_mode == "replicate":
            # standalone extra right padding replicates the last valid sample
            extra = new_valid * stride - valid  # in [0, stride)
            pos = _positions(t, x.device)[None, None, :]
            v = valid[:, None, None]
            idx = (v - 1).clamp(min=0).expand(-1, x.shape[1], 1).long()
            last = torch.gather(x, 2, idx)  # (B, C, 1)
            x = torch.where((pos >= v) & (pos < v + extra[:, None, None]), last, x)
        # constant-pad layers need nothing: the masked invariant keeps
        # positions >= valid at exactly the zeros standalone padding uses.

    if pad_mode == "constant":
        x = F.pad(x, (pad_total, 0))
    elif pad_mode == "replicate":
        x = torch.cat([x[:, :, :1].expand(-1, -1, pad_total), x], dim=2)
    else:
        raise ValueError(f"unsupported pad_mode {pad_mode}")

    y = F.conv1d(x, w, b, stride=stride, dilation=dilation)
    if new_valid is not None:
        pos = _positions(y.shape[-1], y.device)[None, None, :]
        y = torch.where(pos < new_valid[:, None, None], y, 0.0)
    return y, new_valid


def _elu(x: torch.Tensor) -> torch.Tensor:
    # nn.ELU(alpha=1.0); ELU(0) == 0 preserves the masked invariant.
    return torch.where(x > 0, x, torch.expm1(x))


# ---------------------------------------------------------------------------
# SEANet encoder
# ---------------------------------------------------------------------------

def seanet_encode(
    params: Params, cfg: MimiConfig, x: torch.Tensor, valid: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, 1, T) audio -> (B, hidden, T/prod(ratios)) at 25 Hz.
    Mirrors transformers MimiEncoder (modeling_mimi.py:444-486)."""
    x, valid = causal_conv1d(
        x, valid, params["enc_in"]["w"], params["enc_in"]["b"], pad_mode=cfg.pad_mode
    )
    use_fused = (
        cfg.seanet_backend == "kernel"
        and cfg.num_residual_layers == 1
        and cfg.residual_kernel_size == 3
        and cfg.compress == 2
        and cfg.pad_mode == "constant"
        and x.dtype == torch.float32
    )
    for block, stride in zip(params["blocks"], cfg.encoder_strides):
        if use_fused:
            res = block["res"][0]
            v_in = (
                valid
                if valid is not None
                else torch.full((x.shape[0],), x.shape[-1], dtype=torch.int32, device=x.device)
            )
            x, new_v = seanet_ops.seanet_stage(
                x,
                v_in,
                res["c1"]["w"],
                res["c1"]["b"],
                res["c2"]["w"],
                res["c2"]["b"],
                block["down"]["w"],
                block["down"]["b"],
                stride,
                packed=res.get("packed"),
            )
            if valid is not None:
                valid = new_v
            continue
        for j, res in enumerate(block["res"]):
            residual = x
            h = _elu(x)
            h, _ = causal_conv1d(
                h,
                valid,
                res["c1"]["w"],
                res["c1"]["b"],
                dilation=cfg.dilation_growth_rate**j,
                pad_mode=cfg.pad_mode,
            )
            h = _elu(h)
            h, _ = causal_conv1d(
                h, valid, res["c2"]["w"], res["c2"]["b"], pad_mode=cfg.pad_mode
            )
            x = residual + h
        x = _elu(x)
        x, valid = causal_conv1d(
            x, valid, block["down"]["w"], block["down"]["b"], stride=stride,
            pad_mode=cfg.pad_mode,
        )
    x = _elu(x)
    x, valid = causal_conv1d(
        x, valid, params["enc_out"]["w"], params["enc_out"]["b"], pad_mode=cfg.pad_mode
    )
    return x, valid


# ---------------------------------------------------------------------------
# Transformer bottleneck
# ---------------------------------------------------------------------------

def _rope_at(cfg: MimiConfig, pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin at absolute positions, matching MimiRotaryEmbedding
    (modeling_mimi.py:505-538): inv_freq over even dims, emb = [freqs, freqs]."""
    hd = cfg.head_dim
    inv_freq = 1.0 / (
        cfg.rope_theta
        ** (torch.arange(0, hd, 2, dtype=torch.int64, device=pos.device).float() / hd)
    )
    freqs = pos.float()[:, None] * inv_freq[None, :]  # (T, hd/2)
    emb = torch.cat([freqs, freqs], dim=-1)  # (T, hd)
    return emb.cos(), emb.sin()


def _rope_tables(cfg: MimiConfig, t: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    return _rope_at(cfg, torch.arange(t, device=device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm computed in f32, returned in x's dtype (bf16 mode)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)
    return y.to(x.dtype)


def _attention_mask(cfg: MimiConfig, t: int, device: torch.device) -> torch.Tensor:
    """Additive float mask. Full causal by default (what HF actually builds —
    see MimiConfig.use_sliding_window note); optional sliding window."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    allowed = j <= i
    if cfg.use_sliding_window:
        allowed &= j > i - cfg.sliding_window
    neg = torch.finfo(torch.float32).min  # HF uses finfo.min, not -inf
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, neg)


def transformer_apply(
    params: Params, cfg: MimiConfig, h: torch.Tensor, group=None, graphs=None
) -> torch.Tensor:
    """(B, T, C) -> (B, T, C). Mirrors MimiTransformerModel with eager
    attention (modeling_mimi.py:608-703, 922-994): pre-LN, RoPE, fp32
    softmax, LayerScale residuals, bias-free projections, erf GELU MLP.
    In h's dtype, with LayerNorm, RoPE and softmax in f32 (bf16 mode).

    Tensor parallel with ``group`` (a mesh's model group) and the layer
    slices of ``parallel.mesh.shard_params_tp``: each rank runs its own
    heads and MLP block, and the outputs of the row-parallel ``o`` and
    ``fc2`` are summed over the group (in the compute dtype) before their
    LayerScale residual, where XLA puts the psum under the JAX package's
    sharding.

    ``graphs``, a ``graphs.TransformerGraphs`` of a caller whose params
    stay put, replays the stack from a CUDA graph per input shape where it
    engages (on its CUDA device, without ``group``, with no gradient); the
    body is the same either way."""
    if graphs is not None and graphs.engages(h, group):
        return graphs(lambda x: _transformer_stack(params, cfg, x, None), h)
    return _transformer_stack(params, cfg, h, group)


def _transformer_stack(params: Params, cfg: MimiConfig, h: torch.Tensor, group) -> torch.Tensor:
    b, t, _ = h.shape
    hd = cfg.head_dim
    scale = 1.0 / math.sqrt(cfg.head_dim)
    dt = h.dtype
    # cos/sin stay f32: the rotation products compute in f32 (bf16 * f32
    # promotes) and are narrowed back, as the JAX package does
    cos, sin = _rope_tables(cfg, t, h.device)
    cos_b = cos[None, None, :, :]
    sin_b = sin[None, None, :, :]
    mask = _attention_mask(cfg, t, h.device)[None, None, :, :].to(dt)

    for lp in params:
        nh = lp["q"].shape[0] // hd  # this rank's heads under tensor parallelism
        if group is None and nh != cfg.num_attention_heads:
            raise ValueError(
                f"a layer with {nh} of {cfg.num_attention_heads} heads is a "
                "tensor-parallel slice: pass its mesh's model group"
            )
        x = _layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q = F.linear(x, lp["q"]).view(b, t, nh, hd).transpose(1, 2)
        k = F.linear(x, lp["k"]).view(b, t, nh, hd).transpose(1, 2)
        v = F.linear(x, lp["v"]).view(b, t, nh, hd).transpose(1, 2)
        q = (q * cos_b + _rotate_half(q) * sin_b).to(dt)
        k = (k * cos_b + _rotate_half(k) * sin_b).to(dt)
        aw = torch.matmul(q, k.transpose(2, 3)) * scale
        aw = aw + mask
        # fp32 softmax then back to the compute dtype (MimiAttention:684-685)
        aw = F.softmax(aw, dim=-1, dtype=torch.float32).to(dt)
        att = torch.matmul(aw, v)
        att = att.transpose(1, 2).contiguous().view(b, t, nh * hd)
        att = F.linear(att, lp["o"])
        if group is not None:
            dist.all_reduce(att, group=group)
        h = h + lp["ls1"] * att

        x = _layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        x = F.linear(x, lp["fc1"])
        x = F.gelu(x)
        x = F.linear(x, lp["fc2"])
        if group is not None:
            dist.all_reduce(x, group=group)
        h = h + lp["ls2"] * x
    return h


# ---------------------------------------------------------------------------
# Residual vector quantization
# ---------------------------------------------------------------------------

def rvq_quantize(residual: torch.Tensor, embeds: torch.Tensor) -> torch.Tensor:
    """Chained nearest-centroid search in plain PyTorch ops.

    residual: (B, T, D); embeds: (n_books, V, D) — already normalized
    embed_sum/cluster_usage (MimiEuclideanCodebook.embed property,
    modeling_mimi.py:1198-1209). Returns int32 codes (B, n_books, T).
    Distance = ||x||^2 - 2 x.e + ||e||^2 with first-index argmin ties
    (ops/cuda/rvq.py: rvq_quantize_reference)."""
    b, t, d = residual.shape
    codes = rvq_ops.rvq_quantize_reference(residual.reshape(b * t, d), embeds)
    return codes.reshape(b, t, -1).transpose(1, 2)


def split_rvq_encode(
    params: Params, emb: torch.Tensor, num_quantizers: int, backend: str = "kernel"
) -> torch.Tensor:
    """(B, hidden, T) float32 -> int32 codes (B, K, T), in IEEE fp32 in
    every mode (the JAX package's in_proj and distances run at HIGHEST).
    Mirrors MimiSplitResidualVectorQuantizer.encode (modeling_mimi.py:1318-1345):
    semantic RVQ on the projected embeddings, acoustic RVQ *also on the
    original embeddings* (not the semantic residual)."""
    avail = params["semantic"]["embed"].shape[0] + params["acoustic"]["embed"].shape[0]
    if num_quantizers > avail:
        # HF raises too (MimiModel.encode, modeling_mimi.py:1545-1548);
        # silent truncation would emit fewer codebooks than callers sized
        # their unicode vocab for
        raise ValueError(
            f"num_quantizers {num_quantizers} exceeds the checkpoint's "
            f"{avail} codebooks"
        )
    b, _, t = emb.shape

    def quantize(proj, head, k):
        # (B, D, T) input projection (a 1x1 conv, as HF's input_proj) ->
        # (B, K, T) codes from the head's first k books; the kernel takes
        # the codebooks the engine packed once (encoder._pack_for_kernel)
        x = proj.transpose(1, 2)  # (B, T, D)
        embeds = head["embed"][:k]
        if backend == "torch":
            return rvq_quantize(x, embeds)
        packed = head.get("packed")
        if packed is not None:
            packed = (packed[0][:k], packed[1][:k])
        codes = rvq_ops.rvq_quantize(
            x.reshape(b * t, -1).contiguous(), embeds.contiguous(), packed=packed
        )
        return codes.reshape(b, t, -1).transpose(1, 2)

    sem = params["semantic"]
    n_sem = sem["embed"].shape[0]
    with ieee_fp32():
        sem_in = F.conv1d(emb, sem["in_proj"][:, :, None])
        codes = quantize(sem_in, sem, min(n_sem, num_quantizers))
        n_ac = num_quantizers - codes.shape[1]
        if n_ac > 0:
            ac = params["acoustic"]
            ac_in = F.conv1d(emb, ac["in_proj"][:, :, None])
            codes = torch.cat([codes, quantize(ac_in, ac, n_ac)], dim=1)
    return codes


# ---------------------------------------------------------------------------
# Full encode
# ---------------------------------------------------------------------------

@torch.no_grad()
def encode(
    params: Params,
    cfg: MimiConfig,
    audio: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_quantizers: int = 8,
    masked: bool = True,
    code_dtype: str = "int32",
    resample: Optional[Tuple[int, int]] = None,
    transfer: str = "padded",
    group=None,
    graphs=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Encode (B, T) float32 or int16 audio -> (codes, frame valid), on the
    device the audio and params lie on.

    Equivalent of HF ``model.encode(input_values, padding_mask).audio_codes``
    restricted to the first ``num_quantizers`` codebooks (the reference keeps
    8: mls-en-mimi-pretrain/process_shard.py:33). ``valid`` are per-row int32
    sample counts; pass None (or masked=False) for HF pad-to-length
    semantics. ``code_dtype="uint16"`` is lossless (codebook 2048 < 2^16).

    ``transfer`` shapes the device->host wire format:
      - "padded":  codes (B, K, T/1920) in ``code_dtype`` (the HF layout).
      - "packed":  (B, T/1920, K//2) int32 — adjacent code PAIRS packed
        16-bit-aligned into one word (codebook 2048 << 2^16, lossless).
        Half the bytes of int32; the host unpack is a little-endian
        ``view('<u2')``.
      - "compact": (B*T/1920, K//2) int32 — packed AND valid frames
        gathered to the front in row order, so bucket pad and row pad
        never cross the wire; the caller copies a host-computed prefix
        (per-row frame counts are host-derivable from lengths). Requires
        masked=True with valid. K must be even for the packed modes.

    The body runs in ``matmul_precision(cfg)`` (``fp32_precision``; IEEE
    fp32 by default, the counterpart of JAX ``Precision.HIGHEST``) and
    ``cfg.compute_dtype`` (the conv, transformer and downsample weights are
    cast by ``cast_for_compute``, a no-op on a tree already cast); the
    resample, the in_proj and the RVQ stay IEEE fp32 in every mode.

    ``group`` is the model group of a tensor-parallel mesh, for params from
    ``parallel.mesh.shard_params_tp`` (see ``transformer_apply``); None
    runs the whole transformer on this device. ``graphs`` (a
    ``graphs.TransformerGraphs``) replays the transformer stack from a
    CUDA graph per batch shape (``transformer_apply``).

    While a profiler records, each stage runs in a ``tokenize_audio::mimi.*``
    range (``ranges.span``): ``resample`` (the fused one), ``seanet_encode``,
    ``transformer``, ``downsample``, ``split_rvq`` and ``pack`` (the
    transfer layout).
    """
    _check_modes(cfg)
    with fp32_precision(matmul_precision(cfg)):
        return _encode(
            params, cfg, audio, valid, num_quantizers, masked, code_dtype,
            resample, transfer, group, graphs,
        )


def _encode(
    params, cfg, audio, valid, num_quantizers, masked, code_dtype, resample, transfer, group,
    graphs,
):
    dt = compute_dtype(cfg)
    params = cast_for_compute(params, cfg)
    if audio.dtype == torch.int16:
        # device-side PCM normalization: int16 -> f32 and /32768 are both
        # exact, so shipping raw 16-bit PCM halves host->device bytes with
        # bit-identical codes (the host path is pcm_to_float, core/audio.py)
        audio = audio.to(torch.float32) / 32768.0
    elif not audio.dtype.is_floating_point:
        raise TypeError(
            f"integer audio must be int16 PCM (got {audio.dtype}); "
            "normalize other PCM widths on host via pcm_to_float"
        )
    if resample is not None:
        # fused resample: audio arrives at the SOURCE rate and the
        # polyphase conv runs here. Zero-padding beyond ``valid`` rings in
        # the tail, but every causal conv's VALID outputs read only
        # positions < valid (+ the replicate-pad extra, which reads the last
        # valid sample), so the masked invariant keeps codes bit-identical
        # to resample-then-encode OF THE SAME ROW. Requires masked per-row
        # semantics for that argument.
        if not masked or valid is None:
            raise ValueError("fused resample requires masked=True with valid lengths")
        from tokenize_audio_tpu_torch.core.audio import _resample_batch

        up, down = resample
        with span("mimi.resample"):
            audio = _resample_batch(audio.to(torch.float32), up, down)
        valid = (valid * up + down - 1) // down  # ceil(valid * up / down)
    x = audio[:, None, :].to(dt)
    valid_in = valid
    if not masked:
        valid = None
    with span("mimi.seanet_encode"):
        x, valid = seanet_encode(params, cfg, x, valid)
    with span("mimi.transformer"):
        h = transformer_apply(params["tfm"], cfg, x.transpose(1, 2), group=group,
                              graphs=graphs)
    with span("mimi.downsample"):
        x = h.transpose(1, 2)
        if valid is not None:
            pos = _positions(x.shape[-1], x.device)[None, None, :]
            x = torch.where(pos < valid[:, None, None], x, 0.0)
        x, valid = causal_conv1d(
            x, valid, params["downsample"]["w"], None, stride=2, pad_mode="replicate"
        )
        x = x.to(torch.float32)
    with span("mimi.split_rvq"):
        codes = split_rvq_encode(params["rvq"], x, num_quantizers, backend=cfg.rvq_backend)
    if valid is None and valid_in is not None:
        # unmasked (HF batch semantics) still reports per-row frame counts
        spf = cfg.samples_per_frame
        valid = (valid_in + spf - 1) // spf
    with span("mimi.pack"):
        return _transfer_layout(codes, valid, num_quantizers, code_dtype, transfer), valid


def _transfer_layout(codes, valid, num_quantizers, code_dtype, transfer):
    """The (B, K, T) codes in ``encode``'s ``transfer`` wire format."""
    if transfer == "padded":
        return codes.to(getattr(torch, code_dtype))
    if num_quantizers % 2 != 0:
        raise ValueError(f"packed transfer needs even num_quantizers, got {num_quantizers}")
    # pack adjacent code pairs little-endian into int32 words: the host
    # recovers the exact (.., K) uint16 stream with a zero-copy view('<u2')
    ct = codes.transpose(1, 2).to(torch.int32)  # (B, T, K)
    packed = ct[..., 0::2] | (ct[..., 1::2] << 16)  # (B, T, K//2)
    if transfer == "packed":
        return packed
    if transfer != "compact":
        raise ValueError(f"unknown transfer mode {transfer!r}")
    if valid is None:
        raise ValueError("compact transfer requires valid lengths")
    b, t, kp = packed.shape
    pos = _positions(t, packed.device)[None, :]
    fmask = (pos < valid[:, None]).reshape(-1)
    # stable compaction: row-major frame order is preserved, so the host
    # splits the prefix by cumulative per-row frame counts; invalid frames
    # all land on one spill row that is cut off
    tgt = torch.where(fmask, torch.cumsum(fmask.long(), 0) - 1, b * t)
    out = torch.zeros((b * t + 1, kp), dtype=torch.int32, device=packed.device)
    out.index_copy_(0, tgt, packed.reshape(b * t, kp))
    return out[: b * t]
