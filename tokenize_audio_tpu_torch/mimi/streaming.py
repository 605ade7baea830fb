"""Streaming Mimi encoder: chunked encode with carried state.

Matches HF's ``use_streaming=True`` capability (MimiConv1dPaddingCache +
encoder KV cache, modeling_mimi.py:76-158, 1555-1584) with one step
function over whole-frame chunks and state kept as tensors on the
encoder's device, updated in place:

  - per-conv-layer left-context caches (the last ``pad_total`` inputs of
    each causal conv) instead of zero padding — chunk boundaries become
    invisible to the conv stack;
  - a fixed-capacity transformer KV cache: full causal attention over all
    pushed frames (matching HF's ONE-SHOT encode; HF's own carried-cache
    path is windowed by DynamicSlidingWindowLayer eviction and does not
    reproduce its one-shot), bounded by ``max_frames``. Each step attends
    over the filled prefix only (the keys a one-shot mask would leave
    unmasked). With ``cfg.use_sliding_window=True`` the cache is instead
    a bounded buffer of the last ``sliding_window`` keys, so streams of
    ANY length encode in O(window) memory and codes equal the windowed
    batch encode;
  - the replicate-padded 25->12.5 Hz downsample seeds its first cache from
    the first frame, exactly like MimiConv1dPaddingCache's replicate mode.

Chunk sizes are whole Mimi frames, so every strided conv stays aligned and
no mid-stream right-padding exists; a final partial chunk uses the same
valid-length masking as batch encode. Codes equal the one-shot encode of
the full stream (tests pin equality on the oracle), so arbitrarily long
audio encodes in bounded memory WITHOUT the reference's hard 60 s
receptive-field cuts (yodas2-mimi/process_shard.py:436-493) — up to the
``max_position_embeddings`` horizon that bounds HF itself.

The SEANet convs of a step are plain ``F.conv1d`` over ``[cache | x]`` (the
fused resblock kernel needs the whole row); the RVQ runs through
``split_rvq_encode`` with the configured backend, on the codebooks packed
once per encoder. A step runs in ``matmul_precision(cfg)`` (IEEE fp32 by
default; the RVQ and its in_proj always IEEE) and always in float32: the
stream ignores ``compute_dtype``, as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision, resolve_device
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.model import (
    _check_modes,
    _elu,
    _layer_norm,
    _rope_at,
    _rotate_half,
    matmul_precision,
    split_rvq_encode,
)
from tokenize_audio_tpu_torch.mimi.weights import params_to_torch
from tokenize_audio_tpu_torch.ops.cuda.rvq import pack_codebooks

Params = Dict[str, Any]
_ENCODE_KEYS = ("enc_in", "blocks", "enc_out", "tfm", "downsample", "rvq")


# ---------------------------------------------------------------------------
# Cached causal conv
# ---------------------------------------------------------------------------

def _mask_from(y: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(y.shape[-1], device=y.device)[None, None, :]
    return torch.where(pos < valid[:, None, None], y, 0.0)


def _cached_conv(
    x: torch.Tensor,
    cache: torch.Tensor,  # (B, C, pad_total), overwritten with the new cache
    w: torch.Tensor,
    b: Optional[torch.Tensor],
    stride: int = 1,
    dilation: int = 1,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Conv over [cache | x]; returns (y, new_valid) and leaves the last
    ``pad_total`` columns of [cache | x] in ``cache``.

    ``valid`` (final partial chunk): positions >= valid in x are zeros and
    outputs beyond ceil(valid/stride) are re-zeroed, reproducing the batch
    engine's masked standalone-padding semantics within the chunk.
    """
    pad_total = (w.shape[-1] - 1) * dilation + 1 - stride
    xc = torch.cat([cache, x], dim=-1) if pad_total > 0 else x
    y = F.conv1d(xc, w, b, stride=stride, dilation=dilation)
    if pad_total > 0:
        cache.copy_(xc[:, :, xc.shape[-1] - pad_total :])
    new_valid = None
    if valid is not None:
        new_valid = (valid + stride - 1) // stride
        y = _mask_from(y, new_valid)
    return y, new_valid


def _conv_layer_shapes(cfg: MimiConfig) -> List[Tuple[int, int]]:
    """(in_channels, pad_total) for every cached conv in traversal order:
    enc_in, per block [res c1, res c2, down], enc_out, downsample."""
    shapes: List[Tuple[int, int]] = [(cfg.audio_channels, cfg.kernel_size - 1)]
    dim = cfg.num_filters
    for stride in cfg.encoder_strides:
        for j in range(cfg.num_residual_layers):
            d = cfg.dilation_growth_rate**j
            shapes.append((dim, (cfg.residual_kernel_size - 1) * d))
            shapes.append((dim // cfg.compress, 0))  # k=1 conv: no cache
        shapes.append((dim, 2 * stride - stride))
        dim *= 2
    shapes.append((dim, cfg.last_kernel_size - 1))
    shapes.append((cfg.hidden_size, 2))  # 25->12.5 Hz downsample (k=4, s=2)
    return shapes


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamState:
    conv_caches: List[torch.Tensor]
    kv: torch.Tensor  # (L, 2, B, H, M, hd)
    t_off: int = 0  # frames (25 Hz) already pushed
    is_first: bool = True  # replicate cache not yet seeded

    def clear(self) -> None:
        """Back to the state of a fresh stream, in place."""
        for c in self.conv_caches:
            c.zero_()
        self.kv.zero_()
        self.t_off, self.is_first = 0, True


def init_state(
    cfg: MimiConfig,
    batch: int,
    max_frames_25hz: int = 8000,
    device: Optional[str | torch.device] = None,
) -> StreamState:
    dev = resolve_device(device)
    caches = [
        torch.zeros((batch, c, p), dtype=torch.float32, device=dev)
        for c, p in _conv_layer_shapes(cfg)
    ]
    # full-causal mode: capacity for the whole stream (HF one-shot horizon);
    # windowed mode: only the last `sliding_window` keys are ever needed
    depth = cfg.sliding_window if cfg.use_sliding_window else max_frames_25hz
    kv = torch.zeros(
        (cfg.num_hidden_layers, 2, batch, cfg.num_attention_heads, depth, cfg.head_dim),
        dtype=torch.float32,
        device=dev,
    )
    return StreamState(caches, kv)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------

def _transformer_step(
    params: List[Dict], cfg: MimiConfig, h: torch.Tensor, kv: torch.Tensor, t_off: int
) -> torch.Tensor:
    """One chunk of ``f`` frames at absolute positions t_off.. through the
    transformer, attending over the KV cache, which is updated in place."""
    b, f, _ = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    m = kv.shape[-2]
    dev = h.device
    scale = 1.0 / math.sqrt(hd)
    neg = torch.finfo(torch.float32).min
    cos, sin = _rope_at(cfg, t_off + torch.arange(f, device=dev))
    cos, sin = cos[None, None], sin[None, None]
    ipos = torch.arange(f, device=dev)[:, None]
    windowed = cfg.use_sliding_window
    if windowed:
        # kv holds the last `sliding_window` keys, left-aligned; attention
        # runs over [cache | new] with absolute-position window masking, and
        # the new cache is the tail of that concatenation — O(window) memory
        # for streams of any length.
        kabs = t_off - m + torch.arange(m + f, device=dev)[None, :]
        qabs = t_off + ipos
        allowed = (kabs <= qabs) & (kabs > qabs - m) & (kabs >= 0)
    else:
        # full causal (HF one-shot semantics): grow-in-place cache; only the
        # filled prefix is read, the keys a one-shot mask leaves unmasked
        n_keys = t_off + f
        allowed = torch.arange(n_keys, device=dev)[None, :] <= t_off + ipos
    mask = torch.where(allowed, 0.0, neg)[None, None]

    for li, lp in enumerate(params):
        x = _layer_norm(h, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q = F.linear(x, lp["q"]).view(b, f, nh, hd).transpose(1, 2)
        k = F.linear(x, lp["k"]).view(b, f, nh, hd).transpose(1, 2)
        v = F.linear(x, lp["v"]).view(b, f, nh, hd).transpose(1, 2)
        q = q * cos + _rotate_half(q) * sin
        k = k * cos + _rotate_half(k) * sin
        if windowed:
            k_cache = torch.cat([kv[li, 0], k], dim=2)
            v_cache = torch.cat([kv[li, 1], v], dim=2)
            kv[li, 0].copy_(k_cache[:, :, -m:])
            kv[li, 1].copy_(v_cache[:, :, -m:])
        else:
            kv[li, 0, :, :, t_off:n_keys] = k
            kv[li, 1, :, :, t_off:n_keys] = v
            k_cache, v_cache = kv[li, 0, :, :, :n_keys], kv[li, 1, :, :, :n_keys]
        aw = torch.matmul(q, k_cache.transpose(2, 3)) * scale
        aw = aw + mask
        aw = F.softmax(aw, dim=-1, dtype=torch.float32)
        att = torch.matmul(aw, v_cache)
        att = att.transpose(1, 2).contiguous().view(b, f, nh * hd)
        att = F.linear(att, lp["o"])
        h = h + lp["ls1"] * att
        x = _layer_norm(h, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        x = F.linear(x, lp["fc1"])
        x = F.gelu(x)
        x = F.linear(x, lp["fc2"])
        h = h + lp["ls2"] * x
    return h


@torch.no_grad()
def stream_step(
    params: Params,
    cfg: MimiConfig,
    state: StreamState,
    audio: torch.Tensor,  # (B, chunk_samples), chunk_samples % samples_per_frame == 0
    valid: torch.Tensor,  # (B,) int valid samples in this chunk (== chunk for full)
    num_quantizers: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode one chunk: returns (int32 codes (B, K, chunk frames), valid
    frames per row (B,)) and advances ``state`` in place."""
    with fp32_precision(matmul_precision(cfg)):
        return _stream_step(params, cfg, state, audio, valid, num_quantizers)


def _stream_step(params, cfg, state, audio, valid, num_quantizers):
    caches = state.conv_caches
    ci = 0

    def conv(x, w, b, stride=1, dilation=1, v=None):
        nonlocal ci
        y, nv = _cached_conv(x, caches[ci], w, b, stride, dilation, v)
        ci += 1
        return y, nv

    x = audio[:, None, :].to(torch.float32)
    v = valid
    x, v = conv(x, params["enc_in"]["w"], params["enc_in"]["b"], v=v)
    for block, stride in zip(params["blocks"], cfg.encoder_strides):
        for j, res in enumerate(block["res"]):
            residual = x
            h = _elu(x)
            h, _ = conv(
                h, res["c1"]["w"], res["c1"]["b"], dilation=cfg.dilation_growth_rate**j, v=v
            )
            h = _elu(h)
            h, _ = conv(h, res["c2"]["w"], res["c2"]["b"], v=v)
            x = residual + h
        x = _elu(x)
        x, v = conv(x, block["down"]["w"], block["down"]["b"], stride=stride, v=v)
    x = _elu(x)
    x, v = conv(x, params["enc_out"]["w"], params["enc_out"]["b"], v=v)

    h = _transformer_step(params["tfm"], cfg, x.transpose(1, 2), state.kv, state.t_off)
    x = _mask_from(h.transpose(1, 2), v)

    # replicate-padded downsample: seed the cache from the very first frame
    # (MimiConv1dPaddingCache replicate mode, modeling_mimi.py:137-147); the
    # final partial chunk re-creates the standalone replicated extra pad
    # (a no-op mid-stream, where v is even and extra == 0).
    if state.is_first:
        caches[ci].copy_(x[:, :, :1].expand(-1, -1, caches[ci].shape[-1]))
    extra = (v + 1) // 2 * 2 - v
    idx = (v - 1).clamp(min=0)[:, None, None].expand(-1, x.shape[1], 1).long()
    last = torch.gather(x, 2, idx)
    p25 = torch.arange(x.shape[-1], device=x.device)[None, None, :]
    vv = v[:, None, None]
    x = torch.where((p25 >= vv) & (p25 < vv + extra[:, None, None]), last, x)
    x, v12 = _cached_conv(x, caches[ci], params["downsample"]["w"], None, stride=2, valid=v)

    codes = split_rvq_encode(params["rvq"], x, num_quantizers, backend=cfg.rvq_backend)
    state.t_off += audio.shape[-1] // (cfg.samples_per_frame // 2)
    state.is_first = False
    return codes.to(torch.int32), v12


class StreamingMimiEncoder:
    """Convenience wrapper: push fixed-size chunks, collect codes.

        enc = StreamingMimiEncoder(params, cfg, chunk_seconds=4.0)
        codes = enc.encode_stream(audio)           # any length
        # or incrementally:
        enc.reset()
        for chunk in chunks:  out.append(enc.push(chunk))

    ``params`` is a numpy or tensor param tree; tensors already on
    ``device`` (the CUDA device unless the caller names another) are used
    as they are, so an engine's stream encoders share its device copy. With
    the kernel RVQ backend, codebooks the tree does not carry packed yet are
    packed here, once.
    """

    def __init__(
        self,
        params: Params,
        cfg: Optional[MimiConfig] = None,
        batch: int = 1,
        chunk_seconds: float = 4.0,
        max_seconds: float = 320.0,
        num_quantizers: int = 8,
        device: Optional[str | torch.device] = None,
    ):
        self.cfg = cfg or MimiConfig()
        _check_modes(self.cfg)
        self.device = resolve_device(device)
        self.params = params_to_torch({k: params[k] for k in _ENCODE_KEYS}, self.device)
        if self.cfg.rvq_backend == "kernel":
            for head in self.params["rvq"].values():
                if head.get("packed") is None:
                    head["packed"] = pack_codebooks(head["embed"])
        self.batch = batch
        spf = self.cfg.samples_per_frame
        self.chunk_samples = max(spf, int(chunk_seconds * self.cfg.sampling_rate) // spf * spf)
        self.max_frames_25 = int(max_seconds * self.cfg.sampling_rate) // (spf // 2)
        self.num_quantizers = num_quantizers
        self.state: Optional[StreamState] = None
        self.reset()

    def reset(self) -> None:
        if self.state is None:
            self.state = init_state(self.cfg, self.batch, self.max_frames_25, self.device)
        else:
            self.state.clear()
        self._frames_pushed_25 = 0
        self._finished = False

    def _host_chunk(self, rows: int) -> torch.Tensor:
        """A zeroed (rows, chunk) staging tensor, pinned when the encoder
        runs on the card: its copy to the device is then asynchronous, and
        the caching host allocator reuses its memory only after the copy."""
        return torch.zeros(
            (rows, self.chunk_samples), dtype=torch.float32,
            pin_memory=self.device.type == "cuda",
        )

    def _step(self, audio: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return stream_step(
            self.params,
            self.cfg,
            self.state,
            audio.to(self.device, non_blocking=True),
            valid,
            num_quantizers=self.num_quantizers,
        )

    def push(self, audio: np.ndarray, valid: Optional[np.ndarray] = None) -> np.ndarray:
        """audio (B, chunk_samples) -> codes (B, K, frames) for this chunk
        (trimmed to valid frames, which requires equal valid across rows)."""
        audio = np.asarray(audio, dtype=np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        spf = self.cfg.samples_per_frame
        if audio.shape[1] % spf != 0:
            raise ValueError(
                f"streaming chunks must be whole frames ({spf} samples); got "
                f"{audio.shape[1]}. Zero-pad the final chunk and pass `valid`."
            )
        if valid is None:
            valid = np.full((audio.shape[0],), audio.shape[1], dtype=np.int32)
        valid = np.asarray(valid, dtype=np.int32)
        if self._finished:
            raise ValueError(
                "push() after a partial (valid < chunk) chunk: the conv and "
                "KV caches now hold end-of-stream padding state, so further "
                "chunks would silently produce wrong codes — reset() first"
            )
        # validate the common-end invariant BEFORE touching any state: a
        # post-step raise would leave the caches already advanced, making
        # the suggested remedy (re-push padded rows) impossible without
        # losing the whole stream. Per-row valid frames are host-derivable:
        # ceil(ceil(valid/960)/2) == ceil(valid/1920).
        exp12 = -(-valid // spf)
        if not (exp12 == exp12[0]).all():
            raise ValueError(
                f"per-row valid frame counts differ ({exp12.tolist()}); push() "
                "returns one trimmed array, so rows must end together — pad "
                "rows to a common valid length or stream them separately"
            )
        if (valid < audio.shape[1]).any():
            self._finished = True  # partial chunk ends the stream
        f25 = audio.shape[1] // (spf // 2)
        if (
            not self.cfg.use_sliding_window
            and self._frames_pushed_25 + f25 > self.max_frames_25
        ):
            raise ValueError(
                f"stream exceeds KV-cache capacity ({self.max_frames_25} frames "
                f"@25Hz); raise max_seconds, reset(), or use a "
                "use_sliding_window=True config (bounded-memory, any length) — "
                "silently wrapping would corrupt codes"
            )
        self._frames_pushed_25 += f25
        codes, v12 = self._step(
            torch.from_numpy(audio), torch.from_numpy(valid).to(self.device)
        )
        f_arr = v12.cpu().numpy()
        if not (f_arr == exp12).all():  # host formula == device
            raise RuntimeError(f"device frame counts {f_arr} != host {exp12}")
        return codes.cpu().numpy()[:, :, : int(f_arr[0])]

    def encode_streams(self, audios) -> List[np.ndarray]:
        """Multiplex up to ``batch`` VARIABLE-LENGTH streams through one
        carried state: per-utterance codes identical to a serial
        ``encode_stream`` of each (tests pin this), in ~1/batch the steps.

        How rows end independently: ``stream_step`` masks per row, so a row
        whose remaining samples run out mid-batch gets its standalone
        right-padding semantics from its own ``valid`` while other rows
        continue; its later chunks carry valid=0 and emit 0 frames (the
        zero-input garbage in its caches is never read by a valid output —
        causal convs only look left, and emitted frames predate the end).
        Full-causal configs: streams beyond the KV horizon reset state at
        the same whole-chunk boundary the serial piece loop cuts at,
        giving identical per-piece exact encoding. Windowed configs
        (``cfg.use_sliding_window``): NEVER reset — the bounded cache means
        any length matches the windowed batch encode exactly, with no
        horizon cuts.

        The codes stay on the device until the last chunk and cross to the
        host in one copy, with the device's per-row frame counts, which are
        checked against the host's.
        """
        if len(audios) > self.batch:
            raise ValueError(f"{len(audios)} streams > batch {self.batch}")
        audios = [np.asarray(a, dtype=np.float32) for a in audios]
        cs = self.chunk_samples
        spf = self.cfg.samples_per_frame
        lens = np.zeros(self.batch, dtype=np.int64)
        lens[: len(audios)] = [len(a) for a in audios]
        if not lens.any():
            return [
                np.zeros((self.num_quantizers, 0), dtype=np.int32) for _ in audios
            ]
        n_chunks = int(-(-lens.max() // cs))
        # per-row valid samples of each chunk, computed where they are used
        lens_dev = torch.from_numpy(lens).to(self.device)
        # horizon cut at whole chunks (same boundary as the engine's serial
        # piece loop): every piece then fits the KV capacity even after the
        # final-chunk zero pad
        if self.cfg.use_sliding_window:
            cut_chunks = n_chunks + 1  # bounded window: never reset
        else:
            horizon = self.max_frames_25 * (spf // 2)
            cut_chunks = max(1, horizon // cs)
        self.reset()
        step_codes, step_frames, host_frames = [], [], []
        for k in range(n_chunks):
            if k > 0 and k % cut_chunks == 0:
                self.reset()
            start = k * cs
            valid = np.clip(lens - start, 0, cs).astype(np.int32)
            # one chunk staged at a time: materializing the whole (batch,
            # longest) zero-padded matrix would multiply host memory by the
            # batch width when one stream is much longer than the rest
            chunk = self._host_chunk(self.batch)
            buf = chunk.numpy()
            for i, a in enumerate(audios):
                v = int(valid[i])
                if v:
                    buf[i, :v] = a[start : start + v]
            codes, v12 = self._step(chunk, (lens_dev - start).clamp(0, cs).to(torch.int32))
            step_codes.append(codes)
            step_frames.append(v12)
            host_frames.append(-(-valid // spf))
        codes = torch.stack(step_codes).cpu().numpy()  # (chunks, B, K, frames)
        f_arr = torch.stack(step_frames).cpu().numpy()
        exp12 = np.stack(host_frames)
        if not (f_arr == exp12).all():  # host formula == device
            raise RuntimeError(f"device frame counts {f_arr} != host {exp12}")
        out = []
        for i in range(len(audios)):
            parts = [codes[k, i, :, : exp12[k, i]] for k in range(n_chunks) if exp12[k, i]]
            out.append(
                np.concatenate(parts, axis=1)
                if parts
                else np.zeros((self.num_quantizers, 0), dtype=np.int32)
            )
        return out

    def encode_stream(self, audio: np.ndarray) -> np.ndarray:
        """(T,) or (B, T) arbitrary-length audio -> (B, K, ceil(T/1920))."""
        audio = np.asarray(audio, dtype=np.float32)
        squeeze = audio.ndim == 1
        if squeeze:
            audio = audio[None]
        self.reset()
        cs = self.chunk_samples
        if audio.shape[1] == 0:
            empty = np.zeros((audio.shape[0], self.num_quantizers, 0), dtype=np.int32)
            return empty[0] if squeeze else empty
        out = []
        for start in range(0, audio.shape[1], cs):
            chunk = audio[:, start : start + cs]
            n = chunk.shape[1]
            if n < cs:
                chunk = np.pad(chunk, ((0, 0), (0, cs - n)))
            out.append(self.push(chunk, np.full((audio.shape[0],), n, dtype=np.int32)))
        codes = np.concatenate(out, axis=2)
        return codes[0] if squeeze else codes
