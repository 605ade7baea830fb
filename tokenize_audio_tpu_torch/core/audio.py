"""Audio DSP: PCM normalization, rational polyphase resampling, framing and
length bucketing.

The reference resamples on the host CPU per utterance with librosa
(``librispeech-mimi/utils.py:84-87``; 48 kHz -> 24 kHz at
``common-voice-mimi/process_common_voice.py:231-232``, 16 kHz -> 24 kHz at
``mls-en-mimi-pretrain/process_shard.py:302-304``). Here resampling is a
polyphase FIR applied as one strided ``conv1d`` with ``up`` output channels
(one per output phase), so whole padded batches resample on the device in
one op.

Filter design matches ``scipy.signal.resample_poly`` defaults (Kaiser
beta=5.0, 10*max(up,down) half-length) so outputs agree with the SciPy
golden within float32 tolerance.

DEVIATION CONTRACT vs the reference: the reference resamples with
librosa/soxr_hq, a different anti-alias filter, so 16/48 kHz corpora can
emit slightly different codes than the reference's published datasets
(24 kHz corpora are unaffected — no resampling).

Split-then-resample boundary frames: for audio over the engine's 60 s cap
on the FUSED resample path, the engine splits at the SOURCE rate first and
resamples each piece inside its encode call. The non-causal polyphase
filter then sees zeros past each piece's end instead of the next piece's
samples, so the last few frames of every piece can differ from a
resample-whole-then-split order (the fused path's bit-identical guarantee
is PER PIECE), the same approximation class as the reference's own 60 s
cuts (yodas2-mimi/process_shard.py:436-493).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import (
    MIMI_SAMPLE_RATE,
    SAMPLES_PER_FRAME,
    resolve_device,
)


# ---------------------------------------------------------------------------
# PCM normalization
# ---------------------------------------------------------------------------

def pcm_to_float(audio: np.ndarray) -> np.ndarray:
    """Convert integer PCM to float32 in [-1, 1); float input passes through
    as float32 (matching librosa.load / soundfile semantics)."""
    if audio.dtype == np.float32:
        return audio
    if audio.dtype == np.float64:
        return audio.astype(np.float32)
    if audio.dtype == np.int16:
        return (audio.astype(np.float32)) / 32768.0
    if audio.dtype == np.int32:
        return (audio.astype(np.float32)) / 2147483648.0
    if audio.dtype == np.uint8:  # WAV 8-bit is unsigned, midpoint 128
        return (audio.astype(np.float32) - 128.0) / 128.0
    raise TypeError(f"Unsupported PCM dtype {audio.dtype}")


# ---------------------------------------------------------------------------
# Polyphase resampler
# ---------------------------------------------------------------------------

def _kaiser_sinc_filter(up: int, down: int, half_width: int = 10, beta: float = 5.0) -> np.ndarray:
    """Low-pass FIR identical to scipy.signal.resample_poly's default design:
    firwin(2*10*max(up,down)+1, 1/max(up,down), window=('kaiser', 5.0)) * up.
    Built directly (windowed sinc + Kaiser) to avoid a scipy runtime dep.
    """
    max_rate = max(up, down)
    half_len = half_width * max_rate
    n = np.arange(-half_len, half_len + 1, dtype=np.float64)
    cutoff = 1.0 / max_rate  # normalized to Nyquist
    h = cutoff * np.sinc(cutoff * n)
    h *= np.kaiser(2 * half_len + 1, beta)
    h /= h.sum()  # firwin scales for unity gain at DC
    return (h * up).astype(np.float64)


def resample_output_length(n_in: int, up: int, down: int) -> int:
    n_out = n_in * up
    return n_out // down + bool(n_out % down)


@functools.lru_cache(maxsize=32)
def _resample_plan(up: int, down: int) -> Tuple[np.ndarray, int]:
    """Precompute the polyphase kernel bank and output-phase offset.

    scipy.resample_poly zero-pads the filter by ``n_pre_pad`` so decimated
    samples land on integer input positions, then drops ``n_pre_remove``
    leading outputs. The classic polyphase decomposition folds on top:
    output j (phase r = j mod up) is a plain correlation of the *original*
    signal with tap row r at stride ``down`` — no zero-stuffing, so the conv
    has ``up`` output channels.
    """
    h = _kaiser_sinc_filter(up, down)
    half_len = (len(h) - 1) // 2
    n_pre_pad = (down - half_len % down) % down
    n_pre_remove = (half_len + n_pre_pad) // down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    w = len(h)
    t = -(-w // up)  # taps per phase
    ker = np.zeros((up, t + down), dtype=np.float64)
    for r in range(up):
        phase = (r * down) % up
        shift = (r * down) // up
        for k in range(t):
            tap = phase + k * up
            if tap < w:
                ker[r, shift + t - k] = h[tap]
    return ker.astype(np.float32), n_pre_remove


def _resample_batch(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """upfirdn(h, x, up, down) for a float32 (B, T) batch via polyphase conv."""
    ker, n_pre_remove = _resample_plan(up, down)
    t = ker.shape[-1] - down
    n_in = x.shape[-1]
    n_out = resample_output_length(n_in, up, down)
    n_blocks = -(-(n_pre_remove + n_out) // up)
    pad_right = t + down * (n_blocks + 1) - n_in
    lhs = F.pad(x, (t, pad_right))[:, None, :]  # (B, 1, L)
    rhs = torch.from_numpy(ker)[:, None, :].to(x.device)  # (up, 1, t+down)
    y = F.conv1d(lhs, rhs, stride=down)  # (B, up, >=n_blocks)
    y = y[:, :, :n_blocks]
    y = y.transpose(1, 2).reshape(x.shape[0], n_blocks * up)
    return y[:, n_pre_remove : n_pre_remove + n_out]


def _resample_batch_pcm(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """int16-aware batch resample: raw PCM normalizes on device (exact
    x/32768)."""
    if x.dtype == torch.int16:
        x = x.to(torch.float32) / 32768.0
    return _resample_batch(x.to(torch.float32), up, down)


def resample(
    audio: np.ndarray | torch.Tensor,
    orig_sr: int,
    target_sr: int,
    bucket_lengths: bool = True,
    device: Optional[str | torch.device] = None,
) -> torch.Tensor:
    """Resample the last axis of ``audio`` from ``orig_sr`` to ``target_sr``
    on ``device`` (CUDA unless the caller names another).

    Accepts (T,) or (B, T); returns the same rank as a float32 tensor.
    Drop-in for the reference's ``resample_audio``
    (librispeech-mimi/utils.py:84-87) with scipy.resample_poly filter
    semantics.

    ``bucket_lengths`` pads the input to the next power of two before the
    conv and slices the output back — upfirdn is a full convolution over a
    finite signal, so trailing zeros change nothing in the kept prefix,
    while the set of distinct input shapes stays one per power of two.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(audio) if not torch.is_tensor(audio) else audio)
    x = x.to(device=dev, dtype=torch.float32)
    if orig_sr == target_sr:
        return x
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    n_true = x.shape[-1]
    if bucket_lengths:
        padded = max(1024, 1 << (n_true - 1).bit_length())
        if padded != n_true:
            x = F.pad(x, (0, padded - n_true))
    y = _resample_batch(x, up, down)
    y = y[:, : resample_output_length(n_true, up, down)]
    return y[0] if squeeze else y


def resample_many(
    audios: Sequence[np.ndarray],
    orig_sr: int,
    target_sr: int,
    max_rows: int = 64,
    device: Optional[str | torch.device] = None,
) -> list[np.ndarray]:
    """Resample many 1-D utterances in FEW device calls.

    Rows are grouped by their padded power-of-two length (same
    zero-pad-exactness argument as ``resample(bucket_lengths=True)``) into
    (B, L) batches of up to ``max_rows``, so N utterances cost ~N/max_rows
    calls. Results equal per-row ``resample`` (rows of a batched conv are
    independent). int16 PCM rows ship raw and normalize on device."""
    if orig_sr == target_sr:
        return [pcm_to_float(np.asarray(a)) for a in audios]
    dev = resolve_device(device)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out: list = [None] * len(audios)
    groups: dict = {}
    for i, a in enumerate(audios):
        a = np.asarray(a)
        padded = max(1024, 1 << (max(1, len(a)) - 1).bit_length())
        groups.setdefault(padded, []).append(i)
    for padded, idxs in groups.items():
        for s in range(0, len(idxs), max_rows):
            chunk = idxs[s : s + max_rows]
            raw16 = all(np.asarray(audios[i]).dtype == np.int16 for i in chunk)
            batch = np.zeros(
                (len(chunk), padded), dtype=np.int16 if raw16 else np.float32
            )
            for r, i in enumerate(chunk):
                a = np.asarray(audios[i])
                batch[r, : len(a)] = a if raw16 else pcm_to_float(a)
            y = _resample_batch_pcm(torch.from_numpy(batch).to(dev), up, down)
            y = y.cpu().numpy()
            for r, i in enumerate(chunk):
                n = resample_output_length(len(np.asarray(audios[i])), up, down)
                out[i] = y[r, :n]
    return out


# ---------------------------------------------------------------------------
# Framing / bucketing
# ---------------------------------------------------------------------------

def encoded_frame_count(n_samples: int | np.ndarray, samples_per_frame: int = SAMPLES_PER_FRAME):
    """Number of 12.5 Hz Mimi frames for an input length: ceil(n / 1920).
    Matches the reference trim formula (yodas2-mimi/process_shard.py:262-274)."""
    return -(-np.asarray(n_samples) // samples_per_frame)


def make_buckets(
    min_seconds: float,
    max_seconds: float,
    growth: float,
    sample_rate: int = MIMI_SAMPLE_RATE,
    samples_per_frame: int = SAMPLES_PER_FRAME,
) -> Tuple[int, ...]:
    """Geometric lattice of padded lengths (in samples), each rounded up to a
    whole Mimi frame so encoded lengths stay frame-aligned. A bounded set of
    batch shapes: ~log(max/min)/log(growth) distinct lengths.
    """
    buckets = []
    s = min_seconds
    while s < max_seconds:
        n = int(math.ceil(s * sample_rate / samples_per_frame)) * samples_per_frame
        if not buckets or n > buckets[-1]:
            buckets.append(n)
        s *= growth
    top = int(math.ceil(max_seconds * sample_rate / samples_per_frame)) * samples_per_frame
    if not buckets or top > buckets[-1]:
        buckets.append(top)
    return tuple(buckets)


def bucket_for_length(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (clips to the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_to_bucket(
    utterances: Sequence[np.ndarray],
    bucket_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Right-zero-pad a list of 1-D arrays to (B, bucket_len) plus the
    per-row valid-sample count. Replaces the HF feature-extractor
    pad-to-longest path (yodas2-mimi/process_shard.py:244-261) with a fixed
    shape lattice.

    When every row is int16 PCM the batch stays int16 — the model encode
    normalizes on device (exact x/32768), halving host->device transfer.
    Mixed or float rows normalize to float32 on host."""
    raw16 = all(np.asarray(u).dtype == np.int16 for u in utterances)
    batch = np.zeros(
        (len(utterances), bucket_len), dtype=np.int16 if raw16 else np.float32
    )
    lengths = np.zeros((len(utterances),), dtype=np.int32)
    for i, u in enumerate(utterances):
        u = np.asarray(u).reshape(-1) if raw16 else pcm_to_float(np.asarray(u)).reshape(-1)
        if len(u) > bucket_len:
            raise ValueError(f"utterance of {len(u)} samples exceeds bucket {bucket_len}")
        batch[i, : len(u)] = u
        lengths[i] = len(u)
    return batch, lengths


def split_long_audio(
    audio: np.ndarray,
    max_samples: int,
) -> list[np.ndarray]:
    """Split audio longer than the cap into consecutive <=cap pieces, encoded
    independently and re-concatenated on the code time axis downstream —
    the reference's 60 s policy (yodas2-mimi/process_shard.py:459-493)."""
    if len(audio) <= max_samples:
        return [audio]
    return [audio[i : i + max_samples] for i in range(0, len(audio), max_samples)]


def split_long_audio_with_context(
    audio: np.ndarray,
    max_samples: int,
    context_samples: int,
    samples_per_frame: int = SAMPLES_PER_FRAME,
) -> list[tuple[np.ndarray, int]]:
    """Split with left-context overlap: piece i >= 1 carries ``context``
    extra leading samples whose frames are encoded then dropped, restoring
    (approximate) receptive field across the cut, opt-in via
    EngineConfig.split_context_seconds.

    Returns (piece, leading_frames_to_drop) pairs. cap and context are
    rounded to whole frames so dropped frames stay aligned."""
    cap = max(samples_per_frame, max_samples // samples_per_frame * samples_per_frame)
    ctx = context_samples // samples_per_frame * samples_per_frame
    if len(audio) <= cap or ctx <= 0:
        return [(p, 0) for p in split_long_audio(audio, cap)]
    out: list[tuple[np.ndarray, int]] = [(audio[:cap], 0)]
    for start in range(cap, len(audio), cap):
        lo = start - ctx
        out.append((audio[lo : start + cap], ctx // samples_per_frame))
    return out
