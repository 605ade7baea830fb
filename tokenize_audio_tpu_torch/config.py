"""Centralized typed configuration and framework-wide constants.

The PyTorch port keeps its own copy of these (it imports nothing of the JAX
package): codec rate facts, the code<->unicode mapping constants, and the
batch encoding engine's configuration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
from typing import Mapping, Optional

import torch

# --- Codec rate facts (reference: yodas2-mimi/process_shard.py:266-270) ---
MIMI_SAMPLE_RATE: int = 24_000
FRAME_RATE: float = 12.5
SAMPLES_PER_FRAME: int = int(MIMI_SAMPLE_RATE / FRAME_RATE)  # 1920

# --- Code<->unicode mapping (reference: librispeech-mimi/utils.py:13-15,
#     pretraining-data/converter.py:11-15) ---
UNICODE_OFFSET: int = 0x4E00  # Acoustic-BPE paper offset (Shen et al., 2024)
UNICODE_OFFSET_LARGE: int = 0xE000  # private use area; production offset
NUM_CODEBOOKS: int = 8
CODEBOOK_SIZE: int = 2048

# --- Interleaved pretraining document special tokens
#     (reference: pretraining-data/prepare_pretraining_data.py:79-86) ---
SPECIAL_TOKENS: Mapping[str, str] = {
    "bos": "<|begin_of_text|>",
    "eos": "<|end_of_text|>",
    "text_start": "<|text_start|>",
    "text_end": "<|text_end|>",
    "audio_start": "<|audio_start|>",
    "audio_end": "<|audio_end|>",
}


def resolve_device(device: Optional[str | torch.device] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Asking for CUDA where there is none raises — the port never
    falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


FP32_MODES = ("ieee", "tf32")


def _set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


class _Fp32Hold:
    """The process-wide hold behind ``fp32_precision``.

    cuDNN and cuBLAS read the two TF32 flags when the host launches an op,
    and the flags are global to the process, where the JAX package picks a
    precision per op. So a region's flags must stay set for every launch
    any thread makes while the region is open, and the hold covers only the
    host-side launch sequence of the region: it never waits on the device.

    - IEEE regions share the hold: any number of threads may be inside at
      once (the engine encodes while decode-prefetch threads resample), all
      seeing both flags False. The first to enter saves the flags, the last
      to leave restores them.
    - A TF32 region holds alone: it waits until no other thread holds, and
      while it waits or holds, a thread opening an IEEE region waits (so a
      stream of short IEEE regions cannot starve it).
    - Within its own thread a TF32 holder may open regions of either mode
      (an IEEE conv inside a TF32 encode): the flags switch for the inner
      region and back after it, which no other thread can see, since none
      holds. A thread in a shared IEEE region cannot open a TF32 one: other
      threads may be launching under its flags.

    A plain lock held for every region would do the same with one mode, but
    would serialize the IEEE regions of the engine and its resample threads
    for nothing."""

    def __init__(self):
        self.cond = threading.Condition()
        self.shared = 0  # threads inside an IEEE region (outermost)
        self.owner: Optional[int] = None  # the thread holding a TF32 region
        self.waiting = 0  # threads waiting to open a TF32 region
        self.saved: tuple = ()
        self.local = threading.local()

    def _save(self) -> None:
        self.saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def _restore(self) -> None:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved

    def enter(self, mode: str) -> None:
        stack = self.local.__dict__.setdefault("stack", [])
        me = threading.get_ident()
        if stack:
            if mode != stack[-1]:
                if self.owner != me:
                    raise RuntimeError(
                        "a TF32 region cannot open inside an IEEE region: other "
                        "threads may share the IEEE flags"
                    )
                _set_tf32(mode == "tf32")
            stack.append(mode)
            return
        with self.cond:
            if mode == "ieee":
                self.cond.wait_for(lambda: self.owner is None and self.waiting == 0)
                if self.shared == 0:
                    self._save()
                    _set_tf32(False)
                self.shared += 1
            else:
                self.waiting += 1
                try:
                    self.cond.wait_for(lambda: self.owner is None and self.shared == 0)
                finally:
                    self.waiting -= 1
                self.owner = me
                self._save()
                _set_tf32(True)
        stack.append(mode)

    def leave(self) -> None:
        stack = self.local.stack
        mode = stack.pop()
        if stack:
            if stack[-1] != mode:
                _set_tf32(stack[-1] == "tf32")
            return
        with self.cond:
            if mode == "ieee":
                self.shared -= 1
                if self.shared == 0:
                    self._restore()
            else:
                self.owner = None
                self._restore()
            self.cond.notify_all()


_fp32_hold = _Fp32Hold()


@contextlib.contextmanager
def fp32_precision(mode: str):
    """Run the enclosed launches with float32 convolutions and matmuls in
    ``mode``: "ieee" (both TF32 flags False; the counterpart of JAX
    ``Precision.HIGHEST``) or "tf32" (both True; what XLA gives
    ``Precision.HIGH`` and ``DEFAULT`` on an NVIDIA GPU). Regions nest, and
    are safe across threads (``_Fp32Hold``). On the CPU the flags change
    nothing, as XLA:CPU ignores ``precision``."""
    if mode not in FP32_MODES:
        raise ValueError(f"fp32 precision mode {mode!r} not in {FP32_MODES}")
    _fp32_hold.enter(mode)
    try:
        yield
    finally:
        _fp32_hold.leave()


def ieee_fp32():
    """IEEE fp32 for cuDNN convolutions and cuBLAS matmuls: cuDNN convs
    default to TF32, which keeps about three decimal digits and breaks code
    parity. Any number of threads may hold it at once."""
    return fp32_precision("ieee")


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Configuration of the code<->text codec layer."""

    num_codebooks: int = NUM_CODEBOOKS
    codebook_size: int = CODEBOOK_SIZE
    unicode_offset: int = UNICODE_OFFSET_LARGE

    @property
    def vocab_range(self) -> tuple[int, int]:
        lo = self.unicode_offset
        return lo, lo + self.num_codebooks * self.codebook_size


@functools.lru_cache(maxsize=None)
def _tail_ladder(cap: int) -> tuple:
    """Allowed tail batch sizes up to ``cap``: {1..8} exact, then the
    mantissa-{2,3} x 2^k series. Bounded batch-shape count per bucket with
    at most 1.33x row overshoot (see batch_size_for_group)."""
    vals = {cap} | set(range(1, min(8, cap) + 1))
    for m in (2, 3):
        v = m
        while v <= cap:
            vals.add(v)
            v *= 2
    return tuple(sorted(vals))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Configuration of the batch encoding engine.

    ``max_chunk_seconds`` mirrors the reference's 60 s split policy
    (yodas2-mimi/process_shard.py:292,436-493).  ``bucket_growth`` controls
    the geometric length-bucket lattice: a bounded set of batch shapes.
    """

    batch_size: int = 16
    max_chunk_seconds: float = 60.0
    min_bucket_seconds: float = 1.0
    # ~26 buckets to 60 s; padding efficiency vs the number of distinct
    # batch shapes
    bucket_growth: float = 1.15
    sample_rate: int = MIMI_SAMPLE_RATE
    num_codebooks: int = NUM_CODEBOOKS
    # samples budget per device batch: short buckets get proportionally
    # larger batches, long buckets smaller (bounds activation memory).
    # None -> fixed batch_size for every bucket.
    samples_per_batch: int | None = None
    max_batch_size: int = 128
    # >0: pieces of >cap audio carry this much left-context (encoded then
    # dropped), restoring receptive field across the 60 s cuts the reference
    # hard-breaks. 0 = exact reference split semantics.
    split_context_seconds: float = 0.0
    # what to do with audio over max_chunk_seconds:
    #   "split"  — reference parity: independent <=cap pieces, codes
    #              concatenated (yodas2-mimi/process_shard.py:436-493)
    #   "stream" — EXACT codes via the streaming encoder (conv caches + KV
    #              cache; identical to a one-shot encode of the whole
    #              stream) up to stream_max_seconds, beyond which the stream
    #              is cut at that much larger boundary
    long_audio_policy: str = "split"
    stream_max_seconds: float = 320.0  # HF one-shot horizon (8000 positions @25 Hz)
    # max >cap utterances multiplexed through ONE carried-state streaming
    # encoder (per-row valid ends; mimi/streaming.py encode_streams). Each
    # row of a full-causal 320 s KV cache is ~262 MB f32, so 8 rows ~2.1 GB.
    stream_batch: int = 8
    # dtype of the per-utterance code arrays the engine returns (and of
    # the "padded" transfer). uint16 is lossless (codebook 2048).
    code_transfer_dtype: str = "int32"
    # device->host wire format (mimi.model.encode ``transfer`` arg):
    #   "padded"  — (B, K, T_bucket) in code_transfer_dtype.
    #   "packed"  — adjacent code pairs packed 16-bit-aligned into int32
    #               words: half the bytes, zero-cost host unpack (a
    #               little-endian view).
    code_transfer_format: str = "packed"
    # device->host collection order for in-flight batches: "fifo" (oldest
    # first) or "ready" (the first whose copy has landed, else the oldest).
    # Order and bits of the results are the same in both.
    drain_policy: str = "fifo"

    @property
    def max_chunk_samples(self) -> int:
        return int(self.max_chunk_seconds * self.sample_rate)

    def batch_size_for_bucket(self, bucket_len: int, multiple_of: int = 1) -> int:
        if self.samples_per_batch is None:
            b = self.batch_size
        else:
            b = max(1, self.samples_per_batch // bucket_len)
            b = min(b, self.max_batch_size)
        b = max(multiple_of, b // multiple_of * multiple_of)
        return b

    def batch_size_for_group(
        self, bucket_len: int, n_real: int, multiple_of: int = 1
    ) -> int:
        """Static batch size for a (possibly tail) group: the bucket's full
        batch size, shrunk to the smallest tail-ladder rung >= n_real.

        The ladder is exact sizes 1..8 plus the mantissa-{2,3} x 2^k series
        (12, 16, 24, 32, 48, ...) — worst-case row overshoot 1.33x vs the
        power-of-two ladder's 2x."""
        full = self.batch_size_for_bucket(bucket_len, multiple_of)
        for v in _tail_ladder(full):
            if v >= min(n_real, full):
                return min(full, -(-v // multiple_of) * multiple_of)
        return full
