"""Centralized typed configuration and framework-wide constants.

The PyTorch port keeps its own copy of these (it imports nothing of the JAX
package): codec rate facts, the code<->unicode mapping constants, and the
batch encoding engine's configuration.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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


@contextlib.contextmanager
def ieee_fp32():
    """IEEE fp32 for cuDNN convolutions and cuBLAS matmuls (the counterpart
    of JAX ``Precision.HIGHEST``): cuDNN convs default to TF32, which keeps
    about three decimal digits and breaks code parity. Both flags are
    restored on exit rather than flipped process-wide."""
    cudnn_prev = torch.backends.cudnn.allow_tf32
    matmul_prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_prev
        torch.backends.cuda.matmul.allow_tf32 = matmul_prev


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
    #   "stream" — exact codes via the streaming encoder (not ported yet:
    #              the port's engine raises NotImplementedError)
    long_audio_policy: str = "split"
    stream_max_seconds: float = 320.0  # HF one-shot horizon (8000 positions @25 Hz)
    stream_batch: int = 8
    # dtype of the per-utterance code arrays the engine returns (and of
    # the "padded" transfer). uint16 is lossless (codebook 2048).
    code_transfer_dtype: str = "int32"
    # device->host wire format (mimi.model.encode ``transfer`` arg):
    #   "padded"  — (B, K, T_bucket) in code_transfer_dtype.
    #   "packed"  — adjacent code pairs packed 16-bit-aligned into int32
    #               words: half the bytes, zero-cost host unpack (a
    #               little-endian view).
    #   "compact" — packed + valid frames gathered to the front on device;
    #               the engine copies only a 16-step-lattice prefix sized
    #               from host-known frame counts. Requires masked mode.
    code_transfer_format: str = "packed"
    # device->host collection order for in-flight batches: "fifo" (oldest
    # first). "ready" and "threaded" are not ported yet (the port's engine
    # raises NotImplementedError for them).
    drain_policy: str = "fifo"
    fetch_threads: int = 4

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
