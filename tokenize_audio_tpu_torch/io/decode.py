"""Audio container decode registry.

One entry point, ``decode_audio(path_or_bytes, format=None)``, dispatching
by extension/magic to registered decoders. WAV is built in; FLAC is served
by the native C++ decoder in ``tokenize_audio_tpu_torch/io/native``, built
at first use (a missing ``g++`` raises then); mp3 by the system libmpg123
binding (``io/mp3.py``), which registers only when the library is present,
falling back to a clear error naming the gap; further formats can be
registered by deployments.

Replaces the reference's librosa.load host decode
(yodas2-mimi/process_shard.py:389, emilia-mimi/process_shard.py:473-537).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from tokenize_audio_tpu_torch.core.audio import pcm_to_float
from tokenize_audio_tpu_torch.io import mp3
from tokenize_audio_tpu_torch.io.flac import read_flac
from tokenize_audio_tpu_torch.io.wav import read_wav

# decoders take (data, raw_int16=False); decoders for formats without a raw
# 16-bit representation (e.g. mp3's float synthesis) just ignore the flag.
# Legacy single-argument decoders are adapted at registration.
Decoder = Callable[..., Tuple[np.ndarray, int]]

_DECODERS: Dict[str, Decoder] = {}


def register_decoder(fmt: str, fn: Decoder) -> None:
    import inspect

    try:
        params = inspect.signature(fn).parameters
        accepts_raw = "raw_int16" in params or any(
            p.kind == p.VAR_KEYWORD for p in params.values()
        )
    except (TypeError, ValueError):  # builtins/C callables: assume legacy
        accepts_raw = False
    if not accepts_raw:
        fn = lambda data, raw_int16=False, _fn=fn: _fn(data)  # noqa: E731
    _DECODERS[fmt.lower()] = fn


def _sniff(data: bytes) -> Optional[str]:
    if data[:4] == b"RIFF" and data[8:12] == b"WAVE":
        return "wav"
    if data[:4] == b"fLaC":
        return "flac"
    if data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0):
        return "mp3"
    return None


def decode_audio(
    path_or_bytes,
    format: Optional[str] = None,
    mono: bool = True,
    raw_int16: bool = False,
) -> Tuple[np.ndarray, int]:
    """Decode an audio container -> (float32 audio, sample_rate).

    ``mono=True`` averages channels (librosa.load default behavior, which
    the reference relies on for multi-channel corpus files).

    ``raw_int16=True``: 16-bit mono WAV/FLAC payloads come back as int16
    PCM (no /32768) — the encode engine normalizes on device, halving
    host->device transfer with bit-identical codes. Multichannel mixdown
    and non-16-bit/compressed sources still return normalized float32."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    else:
        if format is None:
            format = os.path.splitext(str(path_or_bytes))[1].lstrip(".").lower() or None
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    fmt = (format or _sniff(data) or "").lower()
    if fmt == "wav":
        audio, sr = read_wav(data, raw_int16=raw_int16)
    elif fmt in _DECODERS:
        audio, sr = _DECODERS[fmt](data, raw_int16=raw_int16)
    else:
        raise ValueError(
            f"no decoder for format {fmt!r}; built-in: wav"
            f"{', ' + ', '.join(sorted(_DECODERS)) if _DECODERS else ''}. "
            "Register one with tokenize_audio_tpu_torch.io.register_decoder."
        )
    if mono and audio.ndim == 2:
        # mixdown must happen in normalized float (an int16 mean would keep
        # raw PCM scale in a float array, which nothing downstream detects)
        if audio.dtype != np.float32:
            audio = pcm_to_float(audio)
        audio = audio.mean(axis=1)
    if audio.dtype == np.int16:
        return audio, sr
    return audio.astype(np.float32), sr


def _try_register_native_mp3() -> None:
    try:
        mp3._load()  # probe libmpg123 now so registration reflects availability
    except OSError:  # libmpg123 absent; mp3 stays unregistered
        return
    register_decoder("mp3", mp3.read_mp3)


register_decoder("flac", read_flac)
_try_register_native_mp3()
