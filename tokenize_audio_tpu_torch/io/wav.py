"""Self-contained WAV (RIFF) reader/writer.

The environment and production GPU hosts ship neither librosa, soundfile,
soxr nor ffmpeg (the reference leans on librosa.load,
yodas2-mimi/process_shard.py:389); container decode is therefore
first-party. WAV covers PCM 8/16/24/32-bit and float32/64, including the
WAVE_FORMAT_EXTENSIBLE header used by many corpus rips.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


def read_wav(path_or_bytes, raw_int16: bool = False) -> Tuple[np.ndarray, int]:
    """Read a WAV file (path, file object, or bytes) -> (float32 mono-or-
    multichannel array in [-1, 1] of shape (T,) or (T, C), sample_rate).

    ``raw_int16=True`` returns 16-bit PCM payloads as int16 without the
    /32768 normalization (the encode engine defers that to the device,
    halving host RAM and host->device bytes — same values, bit-exact).
    Other sample formats still return normalized float32."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
    elif hasattr(path_or_bytes, "read"):
        data = path_or_bytes.read()
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_body = b""
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            try:
                fmt = struct.unpack_from("<HHIIHH", body, 0)
            except struct.error as e:
                raise ValueError(f"truncated WAV fmt chunk: {e}") from e
            fmt_body = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError("missing fmt or data chunk")

    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == _FMT_EXTENSIBLE:
        # actual format code is the first 2 bytes of the SubFormat GUID
        # (fmt chunk offset 24: 16 base + cbSize(2) + validBits(2) + mask(4))
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:
            audio_format = _FMT_PCM

    if audio_format == _FMT_PCM:
        if bits == 16:
            x = np.frombuffer(payload, dtype="<i2")
            if not raw_int16:
                x = x.astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8)
            raw = raw[: len(raw) // 3 * 3].reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / 8388608.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == _FMT_FLOAT:
        if bits == 32:
            dtype = "<f4"
        elif bits == 64:
            dtype = "<f8"
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
        x = np.frombuffer(payload, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x, sample_rate


def write_wav(path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 [-1,1] (T,) or (T,C) audio as 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = np.clip(np.round(audio * 32767.0), -32768, 32767).astype("<i2")
    channels = pcm.shape[1]
    payload = pcm.tobytes()
    byte_rate = sample_rate * channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, _FMT_PCM, channels, sample_rate, byte_rate, channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(payload))
    with open(path, "wb") as f:
        f.write(hdr + payload)
