"""MP3 decode via the system ``libmpg123`` (ctypes, feed API, no temp files).

Fills the pipeline's last container gap: Emilia ships mp3-in-tar
(emilia-mimi/process_shard.py:473-537 decodes via librosa)
and Common Voice parquet embeds mp3 bytes
(common-voice-mimi/process_common_voice.py:195-232). The
reference leans on librosa→audioread→ffmpeg; here decode is a direct
binding to mpg123 — the canonical high-performance MPEG audio decoder —
which is a base system library on the deployment images (no ffmpeg needed).

Output is float32 (mpg123's own f32 synthesis output, no 16-bit round
trip), shaped (T,) mono or (T, C). Errors map to ValueError so corrupt
inputs take the same per-unit failure path as WAV/FLAC
(runner/shard_runner.py retry-on-restart isolation).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import numpy as np

_MPG123_OK = 0
_MPG123_ERR = -1
_MPG123_NEED_MORE = -10
_MPG123_NEW_FORMAT = -11
_MPG123_DONE = -12
_ENC_FLOAT_32 = 0x200
_MONO_STEREO = 0x3  # MPG123_MONO | MPG123_STEREO
_PARAM_FLAGS = 2  # mpg123_parms MPG123_FLAGS
_FLAG_QUIET = 0x20

_lock = threading.Lock()
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL("libmpg123.so.0")
        lib.mpg123_init()  # no-op on modern versions, required on old ones
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_param.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_long,
            ctypes.c_double,
        ]
        lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
        lib.mpg123_format.argtypes = [
            ctypes.c_void_p,
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.mpg123_rates.argtypes = [
            ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_open_feed.argtypes = [ctypes.c_void_p]
        lib.mpg123_feed.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.mpg123_read.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.mpg123_plain_strerror.restype = ctypes.c_char_p
        lib.mpg123_plain_strerror.argtypes = [ctypes.c_int]
        _lib = lib
        return lib


def read_mp3(data: bytes, raw_int16: bool = False) -> Tuple[np.ndarray, int]:
    # raw_int16 is accepted for registry-signature uniformity and ignored:
    # mpg123 synthesizes float32 directly; a 16-bit round trip would LOSE
    # information rather than save transfer.
    """Decode mp3 bytes -> (float32 audio (T,) or (T, C), sample_rate).

    Raises ValueError on streams that yield no decodable frames; a
    truncated tail decodes to however many whole frames were present
    (mpg123 resyncs past garbage, matching ffmpeg/librosa leniency).
    """
    if not data:
        raise ValueError("empty mp3 input")
    lib = _load()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise ValueError(
            f"mpg123_new failed: {lib.mpg123_plain_strerror(err.value).decode()}"
        )
    try:
        lib.mpg123_param(h, _PARAM_FLAGS, _FLAG_QUIET, 0.0)
        # force float32 output at every supported rate
        lib.mpg123_format_none(h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            lib.mpg123_format(h, rates[i], _MONO_STEREO, _ENC_FLOAT_32)
        if lib.mpg123_open_feed(h) != _MPG123_OK:
            raise ValueError("mpg123_open_feed failed")
        if lib.mpg123_feed(h, data, len(data)) != _MPG123_OK:
            raise ValueError("mpg123_feed rejected the stream")

        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        buf = ctypes.create_string_buffer(1 << 18)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            ret = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(bytes(buf.raw[: done.value]))
            if ret == _MPG123_NEW_FORMAT:
                lib.mpg123_getformat(
                    h, ctypes.byref(rate), ctypes.byref(channels), ctypes.byref(enc)
                )
                continue
            if ret in (_MPG123_NEED_MORE, _MPG123_DONE):
                break  # all fed data consumed / stream end reached
            if ret != _MPG123_OK:
                msg = lib.mpg123_plain_strerror(ret).decode()
                raise ValueError(f"mp3 decode error: {msg}")
        if rate.value == 0 or not chunks:
            raise ValueError("no decodable mp3 frames in input")
        audio = np.frombuffer(b"".join(chunks), dtype=np.float32)
        if channels.value > 1:
            audio = audio[: len(audio) // channels.value * channels.value]
            audio = audio.reshape(-1, channels.value)
        return audio, int(rate.value)
    finally:
        lib.mpg123_delete(h)
