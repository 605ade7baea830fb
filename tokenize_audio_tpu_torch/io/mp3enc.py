"""mp3 ENCODER via the system ``libmp3lame`` (ctypes).

Fixture/benchmark-only: generates real mp3 payloads in-process so the
Emilia/Common Voice payload class (mp3-in-tar / mp3-in-parquet,
emilia-mimi/process_shard.py:473-537) can be exercised without ffmpeg or
egress. The DECODE side production depends on lives in io/mp3.py
(libmpg123). The library loads at the first ``encode_mp3``; where it is
missing that call raises ``OSError`` naming it.
"""

from __future__ import annotations

import ctypes

import numpy as np

LIBRARY = "libmp3lame.so.0"

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise OSError(
                f"mp3 encoding needs the system library {LIBRARY}, which could "
                f"not be loaded: {e}"
            ) from e
        lib.lame_init.restype = ctypes.c_void_p
        for name in (
            "lame_set_num_channels",
            "lame_set_in_samplerate",
            "lame_set_brate",
            "lame_set_quality",
            "lame_set_mode",
            "lame_set_bWriteVbrTag",
        ):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.lame_encode_buffer_interleaved.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.lame_encode_flush.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def encode_mp3(pcm: np.ndarray, sample_rate: int = 24_000, bitrate: int = 128) -> bytes:
    """int16 PCM (T,) or (T, 2) -> mp3 bytes (CBR, no Xing tag)."""
    lib = _load()
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    stereo = pcm.ndim == 2
    n = pcm.shape[0]
    gfp = lib.lame_init()
    try:
        lib.lame_set_num_channels(gfp, 2 if stereo else 1)
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_brate(gfp, bitrate)
        lib.lame_set_quality(gfp, 2)
        lib.lame_set_mode(gfp, 1 if stereo else 3)  # JOINT_STEREO | MONO
        # no Xing/VBR tag: the buffer API would leave it as a blank frame
        lib.lame_set_bWriteVbrTag(gfp, 0)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed")
        out = ctypes.create_string_buffer(int(1.25 * n) + 7200)
        if stereo:
            written = lib.lame_encode_buffer_interleaved(
                gfp, pcm.ctypes.data, n, out, len(out)
            )
        else:
            written = lib.lame_encode_buffer(
                gfp, pcm.ctypes.data, None, n, out, len(out)
            )
        if written < 0:
            raise RuntimeError(f"lame_encode_buffer failed ({written})")
        blob = bytes(out.raw[:written])
        written = lib.lame_encode_flush(gfp, out, len(out))
        if written < 0:
            raise RuntimeError(f"lame_encode_flush failed ({written})")
        return blob + bytes(out.raw[:written])
    finally:
        lib.lame_close(gfp)
