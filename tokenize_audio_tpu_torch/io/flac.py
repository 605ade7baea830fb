"""ctypes binding for the native C++ FLAC decoder.

The shared library is compiled from ``io/native/flac_decoder.cc`` with
``g++ -O2`` on first use into ``tokenize_audio_tpu_torch/_build/`` (listed
in ``.gitignore``, beside the CUDA kernels' libraries), keyed by source
mtime; GPU hosts ship a toolchain but no audio libraries, so the framework
carries its own decode path end to end. A missing ``g++`` or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "io", "native", "flac_decoder.cc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_LIB = os.path.join(_BUILD_DIR, "libflac_decoder.so")

_lib = None
_load_lock = threading.Lock()  # decode prefetch threads may race first use


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    # unique temp name: concurrent builders (threads or processes) must not
    # interleave writes into the same file before the atomic replace
    tmp = f"{_LIB}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the FLAC decoder is built from source at first use"
        ) from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"FLAC decoder build failed:\n{e.stderr}") from e
    os.replace(tmp, _LIB)
    return _LIB


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_LIB)
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_probe.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.flac_decode.restype = ctypes.c_int64
        lib.flac_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
        ]
        _lib = lib
        return lib


def read_flac(data: bytes, raw_int16: bool = False) -> Tuple[np.ndarray, int]:
    """Decode FLAC bytes -> (float32 audio in [-1, 1), (T,) or (T, C), sr).

    ``raw_int16=True`` returns 16-bit streams (the common corpus depth) as
    int16 PCM without normalization — the encode engine normalizes on
    device (exact /32768). Other bit depths still return float32."""
    lib = _load()
    sr = ctypes.c_int32()
    ch = ctypes.c_int32()
    bits = ctypes.c_int32()
    total = ctypes.c_int64()
    rc = lib.flac_probe(data, len(data), ctypes.byref(sr), ctypes.byref(ch),
                        ctypes.byref(bits), ctypes.byref(total))
    if rc != 0:
        raise ValueError("not a FLAC stream (missing fLaC/STREAMINFO)")
    n_total = int(total.value)
    channels = int(ch.value)
    if n_total <= 0:
        # unknown length: allocate generously (1 hour cap at this rate)
        n_total = int(sr.value) * 3600
    out = np.empty(n_total * channels, dtype=np.int32)
    written = lib.flac_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.size
    )
    if written < 0:
        raise ValueError(f"FLAC decode failed (code {written})")
    pcm = out[: written * channels]
    if raw_int16 and int(bits.value) == 16:
        audio = pcm.astype(np.int16)
    else:
        scale = float(1 << (int(bits.value) - 1))
        audio = pcm.astype(np.float32) / scale
    if channels > 1:
        audio = audio.reshape(-1, channels)
    return audio, int(sr.value)
