"""Synthetic YODAS2 mirrors for the PyTorch port's tests and ``chip_smoke.py``:
the ``LocalSource`` layout ``{shard}/{sid}.tar.gz`` (``audio/<id>.wav|.flac``)
plus ``{sid}.json`` (``[{"audio_id", "text": {chunk_id: text}}]``).

Imports numpy, the port's WAV writer and the numpy-only FLAC fixture encoder:
nothing of JAX, so it runs on a GPU machine that has no JAX. It and the
encoder are imported by their own names, with ``tests/`` on ``sys.path`` (as
pytest puts it there for this directory, which has no ``__init__.py``): a
``tests`` package installed on such a machine would shadow ``tests.*``."""

from __future__ import annotations

import dataclasses
import json
import os
import tarfile
from typing import List, Sequence, Tuple

import numpy as np

from flac_encoder import encode_flac
from tokenize_audio_tpu_torch.io import write_wav


@dataclasses.dataclass
class Entry:
    audio_id: str
    pcm: np.ndarray  # int16 (T,)
    sample_rate: int
    container: str  # "wav" or "flac"
    chunks: Sequence[Tuple[int, int]]  # (start, end) in centiseconds

    @property
    def text(self) -> dict:
        return {chunk_id(self.audio_id, i, s, e): f"chunk {i}"
                for i, (s, e) in enumerate(self.chunks)}


def chunk_id(audio_id: str, idx: int, start_cs: int, end_cs: int) -> str:
    return f"{audio_id}-{idx:05d}-{start_cs:08d}-{end_cs:08d}"


def noise_pcm(rng, n: int, scale: float = 6000.0) -> np.ndarray:
    return np.clip(rng.standard_normal(n) * scale, -32768, 32767).astype(np.int16)


def write_mirror(root: str, shard: str, subshards: List[List[Entry]]) -> str:
    """Write sub-shard ``{i:08d}`` from ``subshards[i]``; returns ``root``."""
    sdir = os.path.join(root, shard)
    os.makedirs(sdir, exist_ok=True)
    for s, entries in enumerate(subshards):
        sid = f"{s:08d}"
        audio_dir = os.path.join(root, f"_build_{sid}", "audio")
        os.makedirs(audio_dir, exist_ok=True)
        for e in entries:
            path = os.path.join(audio_dir, f"{e.audio_id}.{e.container}")
            if e.container == "flac":
                with open(path, "wb") as f:
                    f.write(encode_flac(e.pcm, sample_rate=e.sample_rate,
                                        subframe_kinds=["verbatim", "fixed2", "lpc"]))
            else:
                write_wav(path, e.pcm / 32767.0, e.sample_rate)  # rounds back to e.pcm
        # compresslevel 1: the payload is noise, and level 9 only costs time
        with tarfile.open(os.path.join(sdir, f"{sid}.tar.gz"), "w:gz", compresslevel=1) as tf:
            tf.add(audio_dir, arcname="audio")
        with open(os.path.join(sdir, f"{sid}.json"), "w") as f:
            json.dump([{"audio_id": e.audio_id, "text": e.text} for e in entries], f)
    return root
