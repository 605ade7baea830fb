"""Synthetic inputs of the corpus processors, for the PyTorch port's tests and
``chip_smoke.py``: LibriSpeech manifests of WAV/FLAC files, HF-style parquet
rows with ``{'array', 'sampling_rate'}`` / ``{'bytes', 'path'}`` audio cells
(Common Voice, LibriTTS-R, MLS) and Emilia tars of audio + JSON members.

Imports numpy, the port's WAV writer and the numpy-only FLAC fixture encoder:
nothing of JAX. Imported by its own name, with ``tests/`` on ``sys.path``
(as ``torch_yodas2_mirror`` is)."""

from __future__ import annotations

import json
import os
import tarfile
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from flac_encoder import BitWriter
from tokenize_audio_tpu_torch.io import write_wav

# bytes no decoder accepts: a corrupt member or manifest file
CORRUPT = b"RIFF\x00\x00\x00\x00WAVEnot audio"


def tone_pcm(rng, seconds: float, sr: int) -> np.ndarray:
    """int16 PCM of a random 80-400 Hz tone (0.3) plus noise (0.1)."""
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    wave = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * tt) + 0.1 * rng.standard_normal(n)
    return (np.clip(wave, -1, 1) * 32767).astype(np.int16)


def wav_bytes(pcm: np.ndarray, sr: int) -> bytes:
    """16-bit mono WAV of int16 ``pcm``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.wav")
        write_wav(path, pcm / 32767.0, sr)  # rounds back to pcm
        with open(path, "rb") as f:
            return f.read()


def flac_bytes(pcm: np.ndarray, sr: int, blocksize: int = 4096) -> bytes:
    """16-bit mono FLAC of int16 ``pcm`` in VERBATIM subframes, written with
    numpy (the fixture encoder writes bit by bit, too slow for minutes of
    audio); CRC fields zero-filled, as the fixture encoder leaves them."""
    si = BitWriter()
    for value, bits in ((blocksize, 16), (blocksize, 16), (0, 24), (0, 24), (sr, 20),
                        (0, 3), (15, 5), (len(pcm), 36)):
        si.write(value, bits)
    body = si.getvalue() + b"\x00" * 16  # md5 zeros
    out = [b"fLaC", bytes([0x80]) + len(body).to_bytes(3, "big") + body]
    for idx, start in enumerate(range(0, len(pcm), blocksize)):
        block = pcm[start : start + blocksize]
        hdr = BitWriter()
        # sync, fixed blocksize, 16-bit blocksize-1 at the end, rate from
        # STREAMINFO, mono, 16-bit samples
        for value, bits in ((0x3FFE, 14), (0, 2), (7, 4), (0, 4), (0, 4), (4, 3), (0, 1)):
            hdr.write(value, bits)
        out += [hdr.getvalue(), chr(idx).encode("utf-8"),  # the frame number, UTF-8 coded
                (len(block) - 1).to_bytes(2, "big"), b"\x00",  # crc8
                b"\x02",  # subframe: VERBATIM, no wasted bits
                block.astype(">i2").tobytes(), b"\x00\x00"]  # crc16
    return b"".join(out)


def container_bytes(pcm: np.ndarray, sr: int, container: str) -> bytes:
    return flac_bytes(pcm, sr) if container == "flac" else wav_bytes(pcm, sr)


def write_librispeech(root: str, utts: Sequence[Tuple[str, np.ndarray, int, str, str]],
                      corrupt: Sequence[str] = ()) -> str:
    """Write each (id, int16 pcm, sr, container, text) as ``{root}/{id}.{container}``
    and the manifest ``{root}/manifest.json`` ([{"id", "audio", "text"}]);
    each id in ``corrupt`` gets a file no decoder accepts. Returns the
    manifest's path."""
    os.makedirs(root, exist_ok=True)
    manifest = []
    for uid, pcm, sr, container, text in utts:
        path = os.path.join(root, f"{uid}.{container}")
        with open(path, "wb") as f:
            f.write(CORRUPT if uid in corrupt else container_bytes(pcm, sr, container))
        manifest.append({"id": uid, "audio": path, "text": text})
    out = os.path.join(root, "manifest.json")
    with open(out, "w") as f:
        json.dump(manifest, f)
    return out


def audio_cell(pcm: np.ndarray, sr: int, layout: str, path: Optional[str] = None) -> Dict:
    """An HF parquet audio cell of int16 ``pcm``: ``array`` (float32 samples
    in [-1, 1] and the rate), ``wav`` / ``flac`` (``{'bytes', 'path'}``) or
    ``path`` (``{'bytes': None, 'path'}``; the WAV is written to ``path``)."""
    if layout == "array":
        return {"array": (pcm / 32768.0).astype(np.float32), "sampling_rate": sr}
    if layout == "path":
        with open(path, "wb") as f:
            f.write(wav_bytes(pcm, sr))
        return {"bytes": None, "path": path}
    return {"bytes": container_bytes(pcm, sr, layout), "path": f"clip.{layout}"}


def mls_rows(rng, speakers: Sequence[str], books: Sequence[str], per_book: int,
             seconds: Tuple[float, float], sr: int = 16_000, layouts=("flac", "array"),
             gap_every: int = 0) -> List[Dict]:
    """MLS stage-1 rows: per (speaker, book), ``per_book`` utterances of
    ``seconds`` (lo, hi) cut from one original file with consecutive
    begin/end times (a 1 s gap after every ``gap_every``-th one); cells
    alternate over ``layouts``."""
    rows = []
    for spk in speakers:
        for book in books:
            t = 0.0
            for i in range(per_book):
                dur = round(float(rng.uniform(*seconds)), 2)
                pcm = tone_pcm(rng, dur, sr)
                rows.append({
                    "speaker_id": spk,
                    "book_id": book,
                    "transcript": f"{spk} {book} line {i}",
                    "begin_time": round(t, 2),
                    "end_time": round(t + dur, 2),
                    "original_path": f"{spk}/{book}/{spk}_{book}.flac",
                    "audio": audio_cell(pcm, sr, layouts[len(rows) % len(layouts)]),
                })
                t += dur + (1.0 if gap_every and (i + 1) % gap_every == 0 else 0.05)
    return rows


def write_emilia_tar(path: str, shard: str, members: Sequence[Tuple[str, bytes, Dict]]) -> str:
    """A tar of ``{shard}/{uid}.{wav|flac|mp3}`` audio + ``{shard}/{uid}.json``
    metadata members from (file name, payload, metadata) triples."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, shard)
        os.makedirs(src)
        for name, payload, meta in members:
            with open(os.path.join(src, name), "wb") as f:
                f.write(payload)
            with open(os.path.join(src, os.path.splitext(name)[0] + ".json"), "w") as f:
                json.dump(meta, f)
        with tarfile.open(path, "w") as tf:
            tf.add(src, arcname=shard)
    return path
