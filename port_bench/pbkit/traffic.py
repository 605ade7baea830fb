"""The one general generator that every traffic file is read by.

A mix fixes its sizes with its own ``sizes_seed``: every ``--seed`` sends
the same lengths, so a run's work does not change with the seed. The seed
draws the audio, and the order of the utterances within each call or of
the chunk lists within each sub-shard. Audio is drawn on the device in one
call per set and handed to the program as int16 host arrays, the wire
format of the corpora.

``engine_sets`` follows the program's ``benchmark.engine_workload``
(lognormal lengths, Gaussian int16 content at 0.3 of full scale, now
clipped to the int16 range). ``build_mirror`` follows its
``benchmark.build_mirror`` (a YODAS2-layout tree of ``{sid}.tar.gz`` WAV
tars and ``{sid}.json`` chunk lists; a tone plus noise per file;
centisecond chunk spans drawn lognormal), with the source rates cycled
per file and the tar written at a low gzip level.
"""

from __future__ import annotations

import io
import json
import os
import struct
import tarfile
from typing import Dict, List

import numpy as np
import torch


def _generator(seed: int, device, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def lengths(spec: Dict, n: int, sizes_seed: int) -> np.ndarray:
    """``n`` lengths in the spec's unit from a lognormal clipped to
    [min, max], drawn from ``sizes_seed``."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    rng = np.random.default_rng(sizes_seed)
    return np.clip(rng.lognormal(spec["mean"], spec["sigma"], size=n), spec["min"], spec["max"])


def _noise_int16(total: int, amplitude: float, gen: torch.Generator, device) -> np.ndarray:
    x = torch.randn(total, generator=gen, device=device) * (amplitude * 32767.0)
    return x.clamp_(-32768, 32767).to(torch.int16).cpu().numpy()


def engine_sets(mix: Dict, seed: int, device) -> List[List[np.ndarray]]:
    """``distinct_sets`` lists of ``utterances`` int16 arrays at the mix's
    rate: the same lengths in every set and for every seed, each set in
    its own seeded order with its own seeded content."""
    n = mix["utterances"]
    spec = mix["lengths"]
    seconds = lengths(spec, n, mix["sizes_seed"]) * {"s": 1.0, "cs": 0.01}[spec["unit"]]
    lens = (seconds * mix["sample_rate"]).astype(np.int64)
    order = np.random.default_rng([int(seed) % (1 << 63), 1])
    gen = _generator(seed, device, 1)
    sets = []
    for _ in range(mix["distinct_sets"]):
        ls = lens[order.permutation(n)]
        flat = _noise_int16(int(ls.sum()), mix["amplitude"], gen, device)
        ends = np.cumsum(ls)
        sets.append([flat[e - m: e] for e, m in zip(ends, ls)])
    return sets


def mirror_layout(mix: Dict, seed: int) -> List[List[Dict]]:
    """Per sub-shard, per file: its audio id, source rate, length and
    chunk ids. Chunk lists are drawn once from ``sizes_seed``; the seed
    only permutes them among the files of a sub-shard."""
    rng = np.random.default_rng(mix["sizes_seed"])
    perm = np.random.default_rng([int(seed) % (1 << 63), 2])
    secs = mix["file_seconds"]
    spec = mix["chunks"]
    rates = mix["source_rates"]
    out = []
    for s in range(mix["subshards"]):
        sid = f"{s:08d}"
        spans = []
        for _ in range(mix["files_per_subshard"]):
            pos, one = 0, []
            while pos < secs * 100 - 200:
                dur = int(np.clip(rng.lognormal(spec["mean"], spec["sigma"]), spec["min"], spec["max"]))
                end = min(pos + dur, int(secs * 100))
                one.append((pos, end))
                pos = end
            spans.append(one)
        files = []
        for a, k in enumerate(perm.permutation(len(spans))):
            aid = f"vid-{sid}-{a}"
            files.append({
                "audio_id": aid,
                "rate": rates[a % len(rates)],
                "samples": int(secs * rates[a % len(rates)]),
                "chunks": [f"{aid}-{i:05d}-{p:08d}-{e:08d}" for i, (p, e) in enumerate(spans[k])],
            })
        out.append(files)
    return out


def file_audio(mix: Dict, seed: int, sub: int, idx: int, f: Dict, device) -> np.ndarray:
    """One mirror file's int16 samples: a tone at ``base_hz + step_hz *
    idx`` plus Gaussian noise, drawn from the seed and the file's place."""
    gen = _generator(seed, device, 1000 + sub * 1000 + idx)
    n, rate = f["samples"], f["rate"]
    t = torch.arange(n, device=device, dtype=torch.float64) / rate
    tone = mix["tone"] * torch.sin(2 * np.pi * (mix["base_hz"] + mix["step_hz"] * idx) * t)
    x = tone.float() + mix["noise"] * torch.randn(n, generator=gen, device=device)
    return (x * 32767.0).clamp_(-32768, 32767).to(torch.int16).cpu().numpy()


def wav_bytes(x: np.ndarray, rate: int) -> bytes:
    """A mono 16-bit PCM RIFF/WAVE file."""
    data = x.astype("<i2").tobytes()
    head = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(data), b"WAVE", b"fmt ", 16, 1, 1,
        rate, rate * 2, 2, 16, b"data", len(data),
    )
    return head + data


def build_mirror(root: str, mix: Dict, seed: int, device) -> Dict:
    """Write the mirror under ``root/<shard>/`` and return its layout and
    every file's samples by audio id."""
    layout = mirror_layout(mix, seed)
    sdir = os.path.join(root, mix["shard_id"])
    os.makedirs(sdir, exist_ok=True)
    audio: Dict[str, np.ndarray] = {}
    for s, files in enumerate(layout):
        sid = f"{s:08d}"
        meta = []
        with tarfile.open(os.path.join(sdir, f"{sid}.tar.gz"), "w:gz",
                          compresslevel=mix["gzip_level"]) as tf:
            for a, f in enumerate(files):
                x = file_audio(mix, seed, s, a, f, device)
                audio[f["audio_id"]] = x
                body = wav_bytes(x, f["rate"])
                info = tarfile.TarInfo(f"audio/{f['audio_id']}.wav")
                info.size = len(body)
                tf.addfile(info, io.BytesIO(body))
                meta.append({"audio_id": f["audio_id"],
                             "text": {c: f"chunk {i}" for i, c in enumerate(f["chunks"])}})
        with open(os.path.join(sdir, f"{sid}.json"), "w") as fh:
            json.dump(meta, fh)
    return {"layout": layout, "audio": audio}
