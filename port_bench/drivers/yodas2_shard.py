"""Driver of the YODAS2 shard cells: ``Yodas2ShardProcessor.process`` end
to end over a seeded local mirror, in a closed loop. A unit of work is one
pass over the whole shard with a fresh hub, work and progress directory;
the engine is built once, as a worker keeps it across shards.

The check reads back what each pass published to its hub: every chunk id
the mirror's lists name, none more, each with codes of the right shape and
range; and, for a sample of the window's chunks drawn from the seed (the
longest among them), compares the codes with the plain reference, which
takes the file's samples, resamples them to 24 kHz, slices the chunk and
encodes it again.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from pbkit import checks, program, traffic
from reference import chunks_ref, resample_ref

RATE = 24_000


def setup(run) -> None:
    mix, p = run.mix, run.params
    run.mirror_dir = os.path.join(run.workdir, "mirror")
    run.mirror = traffic.build_mirror(run.mirror_dir, mix, run.seed, run.device)
    run.expected = {}  # chunk id -> (audio id, first sample, end) at 24 kHz
    for files in run.mirror["layout"]:
        for f in files:
            n24 = -(-f["samples"] * RATE // f["rate"])
            for cid in f["chunks"]:
                b = chunks_ref.bounds(cid, RATE, n24)
                if b is not None:
                    run.expected[cid] = (f["audio_id"], f["rate"]) + b
    run.pass_rows = [b - a for _, _, a, b in run.expected.values()]
    run.pass_audio_s = sum(run.pass_rows) / RATE
    run.engine = program.build_engine(run, p["engine"])
    # warm-up: one pass of the cell's own traffic; every pass launches the
    # same batch shapes
    _process(run, "warm")


def _process(run, tag: str) -> dict:
    from tokenize_audio_tpu_torch.datasets.yodas2 import LocalSource, Yodas2ShardProcessor
    from tokenize_audio_tpu_torch.hub import LocalHub

    p = run.params
    d = os.path.join(run.workdir, tag)
    proc = Yodas2ShardProcessor(
        run.mix["shard_id"], LocalSource(run.mirror_dir), LocalHub(os.path.join(d, "hub")),
        run.engine, os.path.join(d, "work"), os.path.join(d, "progress"),
        upload_batch_size=p["upload_batch_size"], fetch_ahead=p["fetch_ahead"],
    )
    return {"dir": d, "report": proc.process()}


def reset_stats(run) -> None:
    from tokenize_audio_tpu_torch.engine import EngineStats

    run.engine.stats = EngineStats()


def stats(run):
    return run.engine.stats


def span_targets(run) -> list:
    from tokenize_audio_tpu_torch.datasets.yodas2 import SubShardProcessor, Yodas2ShardProcessor

    return [
        (run.engine, "encode_batch", "engine.encode_batch"),
        (run.engine, "_dispatch", "engine.dispatch"),
        (run.engine, "_collect", "engine.collect"),
        (SubShardProcessor, "_extract", "processor.extract"),
        (SubShardProcessor, "_load_entry_audio", "processor.decode"),
        (SubShardProcessor, "process_entries_deferred", "processor.slice_dispatch"),
        (Yodas2ShardProcessor, "_flush", "processor.upload"),
    ]


def unit(run, i: int) -> dict:
    out = _process(run, f"pass{i}")
    out.update(audio_s=run.pass_audio_s, items=len(run.expected), rows=run.pass_rows)
    return out


def release(run) -> None:
    run.engine = None


def _published(run, d: str) -> dict:
    """chunk id -> codes (K, frames) of every entry the pass published."""
    root = os.path.join(d, "hub", "data", run.mix["shard_id"])
    out = {}
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        with open(os.path.join(root, name)) as f:
            for entry in json.load(f):
                out.update(entry.get("codes", {}))
    return out


def _audio24(run, aid: str, rate: int, cache: dict) -> torch.Tensor:
    if aid not in cache:
        x = torch.from_numpy(run.mirror["audio"][aid]).to(run.device).double() / 32768.0
        if rate != RATE:
            g = math.gcd(rate, RATE)
            x = resample_ref.resample_poly(x, RATE // g, rate // g)
        cache[aid] = x.float()
    return cache[aid]


def check(run) -> dict:
    ref = checks.Reference(run)
    bad = missing = 0
    pool, lens, got = [], [], {}
    for k, u in enumerate(run.units + run.traced_units):
        pub = _published(run, u["dir"])
        missing += len(set(run.expected) ^ set(pub))
        for cid, codes in pub.items():
            if cid not in run.expected:
                continue
            _, _, a, b = run.expected[cid]
            if not ref.well_formed(codes, b - a):
                bad += 1
            elif k < len(run.units):
                pool.append((k, cid))
                lens.append(b - a)
                got[(k, cid)] = codes
    gaps, cache = [], {}
    for key in checks.sample(run, pool, lens):
        aid, rate, a, b = run.expected[key[1]]
        gaps.append(ref.gap(_audio24(run, aid, rate, cache)[a:b], np.asarray(got[key])))
    attempted = len(run.expected) * len(run.units)
    return ref.result(gaps, bad, attempted, missing + run.missing)
