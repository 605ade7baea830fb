"""Within-process A/B: YODAS2 fetch_ahead 0 vs 1 on the full pipeline.

Same synthetic mirror and engine as the pipeline benchmark
(``benchmark.build_mirror``); alternates the two configurations
round-robin in ONE process and reports medians (cross-run walls on a
shared host carry too much noise; only interleaved comparisons count).
Every run must process all 4 sub-shards; each run's hub is digested, so
a caller can hold the runs' codes equal.

Usage: python -m tokenize_audio_tpu_torch.scripts.fetch_ahead_probe
           [rounds] [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import shutil
import statistics
import tempfile
import time

from tokenize_audio_tpu_torch.benchmark import build_mirror
from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.datasets.yodas2 import LocalSource, Yodas2ShardProcessor
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import LocalHub
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name


def hub_digest(root: str) -> str:
    """sha256 over every file a hub holds, in path order."""
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", nargs="?", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rounds = args.rounds

    dev = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="fa_probe_")
    try:
        mirror = os.path.join(tmp, "mirror")
        total_audio, n_chunks = build_mirror(mirror, "en000", 4, 6, 90)
        print(f"{total_audio/3600:.2f} h audio, {n_chunks} chunks", flush=True)

        cfg = MimiConfig()
        engine = MimiEncoderEngine(
            random_params(cfg, seed=0),
            cfg,
            EngineConfig(
                min_bucket_seconds=2.0,
                bucket_growth=1.45,
                samples_per_batch=192 * 24_000,
                max_batch_size=128,
            ),
            num_codebooks=cfg.num_quantizers,
            device=dev,
        )
        processed, digests = {}, {}

        def run(tag, ahead):
            hub = os.path.join(tmp, f"hub_{tag}")
            proc = Yodas2ShardProcessor(
                "en000",
                LocalSource(mirror),
                LocalHub(hub),
                engine,
                os.path.join(tmp, f"work_{tag}"),
                os.path.join(tmp, f"prog_{tag}"),
                max_subshards=4,
                max_consecutive_missing=2,
                upload_batch_size=2,
                fetch_ahead=ahead,
            )
            t0 = time.perf_counter()
            rep = proc.process()
            assert rep["processed"] == 4, rep
            wall = time.perf_counter() - t0
            processed[tag], digests[tag] = rep["processed"], hub_digest(hub)
            return total_audio / wall

        run("warm", 1)  # first use + warm
        results = {0: [], 1: []}
        for r in range(rounds):
            for ahead in (0, 1):
                results[ahead].append(run(f"r{r}a{ahead}", ahead))
            print(
                f"round {r}: serial={results[0][-1]:.0f}x ahead1={results[1][-1]:.0f}x",
                flush=True,
            )
        for ahead in (0, 1):
            print(
                f"fetch_ahead={ahead}: median {statistics.median(results[ahead]):.1f}x "
                f"(min {min(results[ahead]):.0f}, max {max(results[ahead]):.0f})"
            )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {
        "device": device_name(dev),
        "audio_seconds": total_audio,
        "chunks": n_chunks,
        "rounds": rounds,
        "median_x_realtime": {a: statistics.median(xs) for a, xs in results.items()},
        "all": results,
        "processed": processed,
        "hub_digests": digests,
    }


if __name__ == "__main__":
    main()
