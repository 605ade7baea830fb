"""Within-process A/B probe: drain_policy fifo/ready/threaded at depth 18.

The engine collects in-flight device batches strictly FIFO by default,
waiting on the oldest copy to the host. The "ready" policy collects
whichever in-flight batch's copy has landed first, overlapping that wait
with still-computing batches; "threaded" hands collection to a pool of
fetch threads. Decision discipline: all engines in ONE process,
interleaved per round (order re-randomized), medians decide; bit-equality
asserted first.

Usage: python -m tokenize_audio_tpu_torch.scripts.drain_policy_probe
           [rounds] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics

import numpy as np

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.engine.metrics import EngineStats
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", nargs="?", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rounds = args.rounds

    dev = resolve_device(args.device)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)

    audios, total_s = probe_common.bench_audios(256)

    base = EngineConfig(
        min_bucket_seconds=2.0,
        bucket_growth=1.25,
        samples_per_batch=192 * 24_000,
        max_batch_size=128,
    )

    def engine(policy):
        ecfg = dataclasses.replace(base, drain_policy=policy)
        return MimiEncoderEngine(params, cfg, ecfg, pipeline_depth=18, device=dev)

    engines = {p: engine(p) for p in ("fifo", "ready", "threaded")}

    codes = probe_common.warm_and_check_equal(engines, audios)

    results = {k: [] for k in engines}
    order_rng = np.random.default_rng(1)
    names = list(engines)
    stages = {}
    for r in range(rounds):
        order_rng.shuffle(names)
        for name in names:
            eng = engines[name]
            eng.stats = EngineStats()
            results[name].append(probe_common.timed_pass(eng, audios, total_s))
            stages[name] = {
                k: round(v, 3) for k, v in eng.stats.stage_seconds.items()
            }
        print(
            f"round {r}: "
            + "  ".join(f"{n}={results[n][-1]:.0f}x" for n in sorted(results)),
            flush=True,
        )

    print("\nmedians over", rounds, "rounds:")
    for name in sorted(results):
        med = statistics.median(results[name])
        print(
            f"  {name}: {med:.0f}x (spread {min(results[name]):.0f}-"
            f"{max(results[name]):.0f})  stages {stages[name]}"
        )
    return {
        "device": device_name(dev),
        "audio_seconds": total_s,
        "rounds": rounds,
        "median_x_realtime": {n: statistics.median(xs) for n, xs in results.items()},
        "all": results,
        "last_round_stages": stages,
        "codes": codes,
    }


if __name__ == "__main__":
    main()
