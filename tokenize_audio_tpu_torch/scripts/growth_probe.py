"""Interleaved A/B of bucket-lattice growth factors.

A host simulation says a finer lattice (growth 1.15) pads less than 1.45;
measured on the TPU, bucket_efficiency stayed flat, because finer lattices
shrink tail groups into the row-padding gaps of the batch-size ladder
(the tail-size ladder in EngineConfig.batch_size_for_group is the fix,
not the growth factor). This re-measures it on the card.

One process, growths interleaved per round, medians decide. The warm
passes must give the same codes at every growth, or, where the card's
convs sum in another order at another lattice's lengths, codes within the
qualification kit's rule (``probe_common.within_ties``: >= 0.999 of frames
equal, every flip a near-tie). Beside the JAX script's keys, each growth's
RESULT entry carries its lattice's bucket count (``buckets``).

Usage: python -m tokenize_audio_tpu_torch.scripts.growth_probe
           [--rounds 5] [--utts 192] [--growths 1.45,1.25,1.15] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--utts", type=int, default=192)
    ap.add_argument("--growths", default="1.45,1.25,1.15")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev), flush=True)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)
    growths = [float(g) for g in args.growths.split(",")]

    engines = {
        g: MimiEncoderEngine(
            params,
            cfg,
            EngineConfig(
                min_bucket_seconds=2.0,
                bucket_growth=g,
                samples_per_batch=192 * 24_000,
                max_batch_size=128,
            ),
            device=dev,
        )
        for g in growths
    }
    audios, total_s = probe_common.bench_audios(args.utts)
    print(f"workload: {args.utts} utts / {total_s:.0f} s audio", flush=True)

    codes, ties = {}, {}
    for g, eng in engines.items():
        t0 = time.perf_counter()
        codes[g] = eng.encode_batch(audios)  # warm
        print(f"warm growth={g}: {time.perf_counter()-t0:.1f}s "
              f"(buckets={len(eng.buckets)})", flush=True)
    if probe_common.codes_equal(codes):
        print("all growths bit-equal; timing ...", flush=True)
    else:
        # another lattice pads to other lengths, and the card's convs sum
        # in another order at other shapes: near-tie flips only
        ref = codes[growths[0]]
        ties = {str(g): probe_common.within_ties(engines[g], audios, codes[g], ref, f"growth {g}")
                for g in growths[1:]}
        print(f"growths within near-ties of {growths[0]}: "
              + " ".join(f"{g}={t['equal_frames']}/{t['frames']}" for g, t in ties.items())
              + "; timing ...", flush=True)

    results, stages = probe_common.interleaved_rounds(
        engines, audios, total_s, args.rounds
    )
    report = {
        str(g): {
            "median_x_realtime": round(float(np.median(xs)), 1),
            "all": [round(x, 1) for x in xs],
            "bucket_efficiency": round(engines[g].stats.bucket_efficiency, 4),
            # compute-side signal (steadier than the end-to-end wall):
            # padded frames actually encoded plus the per-stage walls —
            # less bucket pad = fewer device FLOPs
            "padded_frames": int(engines[g].stats.padded_frames),
            "stage_seconds": stages[g],
            "buckets": len(engines[g].buckets),
        }
        for g, xs in results.items()
    }
    print("RESULT " + json.dumps(report))
    return {"device": device_name(dev), "audio_seconds": total_s, "result": report,
            "bit_equal": not ties, "ties": ties, "codes": codes}


if __name__ == "__main__":
    main()
