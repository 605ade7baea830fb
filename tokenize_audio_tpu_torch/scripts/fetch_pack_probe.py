"""Interleaved A/B of the device->host code wire formats.

The padded (B, K, T_bucket) int32 copy ships bucket pad and row pad at
32 bits per 11-bit code. Candidates (mimi.model.encode ``transfer``):

  padded  — (B, K, T_bucket) in the engine's code dtype.
  packed  — 2 codes per int32 word (16-bit aligned), host unpack = free
            little-endian view. Halves bytes.
  compact — packed + valid frames gathered to the front on the card; the
            engine copies a 16-step-lattice-padded prefix only.

The formats are pure transport: bit-equality across them is asserted
before timing. Re-probe per machine (compact's byte savings should win
where the per-copy latency is low).

Usage: python -m tokenize_audio_tpu_torch.scripts.fetch_pack_probe
           [--rounds 5] [--utts 192] [--growth 1.45] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--utts", type=int, default=192)
    ap.add_argument("--growth", type=float, default=1.45)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev), flush=True)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)

    def engine(fmt):
        return MimiEncoderEngine(
            params,
            cfg,
            EngineConfig(
                min_bucket_seconds=2.0,
                bucket_growth=args.growth,
                samples_per_batch=192 * 24_000,
                max_batch_size=128,
                code_transfer_format=fmt,
            ),
            device=dev,
        )

    engines = {f: engine(f) for f in ("padded", "packed", "compact")}
    audios, total_s = probe_common.bench_audios(args.utts)
    print(f"workload: {args.utts} utts / {total_s:.0f} s audio", flush=True)
    codes = probe_common.warm_and_check_equal(engines, audios)
    print("all formats bit-equal; timing ...", flush=True)

    results, stages = probe_common.interleaved_rounds(
        engines, audios, total_s, args.rounds
    )
    report = {
        name: {
            "median_x_realtime": round(float(np.median(xs)), 1),
            "all": [round(x, 1) for x in xs],
            "last_round_stages": stages[name],
        }
        for name, xs in results.items()
    }
    print("RESULT " + json.dumps(report))
    return {"device": device_name(dev), "audio_seconds": total_s, "result": report,
            "codes": codes}


if __name__ == "__main__":
    main()
