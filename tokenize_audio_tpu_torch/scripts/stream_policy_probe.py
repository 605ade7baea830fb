"""Long-audio policy A/B on the card: exact multiplexed streaming vs the
reference's 60 s split+concat, on batches of >60 s utterances.

``long_audio_policy="stream"`` gives EXACT codes for long audio (no
receptive-field cuts at the 60 s seams — the reference accepts that
approximation, yodas2-mimi/process_shard.py:436-493) by running the
carried-state streaming encoder, multiplexed ``stream_batch`` rows at a
time. Its CPU bit-equality is pinned by tests; this probe measures what
the exactness COSTS on the card so an operator can say when it is
affordable. Interleaved rounds within one process, as all probes (never
compare across runs).

Usage: python -m tokenize_audio_tpu_torch.scripts.stream_policy_probe
           [--n 8] [--seconds 320] [--rounds 3] [--stream-batch 8]
           [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=320.0)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--stream-batch", type=int, default=8)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)
    engine = MimiEncoderEngine(
        params,
        cfg,
        EngineConfig(
            min_bucket_seconds=2.0,
            bucket_growth=1.25,
            samples_per_batch=192 * 24_000,
            max_batch_size=128,
            stream_batch=args.stream_batch,
        ),
        device=dev,
    )

    rng = np.random.default_rng(0)
    sr = 24_000
    audios = [
        (rng.standard_normal(int(args.seconds * sr)) * 0.3 * 32767).astype(np.int16)
        for _ in range(args.n)
    ]
    total_s = sum(len(a) for a in audios) / sr

    def set_policy(p):
        engine.engine_cfg = dataclasses.replace(engine.engine_cfg, long_audio_policy=p)

    timings = {"split": [], "stream": []}
    codes = {}
    for rnd in range(args.rounds + 1):  # round 0 = warm (first use), dropped
        for policy in ("split", "stream"):
            set_policy(policy)
            t0 = time.perf_counter()
            codes[policy] = engine.encode_batch(audios)
            if rnd > 0:
                timings[policy].append(time.perf_counter() - t0)

    # frame counts agree; code agreement shows the seam effect the split
    # path accepts (interior frames match, seam-adjacent frames may not)
    eq_frames = tot_frames = 0
    for s, st in zip(codes["split"], codes["stream"]):
        assert s.shape == st.shape, (s.shape, st.shape)
        eq = (s == st).all(axis=0)
        tot_frames += eq.size
        eq_frames += int(eq.sum())
    agree = eq_frames / tot_frames

    med = {p: float(np.median(ts)) for p, ts in timings.items()}
    report = {
        "probe": "long_audio_policy",
        "n_utts": args.n,
        "seconds_each": args.seconds,
        "stream_batch": args.stream_batch,
        "split_x_realtime": round(total_s / med["split"], 1),
        "stream_x_realtime": round(total_s / med["stream"], 1),
        "stream_cost_ratio": round(med["stream"] / med["split"], 3),
        "split_seconds": [round(t, 3) for t in timings["split"]],
        "stream_seconds": [round(t, 3) for t in timings["stream"]],
        "code_agreement_split_vs_stream": round(agree, 5),
        "device": device_name(dev),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
