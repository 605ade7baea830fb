"""Volume parity sweep: the port's engine codes (on the card unless
``--device cpu``) vs HF torch on the CPU, many random utterances across the
length distribution. Prints one JSON summary line.

Usage: python -m tokenize_audio_tpu_torch.scripts.parity_sweep
           [--n 100] [--seed 0] [--device cpu]
(Uses the seeded random-weight oracle, ``parity_census.oracle``.)
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.scripts import device_name
from tokenize_audio_tpu_torch.scripts.parity_census import oracle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-seconds", type=float, default=20.0)
    ap.add_argument("--min-seconds", type=float, default=0.2)
    ap.add_argument(
        "--sensitive",
        action="store_true",
        help="mask-sensitive oracle (LayerScale 1.0, boosted init) — makes "
        "attention-mask bugs visible at production scale (the default "
        "LayerScale 0.01 oracle hides them below the RVQ argmin threshold)",
    )
    ap.add_argument(
        "--int16",
        action="store_true",
        help="feed the engine raw int16 PCM (device-side normalization "
        "path) while torch gets the equivalent floats",
    )
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    hf_cfg = None
    if args.sensitive:
        from transformers import MimiConfig as HFMimiConfig

        hf_cfg = HFMimiConfig(layer_scale_initial_scale=1.0, initializer_range=0.1)
    model, params, cfg = oracle(hf_cfg=hf_cfg)
    engine = MimiEncoderEngine(
        params,
        cfg,
        EngineConfig(min_bucket_seconds=1.0, bucket_growth=1.7, samples_per_batch=96 * 24_000),
        device=dev,
    )

    rng = np.random.default_rng(args.seed)
    lengths = np.clip(
        rng.lognormal(mean=1.2, sigma=0.9, size=args.n), args.min_seconds, args.max_seconds
    )
    if args.min_seconds > 2:  # long-sweep mode: spread uniformly instead
        lengths = rng.uniform(args.min_seconds, args.max_seconds, size=args.n)
    audios = [
        (rng.standard_normal(int(s * 24_000)) * 0.3).astype(np.float32) for s in lengths
    ]
    if args.int16:
        # production wire format: engine gets raw int16 (normalized
        # on-device), torch gets the equivalent floats — must still match
        inputs = [(a * 32767).astype(np.int16) for a in audios]
        audios = [p.astype(np.float32) / 32768.0 for p in inputs]
    else:
        inputs = audios
    got = engine.encode_batch(inputs)

    total_frames = exact_frames = 0
    exact_utts = 0
    for a, g in zip(audios, got):
        with torch.no_grad():
            ref = (
                model.encode(torch.from_numpy(a)[None, None, :])
                .audio_codes[0, :8]
                .numpy()
            )
        eq = (g == ref).all(axis=0)
        total_frames += eq.size
        exact_frames += int(eq.sum())
        exact_utts += int(eq.all())
    report = {
        "utterances": args.n,
        "audio_seconds": round(float(sum(lengths)), 1),
        "frames": total_frames,
        "frame_exact_match": exact_frames / total_frames,
        "utterance_exact_match": exact_utts / args.n,
        "device": device_name(dev),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
