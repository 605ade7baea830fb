"""Multi-seed parity census: the port's engine codes (on the card unless
``--device cpu``) vs HF torch on the CPU across ~10 independently-seeded
random-weight oracles, with per-flip argmin-margin forensics. Prints one
JSON line per seed plus a final summary line.

Turns the exactness contract's residue ("~1e-4-margin argmin ties") into a
measured flip-RATE bound: flips per 10k frames across the census, and the
relative distance margin |d_a - d_b| / max(...) of EVERY flip, computed in
f64 from the torch latent at the first differing codebook level (prefix
books are identical by construction, so the residual chain up to the flip
is common; ``qualify._flip_margin``). The oracle is ``qualify._random_oracle``
(HF default config, eager attention, codebook buffers filled).

Usage: python -m tokenize_audio_tpu_torch.scripts.parity_census
           [--seeds 0,1,...,9] [--n 80] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from tokenize_audio_tpu_torch import qualify
from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import config_from_hf, params_from_torch_model
from tokenize_audio_tpu_torch.scripts import device_name


def oracle(seed: int = 0, hf_cfg=None):
    """(HF model, port params, port config) of the seeded random oracle."""
    model = qualify._random_oracle(seed, hf_cfg)
    return model, params_from_torch_model(model), config_from_hf(model.config)


def census_seed(seed: int, n: int, max_seconds: float, engine_cfg, device=None) -> dict:
    model, params, cfg = oracle(seed=seed)
    engine = MimiEncoderEngine(params, cfg, engine_cfg, device=device)

    rng = np.random.default_rng(seed * 1009 + 7)
    lengths = np.clip(rng.lognormal(mean=1.2, sigma=0.9, size=n), 0.2, max_seconds)
    audios = [
        (rng.standard_normal(int(s * 24_000)) * 0.3).astype(np.float32) for s in lengths
    ]
    got = engine.encode_batch(audios)

    total = 0
    flips = []
    for u, (a, g) in enumerate(zip(audios, got)):
        with torch.no_grad():
            ref = model.encode(torch.from_numpy(a)[None, None, :]).audio_codes[0, :8].numpy()
        total += ref.shape[1]
        if (g == ref).all():
            continue
        latent = qualify._hf_latent(model, a)
        for t in np.nonzero((g != ref).any(axis=0))[0]:
            book = int(np.nonzero(g[:, t] != ref[:, t])[0][0])
            margin = qualify._flip_margin(
                model, a, int(t), book, int(g[book, t]), int(ref[book, t]), latent
            )
            flips.append(
                {"utt": u, "frame": int(t), "book": book, "rel_margin": float(f"{margin:.3g}")}
            )
    return {
        "seed": seed,
        "frames": total,
        "audio_seconds": round(float(sum(lengths)), 1),
        "flipped_frames": len(flips),
        "frame_exact": round(1 - len(flips) / total, 6),
        "flips": flips,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default=",".join(str(s) for s in range(10)))
    ap.add_argument("--n", type=int, default=80)
    ap.add_argument("--max-seconds", type=float, default=25.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ecfg = EngineConfig(
        min_bucket_seconds=1.0, bucket_growth=1.7, samples_per_batch=96 * 24_000
    )

    reports = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rep = census_seed(seed, args.n, args.max_seconds, ecfg, device=dev)
        print(json.dumps(rep), flush=True)
        reports.append(rep)

    frames = sum(r["frames"] for r in reports)
    all_flips = [f for r in reports for f in r["flips"]]
    margins = [f["rel_margin"] for f in all_flips]
    summary = {
        "census": {
            "seeds": len(reports),
            "frames": frames,
            "audio_hours": round(sum(r["audio_seconds"] for r in reports) / 3600, 2),
            "flipped_frames": len(all_flips),
            "flips_per_10k_frames": round(len(all_flips) * 1e4 / frames, 3),
            "max_rel_margin": max(margins) if margins else None,
            "median_rel_margin": float(np.median(margins)) if margins else None,
            "seeds_fully_exact": sum(1 for r in reports if not r["flips"]),
            "device": device_name(dev),
        }
    }
    print(json.dumps(summary))
    return summary, reports


if __name__ == "__main__":
    main()
