"""Census of the fused-resample split-boundary deviation.

For >60 s source-rate audio the fused path splits at the SOURCE rate and
resamples each piece inside its encode call, so the polyphase filter sees
zeros past each piece edge instead of neighboring samples — the last (and
first) few frames of a piece can differ from a resample-whole-then-split
order (the deviation contract in ``core/audio.py``'s docstring). This
measures HOW MANY frames per boundary actually differ on the card, for
16 kHz and 48 kHz long audio:

  path A (production): engine.encode_batch([src], sr=src_rate)
                       -- split at source rate, fused per-piece resample
  path B (oracle order): resample the WHOLE signal to 24 kHz first, then
                       engine.encode_batch([x24], sr=24000)

Both paths split at the same frame-aligned 60 s boundaries, and each
piece's encode is exact given its input samples, so every A/B diff is
attributable to resample ordering at piece edges. Reported per boundary:
diff frames on each side and the max distance (frames) of any diff from
its boundary. Usage:

    python -m tokenize_audio_tpu_torch.scripts.split_boundary_census
        [--seconds 150] [--seeds 0,1,2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.core.audio import pcm_to_float, resample
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name


def census(engine, src_rate: int, seconds: float, seed: int) -> dict:
    rng = np.random.default_rng(seed * 31 + src_rate)
    t = np.arange(int(seconds * src_rate)) / src_rate
    # broadband + tonal mix with transition-band energy (the worst case
    # for filter-edge effects, per resampler_sensitivity.py)
    x = (
        0.25 * np.sin(2 * np.pi * 220 * t)
        + 0.15 * np.sin(2 * np.pi * (0.40 * src_rate) * t)
        + 0.1 * rng.standard_normal(len(t))
    ).astype(np.float32)

    a = engine.encode_batch([x], sr=src_rate)[0]  # fused split-then-resample
    x24 = resample(pcm_to_float(x), src_rate, 24_000, device=engine.device).cpu().numpy()
    b = engine.encode_batch([x24], sr=24_000)[0]  # resample-whole-then-split
    assert a.shape == b.shape, (a.shape, b.shape)

    frames_per_piece = int(
        engine.engine_cfg.max_chunk_seconds * 24_000 / engine.cfg.samples_per_frame
    )
    n_frames = a.shape[1]
    diff = np.nonzero((a != b).any(axis=0))[0]
    boundaries = list(range(frames_per_piece, n_frames, frames_per_piece))
    per_boundary = []
    for bd in boundaries:
        before = int(((diff < bd) & (diff >= bd - frames_per_piece // 2)).sum())
        after = int(((diff >= bd) & (diff < bd + frames_per_piece // 2)).sum())
        per_boundary.append({"frame": bd, "before": before, "after": after})
    max_dist = (
        int(min(min(abs(d - bd) for bd in boundaries) for d in diff))
        if len(diff) and boundaries
        else None
    )
    worst = (
        int(max(min(abs(d - bd) for bd in boundaries) for d in diff))
        if len(diff) and boundaries
        else None
    )
    return {
        "src_rate": src_rate,
        "seed": seed,
        "frames": n_frames,
        "boundaries": len(boundaries),
        "diff_frames": int(len(diff)),
        "diff_frames_per_boundary": round(len(diff) / max(len(boundaries), 1), 2),
        "per_boundary": per_boundary,
        "max_frame_distance_from_boundary": worst,
        "min_frame_distance_from_boundary": max_dist,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=150.0)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--rates", default="16000,48000")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)
    engine = MimiEncoderEngine(
        params,
        cfg,
        EngineConfig(min_bucket_seconds=2.0, samples_per_batch=192 * 24_000),
        device=dev,
    )
    print("device:", device_name(dev), flush=True)

    rows = []
    for rate in (int(r) for r in args.rates.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            rep = census(engine, rate, args.seconds, seed)
            rows.append(rep)
            print(json.dumps(rep), flush=True)
    total_b = sum(r["boundaries"] for r in rows)
    total_d = sum(r["diff_frames"] for r in rows)
    result = {
        "census_rows": len(rows),
        "total_boundaries": total_b,
        "total_diff_frames": total_d,
        "mean_diff_frames_per_boundary": round(total_d / max(total_b, 1), 2),
        "worst_distance_frames": max(
            (r["max_frame_distance_from_boundary"] or 0) for r in rows
        ),
    }
    print("RESULT " + json.dumps(result))
    return result, rows


if __name__ == "__main__":
    main()
