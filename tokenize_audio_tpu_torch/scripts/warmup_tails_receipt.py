"""Time the COMPLETE tail-ladder warmup on the card.

Provisioning runs ``--warmup --warmup-tails`` before a host's first shard;
this runs ``engine.warmup(include_tails=True)`` for the 24/16/48 kHz
lattices (exactly the batch-shape set the dataset CLIs warm) on the
production bench config and reports batch shapes ("programs") and wall per
lattice, so an operator can budget the step.

On the card a warmed batch shape is not a compiled program: each shape
runs one encode, and what the first run of a shape costs is cuDNN's
algorithm choice for its convs and the caching allocator's first
allocations, plus, the first time in a process, the kernels' first-use
build (``nvcc``, or a load of the libraries ``ops/cuda/_build`` cached).
The first JSON line says which cost this run includes:
``kernels_built_before`` (every kernel library already on disk) and
``kernels_loaded_before`` (already loaded in this process). Run it twice
in one process for the warm cost (a rerun).

Usage: python -m tokenize_audio_tpu_torch.scripts.warmup_tails_receipt
           [--growth 1.25] [--no-tails] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.ops.cuda import _build
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--growth", type=float, default=None)
    ap.add_argument("--no-tails", action="store_true", help="full-batch set only")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    built = all(_build.library_path(k).is_file() for k in _build.KERNELS)
    loaded = all(k in _build._libs for k in _build.KERNELS)
    kw = {}
    if args.growth is not None:
        kw["bucket_growth"] = args.growth
    ecfg = EngineConfig(
        min_bucket_seconds=2.0, samples_per_batch=192 * 24_000, max_batch_size=128, **kw
    )
    cfg = MimiConfig()
    t0 = time.perf_counter()
    engine = MimiEncoderEngine(random_params(cfg, seed=0), cfg, ecfg, device=dev)
    probe_common.sync(dev)
    header = {
        "device": device_name(dev),
        "init_seconds": round(time.perf_counter() - t0, 1),
        "growth": ecfg.bucket_growth,
        "kernels_built_before": built,
        "kernels_loaded_before": loaded,
    }
    print(json.dumps(header), flush=True)
    rows = []
    for sr in (24_000, 16_000, 48_000):
        t0 = time.perf_counter()
        n = engine.warmup(sr=sr, include_tails=not args.no_tails)
        probe_common.sync(dev)
        rows.append(
            {"sr": sr, "programs": n, "wall_seconds": round(time.perf_counter() - t0, 1)}
        )
        print(json.dumps(rows[-1]), flush=True)
    result = {
        "include_tails": not args.no_tails,
        "total_programs": sum(r["programs"] for r in rows),
        "total_wall_seconds": round(sum(r["wall_seconds"] for r in rows), 1),
        "per_lattice": rows,
    }
    print("RESULT " + json.dumps(result))
    return {**header, "result": result}


if __name__ == "__main__":
    main()
