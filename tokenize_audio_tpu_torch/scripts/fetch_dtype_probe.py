"""A/B the device->host code transfer dtype WITHIN one process.

End-to-end walls swing between runs, so int32-vs-uint16 can only be
decided by interleaved measurement in a single process. Measures (a) the
raw copy of code-shaped tensors to the host per dtype (``tensor.cpu()``
with the card idle before each copy), and (b) the full engine workload per
dtype, interleaved A/B/A/B. The dtype changes transport only: both
engines must give the same codes.

Usage: python -m tokenize_audio_tpu_torch.scripts.fetch_dtype_probe
           [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.engine.metrics import EngineStats
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev))

    # (a) raw transfer: same element count, both dtypes, interleaved
    n = 64 * 8 * 750  # a 64-row 60s-bucket batch of codes
    a32 = torch.from_numpy(np.random.randint(0, 2048, size=n, dtype=np.int32)).to(dev)
    a16 = a32.to(torch.uint16)
    probe_common.sync(dev)
    t32 = t16 = 0.0
    reps = 20
    for _ in range(reps):
        probe_common.sync(dev)
        t0 = time.perf_counter()
        np.asarray(a32.cpu())
        t32 += time.perf_counter() - t0
        probe_common.sync(dev)
        t0 = time.perf_counter()
        np.asarray(a16.cpu())
        t16 += time.perf_counter() - t0
    print(
        f"raw device_get x{reps}: int32 {t32:.3f}s ({n*4*reps/t32/1e6:.0f} MB/s) "
        f"uint16 {t16:.3f}s ({n*2*reps/t16/1e6:.0f} MB/s)"
    )
    raw_equal = bool(np.array_equal(a32.cpu().numpy(), a16.cpu().numpy()))

    # (b) engine end-to-end, interleaved
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    lengths_s = np.clip(rng.lognormal(mean=1.9, sigma=0.8, size=128), 0.8, 59.0)
    audios = [
        (rng.standard_normal(int(s * 24_000)) * 0.3).astype(np.float32)
        for s in lengths_s
    ]
    total_s = sum(len(a) for a in audios) / 24_000.0

    def make_engine(dtype):
        return MimiEncoderEngine(
            params,
            cfg,
            EngineConfig(
                min_bucket_seconds=2.0,
                bucket_growth=1.45,
                samples_per_batch=192 * 24_000,
                max_batch_size=128,
                code_transfer_dtype=dtype,
            ),
            device=dev,
        )

    engines = {d: make_engine(d) for d in ("int32", "uint16")}
    codes = {}
    for d, e in engines.items():
        codes[d] = e.encode_batch(audios)  # warm this dtype's batch shapes

    results = {d: [] for d in engines}
    for round_i in range(3):
        for d, e in engines.items():
            e.stats = EngineStats()
            rt = probe_common.timed_pass(e, audios, total_s)
            results[d].append(rt)
            print(
                f"round {round_i} {d:7s}: {rt:6.1f}x RT "
                f"(fetch {e.stats.stage_seconds.get('fetch', 0):.2f}s "
                f"dispatch {e.stats.stage_seconds.get('dispatch', 0):.2f}s)"
            )
    for d, r in results.items():
        print(f"{d}: median {sorted(r)[len(r)//2]:.1f}x over {r}")
    assert raw_equal and probe_common.codes_equal(codes), "the dtypes' codes differ"
    return {
        "device": device_name(dev),
        "raw_reps": reps,
        "raw_seconds": {"int32": t32, "uint16": t16},
        "raw_mb_per_s": {"int32": n * 4 * reps / t32 / 1e6, "uint16": n * 2 * reps / t16 / 1e6},
        "raw_values_equal": raw_equal,
        "audio_seconds": total_s,
        "median_x_realtime": {d: sorted(r)[len(r) // 2] for d, r in results.items()},
        "all": results,
        "code_dtypes": {d: str(c[0].dtype) for d, c in codes.items()},
        "codes": codes,
    }


if __name__ == "__main__":
    main()
