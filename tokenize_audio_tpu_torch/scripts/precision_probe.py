"""Qualify matmul_precision="high" (TF32 on the card) as a throughput mode
against the parity mode, on realistic quantizer geometry.

This probe reuses the bf16_qualification oracle (residual k-means codebooks
trained on the model's own pre-RVQ activations — realistic cluster
geometry) and reports, on held-out varied audio:

  1. code match of "high" vs "highest" (IEEE fp32, the parity mode);
  2. code match of bf16 vs "highest" (context / lower bound);
  3. INTERLEAVED encode timings "highest" vs "high" vs bf16 (median of
     alternating rounds; each encode ends in ``torch.cuda.synchronize()``).

On the card "high" is TF32 (cuDNN and cuBLAS), a different numeric class
from the 3-pass bf16 that the name means on a TPU, so its numbers are the
card's own. On the CPU "high" equals "highest".

Run on the card: python -m tokenize_audio_tpu_torch.scripts.precision_probe
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import resolve_device
from tokenize_audio_tpu_torch.mimi import MimiConfig
from tokenize_audio_tpu_torch.mimi.model import encode
from tokenize_audio_tpu_torch.scripts import bf16_qualification as bq
from tokenize_audio_tpu_torch.scripts import device_name, device_params


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--books", type=int, default=8)
    ap.add_argument("--train-sec", type=float, default=2400.0)
    ap.add_argument("--eval-sec", type=float, default=240.0)
    ap.add_argument("--kmeans-iters", type=int, default=12)
    ap.add_argument("--timing-rounds", type=int, default=7)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(args, dev: torch.device):
    """The probe: returns (report, state), where ``state`` holds what a
    caller may check further: the trained params' ``device_params`` tree
    ``dparams``, the eval ``rows`` and ``valid``, the ``cfgs`` by mode and
    each mode's ``codes`` (B, K, T)."""
    print("device:", device_name(dev), flush=True)
    cfg = MimiConfig()
    params = bq.trained_params(cfg, args.books, args.train_sec, args.kmeans_iters, dev)
    dparams = device_params(params, cfg, dev)
    rows, valid = bq.eval_rows(cfg, args.eval_sec, dev)

    cfgs = {
        "highest": cfg,  # default matmul_precision="highest"
        "high": dataclasses.replace(cfg, matmul_precision="high"),
        "bf16": dataclasses.replace(cfg, compute_dtype="bfloat16"),
    }
    codes = {}
    for name, c in cfgs.items():
        out, _ = encode(dparams, c, rows, valid, num_quantizers=args.books)
        codes[name] = out.cpu().numpy()

    ref = codes["highest"]
    usage = [len(np.unique(ref[:, b])) for b in range(args.books)]
    print(f"codebook usage (of {cfg.codebook_size}):", usage)
    report = {"eval_frames": int(ref.shape[0] * ref.shape[2]), "usage": usage}
    for name in ("high", "bf16"):
        eq = ref == codes[name]
        report[f"{name}_code_match"] = float(eq.mean())
        report[f"{name}_frame_match"] = float(eq.all(axis=1).mean())
        report[f"{name}_per_book"] = np.round(eq.mean(axis=(0, 2)), 5).tolist()
        print(
            f"{name}: codes {100*eq.mean():.4f}%  frames all-{args.books} "
            f"{100*eq.all(axis=1).mean():.4f}%  per-book "
            f"{np.round(100*eq.mean(axis=(0,2)), 2).tolist()}",
            flush=True,
        )

    # interleaved timing: alternate configs within every round
    timings = {k: [] for k in cfgs}
    for _ in range(2):  # warm all three modes
        for c in cfgs.values():
            encode(dparams, c, rows, valid, num_quantizers=args.books)
            _sync(dev)
    for _ in range(args.timing_rounds):
        for name, c in cfgs.items():
            t0 = time.perf_counter()
            encode(dparams, c, rows, valid, num_quantizers=args.books)
            _sync(dev)
            timings[name].append(time.perf_counter() - t0)
    audio_sec = rows.numel() / cfg.sampling_rate
    for name, ts in timings.items():
        med = float(np.median(ts))
        report[f"{name}_median_s"] = round(med, 4)
        report[f"{name}_x_realtime"] = round(audio_sec / med, 1)
        print(
            f"{name}: median {med*1e3:.1f} ms for {audio_sec:.0f} s audio "
            f"= {audio_sec/med:.0f}x RT  (all: {[round(t*1e3,1) for t in ts]})",
            flush=True,
        )
    state = {"dparams": dparams, "rows": rows, "valid": valid,
             "cfgs": cfgs, "codes": codes}
    return report, state


def main(argv=None):
    args = parser().parse_args(argv)
    report, _ = run(args, resolve_device(args.device))
    print("RESULT " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
