"""Measure the fused SEANet resblock kernel backend against the plain
PyTorch ("torch") backend on the card: speed + codes.

(a) stage and full-encode timing for both backends (CUDA events around
    ``iters`` calls after a warm one, on the card; the host clock on the
    CPU);
(b) full-size-model code agreement between backends over a batch of
    varied utterances (the deltas are ~1e-5 summation-order noise; this
    measures how often that flips an RVQ argmin).

The backends are the port's ``MimiConfig.seanet_backend`` values: "torch"
(the causal_conv1d chain; the JAX script's "xla") and "kernel" (the JAX
script's "pallas").

Usage: python -m tokenize_audio_tpu_torch.scripts.seanet_backend_probe
           [--batch 16] [--seconds 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import time

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import fp32_precision, resolve_device
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.mimi.model import encode, matmul_precision, seanet_encode
from tokenize_audio_tpu_torch.scripts import device_name, device_params


def bench(fn, *args, iters=6):
    """Seconds per call of ``fn(*args)`` (a tensor on one device), after one
    warm call."""
    out = fn(*args)
    dev = out.device
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev))
    cfg_x = dataclasses.replace(MimiConfig(), seanet_backend="torch")
    cfg_p = dataclasses.replace(cfg_x, seanet_backend="kernel")
    params = device_params(random_params(cfg_x, seed=0), cfg_p, dev)

    spf = cfg_x.samples_per_frame
    n = int(args.seconds * 24_000) // spf * spf
    b = args.batch
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((b, n)) * 0.3).astype(np.float32)).to(dev)
    audio_s = b * n / 24_000.0
    valid = torch.full((b,), n, dtype=torch.int32, device=dev)

    @torch.no_grad()
    def seanet(cfg, a, v):
        with fp32_precision(matmul_precision(cfg)):
            return seanet_encode(params, cfg, a[:, None, :], v)[0]

    sea_x = functools.partial(seanet, cfg_x)
    sea_p = functools.partial(seanet, cfg_p)
    t_x = bench(sea_x, audio, valid)
    t_p = bench(sea_p, audio, valid)
    print(f"seanet torch : {t_x*1e3:8.1f} ms ({audio_s/t_x:7.0f}x RT)")
    print(f"seanet kernel: {t_p*1e3:8.1f} ms ({audio_s/t_p:7.0f}x RT)  speedup {t_x/t_p:.2f}x")

    def enc_x(a, v):
        return encode(params, cfg_x, a, v, num_quantizers=8)[0]

    def enc_p(a, v):
        return encode(params, cfg_p, a, v, num_quantizers=8)[0]

    t_ex = bench(enc_x, audio, valid)
    t_ep = bench(enc_p, audio, valid)
    print(f"encode torch : {t_ex*1e3:8.1f} ms ({audio_s/t_ex:7.0f}x RT)")
    print(f"encode kernel: {t_ep*1e3:8.1f} ms ({audio_s/t_ep:7.0f}x RT)  speedup {t_ex/t_ep:.2f}x")

    # code agreement over varied utterances (batched rows of mixed content)
    total = match = 0
    frames_same = frames = 0
    for seed in range(4):
        r = np.random.default_rng(seed + 10)
        t = np.arange(n) / 24_000
        rows = []
        for i in range(b):
            kind = i % 4
            if kind == 0:
                x = 0.4 * np.sin(2 * np.pi * (80 + 60 * i) * t)
            elif kind == 1:
                x = np.convolve(r.standard_normal(n) * 0.3, np.ones(6) / 6, "same")
            elif kind == 2:
                x = 0.3 * np.sin(2 * np.pi * (60 * t + 5000 * t**2 / (2 * t[-1])))
            else:
                x = 0.5 * np.sin(2 * np.pi * 220 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
            rows.append(x.astype(np.float32))
        batch = torch.from_numpy(np.stack(rows)).to(dev)
        cx = enc_x(batch, valid).cpu().numpy()
        cp = enc_p(batch, valid).cpu().numpy()
        total += cx.size
        match += (cx == cp).sum()
        frames += cx.shape[0] * cx.shape[2]
        frames_same += (cx == cp).all(axis=1).sum()
    print(
        f"code agreement kernel-vs-torch: {100*match/total:.3f}% codes, "
        f"{100*frames_same/frames:.3f}% frames fully identical "
        f"({frames} frames)"
    )
    return {
        "audio_seconds": audio_s,
        "seanet_torch_s": t_x,
        "seanet_kernel_s": t_p,
        "encode_torch_s": t_ex,
        "encode_kernel_s": t_ep,
        "code_agreement": float(match / total),
        "frame_agreement": float(frames_same / frames),
        "frames": int(frames),
    }


if __name__ == "__main__":
    main()
