"""Probe the card's compute time of encode stages and a channels-last SEANet.

Is NCL (``(B, C, T)``, what ``mimi.model`` runs) the right layout for
cuDNN under IEEE fp32, or would channels-last be faster? This script
measures, on the card (host clock around ``iters`` calls with
``torch.cuda.synchronize()`` before and after the loop), all under
``config.fp32_precision("ieee")``:

  1. full encode (production path: the fused SEANet stage with the
     resblock kernel, the RVQ kernel), 8 books
  2. ``seanet NCL kernel``: SEANet alone, the production fused stage
     (``seanet_backend="kernel"``)
  3. ``seanet NCL torch``: SEANet alone, plain ``causal_conv1d`` convs
     (``seanet_backend="torch"``). The JAX script's ``seanet NCH`` line
     timed plain XLA convs (its MimiConfig defaults to
     ``seanet_backend="xla"``), so this line is its counterpart; line 2
     has none there
  4. ``seanet NLC``: SEANet alone, channels-last plain convs on the same
     params (``seanet_nlc``)
  5. transformer alone
  6. RVQ alone (8 books, the RVQ kernel)

Channels-last is reached the way PyTorch hands cuDNN its NHWC kernels:
``conv2d`` on ``(B, C, 1, T)`` activations in ``torch.channels_last``
memory format (physically ``(B, 1, T, C)``, channels innermost) with the
weights as ``(O, I, 1, K)`` in the same format, built once. (Explicit
``(B, T, C)`` transposes around ``conv1d`` would leave the layout to
``conv1d``'s own choice.) It keeps ``causal_conv1d``'s causal left pad,
its replicate pad for ``pad_mode="replicate"``, the stride and the
dilation.

The last line holds NLC against NCL torch: bitwise equality is reported,
not required (cuDNN may run another algorithm for each layout, summing in
another order), with the max abs difference.

Usage: python -m tokenize_audio_tpu_torch.scripts.conv_layout_probe
           [--batch 16] [--seconds 20] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision, resolve_device
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.mimi.model import (
    _elu,
    causal_conv1d,
    encode,
    seanet_encode,
    split_rvq_encode,
    transformer_apply,
)
from tokenize_audio_tpu_torch.scripts import device_name, device_params, probe_common

CL = torch.channels_last


def bench_fn(fn, *args, iters=6):
    """Seconds per call of ``fn(*args)``: one warm call, then ``iters``
    calls between two synchronizations of the card."""
    dev = args[0].device
    fn(*args)
    probe_common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    probe_common.sync(dev)
    return (time.perf_counter() - t0) / iters


def nlc_weights(params):
    """Each SEANet conv's (O, I, K) weight as (O, I, 1, K) channels-last,
    built once (the JAX script transposes OIH -> HIO at trace time)."""

    def w4(conv):
        return {"w": conv["w"][:, :, None, :].contiguous(memory_format=CL), "b": conv["b"]}

    return {
        "enc_in": w4(params["enc_in"]),
        "blocks": [
            {"res": [{k: w4(r[k]) for k in ("c1", "c2")} for r in block["res"]],
             "down": w4(block["down"])}
            for block in params["blocks"]
        ],
        "enc_out": w4(params["enc_out"]),
    }


def _conv(x, w, b, stride=1, dilation=1, pad_mode="constant"):
    """``causal_conv1d`` (unmasked) on (B, C, 1, T) channels-last."""
    k_eff = (w.shape[-1] - 1) * dilation + 1
    pad_total = k_eff - stride
    if pad_mode == "constant":
        x = F.pad(x, (pad_total, 0))
    elif pad_mode == "replicate":
        x = torch.cat([x[..., :1].expand(-1, -1, -1, pad_total), x], dim=3)
    else:
        raise ValueError(f"unsupported pad_mode {pad_mode}")
    x = x.contiguous(memory_format=CL)
    return F.conv2d(x, w, b, stride=(1, stride), dilation=(1, dilation))


def seanet_nlc(wts, cfg: MimiConfig, x: torch.Tensor) -> torch.Tensor:
    """Channels-last SEANet: (B, 1, 1, T) audio -> (B, hidden, 1, T/960)
    channels-last, with ``nlc_weights``. Same math as
    ``model.seanet_encode`` with ``seanet_backend="torch"``."""
    pm = cfg.pad_mode
    x = _conv(x, wts["enc_in"]["w"], wts["enc_in"]["b"], pad_mode=pm)
    for block, stride in zip(wts["blocks"], cfg.encoder_strides):
        for j, res in enumerate(block["res"]):
            residual = x
            h = _elu(x)
            h = _conv(h, res["c1"]["w"], res["c1"]["b"],
                      dilation=cfg.dilation_growth_rate**j, pad_mode=pm)
            h = _elu(h)
            h = _conv(h, res["c2"]["w"], res["c2"]["b"], pad_mode=pm)
            x = residual + h
        x = _elu(x)
        x = _conv(x, block["down"]["w"], block["down"]["b"], stride=stride, pad_mode=pm)
    x = _elu(x)
    return _conv(x, wts["enc_out"]["w"], wts["enc_out"]["b"], pad_mode=pm)


def setup(batch: int, seconds: float, dev: torch.device, cfg: MimiConfig = None):
    """The probe's inputs on ``dev``: (cfg, params, audio, audio seconds,
    the SEANet variants by line name). Each variant maps (B, T) audio to
    (B, hidden, T/960)."""
    cfg = cfg or MimiConfig()
    cfg_k = dataclasses.replace(cfg, seanet_backend="kernel")
    cfg_t = dataclasses.replace(cfg, seanet_backend="torch")
    params = device_params(random_params(cfg, seed=0), cfg_k, dev)
    wts = nlc_weights(params)
    spf = cfg.samples_per_frame
    n = int(seconds * 24_000) // spf * spf
    audio = torch.from_numpy(
        np.random.default_rng(0).standard_normal((batch, n)).astype(np.float32) * 0.3
    ).to(dev)
    seanets = {
        "seanet NCL kernel": lambda a: seanet_encode(params, cfg_k, a[:, None, :], None)[0],
        "seanet NCL torch ": lambda a: seanet_encode(params, cfg_t, a[:, None, :], None)[0],
        "seanet NLC       ": lambda a: seanet_nlc(wts, cfg, a[:, None, None, :])[:, :, 0, :],
    }
    return cfg, params, audio, batch * n / 24_000.0, seanets


@torch.no_grad()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    print("device:", device_name(dev))
    with fp32_precision("ieee"):
        cfg, params, audio, audio_s, seanets = setup(args.batch, args.seconds, dev)
        ms = {}

        t_full = bench_fn(lambda a: encode(params, cfg, a, None, num_quantizers=8), audio)
        print(f"full encode: {t_full*1e3:8.1f} ms  ({audio_s / t_full:7.0f}x RT)")
        ms["full encode"] = t_full * 1e3

        for name, sea in seanets.items():
            t = bench_fn(sea, audio)
            print(f"{name}: {t*1e3:8.1f} ms  ({audio_s / t:7.0f}x RT)")
            ms[name.strip()] = t * 1e3

        sea = seanets["seanet NCL torch "]
        h25 = sea(audio).transpose(1, 2).contiguous()  # (B, T25, C)
        t_tfm = bench_fn(lambda h: transformer_apply(params["tfm"], cfg, h), h25)
        print(f"transformer: {t_tfm*1e3:8.1f} ms  ({audio_s / t_tfm:7.0f}x RT)")
        ms["transformer"] = t_tfm * 1e3

        x12 = causal_conv1d(h25.transpose(1, 2), None, params["downsample"]["w"], None,
                            stride=2, pad_mode="replicate")[0]
        t_rvq = bench_fn(lambda x: split_rvq_encode(params["rvq"], x, 8,
                                                    backend=cfg.rvq_backend), x12)
        print(f"rvq (8 bks): {t_rvq*1e3:8.1f} ms  ({audio_s / t_rvq:7.0f}x RT)")
        ms["rvq (8 bks)"] = t_rvq * 1e3

        # NLC vs NCL plain convs, on a small input as the JAX script, and on
        # the timed batch
        nlc = seanets["seanet NLC       "]
        a_small = audio[:2, : 4 * cfg.samples_per_frame]
        ref, got = sea(a_small), nlc(a_small)
        bitwise = bool(torch.equal(ref, got))
        maxdiff = float((ref - got).abs().max())
        print("NLC == NCL torch (f32 bitwise):", bitwise, " maxdiff:", maxdiff)
        ref, got = sea(audio), nlc(audio)
        full_diff, full_scale = float((ref - got).abs().max()), float(ref.abs().max())
    return {
        "device": device_name(dev),
        "batch": args.batch,
        "seconds": args.seconds,
        "audio_seconds": audio_s,
        "ms": ms,
        "nlc_vs_ncl_torch_bitwise": bitwise,
        "nlc_vs_ncl_torch_maxdiff": maxdiff,
        "nlc_vs_ncl_torch_maxdiff_full": full_diff,
        "ncl_torch_max_abs_full": full_scale,
    }


if __name__ == "__main__":
    main()
