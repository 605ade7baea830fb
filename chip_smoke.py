#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tokenize_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc`` (the kernels build from
``tokenize_audio_tpu_torch/csrc`` at first use). Phases, each of which fails
the run (non-zero exit, no final result line) if its check fails:

  1. device   — the card's name and power limit (nvidia-smi);
  2. build    — both kernels compiled for sm_90a, with nvcc's ptxas report;
  3. kernels  — each kernel against its plain PyTorch version at main-path
                shapes: agreement, CUDA-event times, and the bound the card's
                FP32 rate and memory rate set for the same work;
  4. main     — MimiEncoderEngine at full kyutai/mimi width (random weights,
                seed 0), 32 codebooks, packed transfer, fifo drain, on a
                YODAS2-shaped sub-shard through encode_batch(defer=True) and
                finish(); both kernels' launch counts must rise, and the codes
                are held against the plain-PyTorch ("torch") backends;
  5. tie      — a 3 s utterance encoded on the CPU (plain path, the path the
                CPU tests hold bit-equal to the JAX package) and on the card.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

SEED = 0
SPF = 1920
SR = 24_000
RVQ_SHAPE = dict(n=4096, d=256, v=2048, k=32)
RVQ_SMALL_N = 267  # mean rows per main-path batch
RESBLOCK_BATCH, RESBLOCK_SECONDS = 16, 10.0
AB_PAIRS = 6
# published dense rates (NVIDIA data sheets): FP32 outside the tensor cores
# and HBM bandwidth, by H100 variant
PEAKS = {
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "SXM": (67e12, 3.35e12),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, *PEAKS[key]
    return "SXM", *PEAKS["SXM"]


def bound_ms(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, warmup: int = 2, reps: int = 7) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rvq_first_divergence_margins(torch, x, embeds, got, want):
    """For each row whose kernel codes differ from the plain codes, replay
    the plain chain up to the first differing book and return the relative
    margin (d2[kernel idx] - d2[plain idx]) / |d2[plain idx]| there, and
    the absolute distance gap."""
    rows = torch.nonzero((got != want).any(dim=1)).flatten().tolist()
    margins, gaps = [], []
    for r in rows:
        k = int(torch.nonzero(got[r] != want[r])[0])
        res = x[r].clone()
        for j in range(k):
            res = res - embeds[j, want[r, j].long()]
        e = embeds[k]
        d2 = (res * res).sum() - 2.0 * (e @ res) + (e * e).sum(-1)
        a, b = d2[got[r, k].long()], d2[want[r, k].long()]
        gaps.append(float((a - b).abs()))
        margins.append(float((a - b) / b.abs()))
    return rows, margins, gaps


def phase_kernels(torch, peak_flops, peak_bw):
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

    dev = torch.device("cuda")
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    rng = np.random.default_rng(SEED)
    records = []
    with ieee_fp32():
        # --- RVQ: the full-size random codebooks, 1 semantic + 31 acoustic
        n, d, v, k = (RVQ_SHAPE[s] for s in ("n", "d", "v", "k"))
        embeds = np.concatenate(
            [params["rvq"]["semantic"]["embed"], params["rvq"]["acoustic"]["embed"]]
        )[:k]
        embeds = torch.from_numpy(np.ascontiguousarray(embeds)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        got = rvq.rvq_quantize(x, embeds)
        want = rvq.rvq_quantize_reference(x, embeds)
        torch.cuda.synchronize()
        match = float((got == want).float().mean())
        rows, margins, gaps = rvq_first_divergence_margins(torch, x, embeds, got, want)
        max_margin = max(margins, default=0.0)
        check(match >= 0.999, f"rvq kernel code match {match} < 0.999")
        check(max_margin < 1e-6, f"rvq first divergence not a near-tie: margin {max_margin}")
        ms = cuda_ms(torch, lambda: rvq.rvq_quantize(x, embeds))
        plain_ms = cuda_ms(torch, lambda: rvq.rvq_quantize_reference(x, embeds))
        # the main path's batches are small: time one at its mean row count
        xs = x[:RVQ_SMALL_N].contiguous()
        small = {
            "N": RVQ_SMALL_N, "K": k - 1,
            "ms": cuda_ms(torch, lambda: rvq.rvq_quantize(xs, embeds[1:])),
            "plain_ms": cuda_ms(torch, lambda: rvq.rvq_quantize_reference(xs, embeds[1:])),
        }
        flops = 2.0 * k * n * v * d
        nbytes = 4.0 * (k * v * d + n * d + n * k)
        b_ms, b_by = bound_ms(flops, nbytes, peak_flops, peak_bw)
        records.append({
            "name": "rvq_quantize",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/rvq.cu",
            "replaces": "tokenize_audio_tpu/ops/pallas/rvq.py:82",
            "launches": None,
            "max_abs_err": max(gaps, default=0.0),
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "shape": {"N": n, "D": d, "V": v, "K": k},
            "code_match": match,
            "diverging_rows": len(rows),
            "max_rel_margin": max_margin,
            "small_batch": small,
        })
        emit({"phase": "kernel", **records[-1]})

        # --- SEANet resblock: the four stage shapes of a 16 x 10 s batch
        t_audio = int(RESBLOCK_SECONDS * SR)
        stages, tot_ms, tot_plain, tot_bound, worst = [], 0.0, 0.0, 0.0, 0.0
        t, c = t_audio, cfg.num_filters
        for block, stride in zip(params["blocks"], cfg.encoder_strides):
            res = block["res"][0]
            w = [torch.from_numpy(res[a][p]).to(dev) for a in ("c1", "c2") for p in ("w", "b")]
            w3, b3, w1, b1 = w
            xs = rng.standard_normal((RESBLOCK_BATCH, c, t)).astype(np.float32) * 0.5
            valid = rng.integers(t // 2, t + 1, RESBLOCK_BATCH).astype(np.int32)
            valid[0] = t
            for i, vl in enumerate(valid):
                xs[i, :, vl:] = 0.0  # the masked invariant the model keeps
            xt = torch.from_numpy(xs).to(dev)
            vt = torch.from_numpy(valid).to(dev)
            del xs
            got = seanet.resblock_elu(xt, vt, w3, b3, w1, b1)
            want = seanet.resblock_elu_reference(xt, vt, w3, b3, w1, b1)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= 1e-4 * scale, f"resblock C={c}: max err {err} > 1e-4 * {scale}")
            del got, want
            ms = cuda_ms(torch, lambda: seanet.resblock_elu(xt, vt, w3, b3, w1, b1))
            plain_ms = cuda_ms(
                torch, lambda: seanet.resblock_elu_reference(xt, vt, w3, b3, w1, b1), reps=5
            )
            c2 = c // 2
            flops = 2.0 * (3 * c * c2 + c * c2) * RESBLOCK_BATCH * t
            nbytes = 4.0 * (2 * RESBLOCK_BATCH * c * t + 4 * c * c2 + c2 + c + RESBLOCK_BATCH)
            b_ms, b_by = bound_ms(flops, nbytes, peak_flops, peak_bw)
            stages.append({
                "C": c, "T": t, "B": RESBLOCK_BATCH, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "max_abs_plain": scale,
            })
            emit({"phase": "kernel_stage", "name": "resblock_elu", **stages[-1]})
            tot_ms, tot_plain, tot_bound = tot_ms + ms, tot_plain + plain_ms, tot_bound + b_ms
            worst = max(worst, err)
            del xt
            torch.cuda.empty_cache()
            t, c = t // stride, c * 2
        records.append({
            "name": "resblock_elu",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "tokenize_audio_tpu/ops/pallas/seanet.py:137",
            "launches": None,
            "max_abs_err": worst,
            "ms": tot_ms,
            "plain_ms": tot_plain,
            "bound_ms": tot_bound,
            "bound_by": "operations" if all(s["bound_by"] == "operations" for s in stages) else "bytes",
            "library_ms": None,
            "shape": "sum of the four stage shapes of one 16 x 10 s batch",
            "stages": stages,
        })
    return records


def make_subshard(rng):
    """~48 int16 utterances with lognormal durations in [1, 30] s, plus one
    75 s utterance that the 60 s cap splits."""
    durs = np.clip(rng.lognormal(math.log(6.0), 0.8, 48), 1.0, 30.0).tolist() + [75.0]
    audios = []
    for dur in durs:
        n = int(dur * SR)
        tt = np.arange(n) / SR
        tone = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * tt)
        noise = 0.1 * rng.standard_normal(n)
        audios.append((np.clip(tone + noise, -1, 1) * 32767).astype(np.int16))
    return audios


def phase_main(torch):
    from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, model, params_to_torch, random_params
    from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

    cfg = MimiConfig()
    params = params_to_torch(random_params(cfg, seed=SEED))  # on the card
    rng = np.random.default_rng(SEED + 1)
    audios = make_subshard(rng)
    audio_seconds = sum(len(a) for a in audios) / SR

    # TF32 flags as seen inside encode
    seen = {}
    orig_tfm = model.transformer_apply

    def spy(*args, **kwargs):
        seen["cudnn.allow_tf32"] = torch.backends.cudnn.allow_tf32
        seen["cuda.matmul.allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
        return orig_tfm(*args, **kwargs)

    model.transformer_apply = spy
    try:
        engine = MimiEncoderEngine(params, cfg, num_codebooks=32)
        engine.encode_batch(audios[:4], sr=SR)  # first-use set-up, not counted
        torch.cuda.synchronize()
        engine.stats = EngineStats()
        rvq.rvq_quantize.launches = 0
        seanet.resblock_elu.launches = 0
        t0 = time.perf_counter()
        finish = engine.encode_batch(audios, sr=SR, defer=True)
        codes = finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {
            "rvq_quantize": rvq.rvq_quantize.launches,
            "resblock_elu": seanet.resblock_elu.launches,
        }
    finally:
        model.transformer_apply = orig_tfm
    check(seen and not any(seen.values()), f"TF32 flags inside encode: {seen}")
    check(all(n > 0 for n in launches.values()), f"kernel launches on the main path: {launches}")
    check(len(codes) == len(audios), "one code array per utterance")
    for a, c in zip(audios, codes):
        check(c.shape == (32, -(-len(a) // SPF)), f"codes shape {c.shape} for {len(a)} samples")
        check(c.dtype == np.int32 and c.min() >= 0 and c.max() < cfg.codebook_size, "code range")
    stats = engine.stats.as_dict()

    profile = device_breakdown(
        torch, lambda: engine.encode_batch(audios, sr=SR, defer=True)()
    )

    # the same sub-shard through the plain-PyTorch backends on the same card
    plain_cfg = dataclasses.replace(cfg, rvq_backend="torch", seanet_backend="torch")
    plain_engine = MimiEncoderEngine(params, plain_cfg, num_codebooks=32)
    plain_engine.encode_batch(audios[:4], sr=SR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_codes = plain_engine.encode_batch(audios, sr=SR)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_profile = device_breakdown(torch, lambda: plain_engine.encode_batch(audios, sr=SR))
    ab = interleaved_rtf(torch, {"kernel": engine, "torch": plain_engine}, audios, audio_seconds)
    same = np.concatenate([(a == b).reshape(-1) for a, b in zip(codes, plain_codes)])
    frames_same = np.concatenate([(a == b).all(axis=0) for a, b in zip(codes, plain_codes)])
    code_match, frame_match = float(same.mean()), float(frames_same.mean())
    # a wrong kernel scrambles codes wholesale; summation-order deltas flip
    # only near-ties and the books after them in that frame
    check(code_match >= 0.9, f"kernel vs torch backend code match {code_match}")
    emit({
        "phase": "main",
        "utterances": len(audios),
        "audio_seconds": audio_seconds,
        "wall_seconds": wall,
        "realtime_factor": audio_seconds / wall,
        "launches": launches,
        "tf32_inside_encode": seen,
        "engine_stats": stats,
        "torch_backend_wall_seconds": plain_wall,
        "torch_backend_realtime_factor": audio_seconds / plain_wall,
        "kernel_vs_torch_backend_code_match": code_match,
        "kernel_vs_torch_backend_frame_match": frame_match,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    emit({"phase": "main_ab", **ab})
    emit({"phase": "main_profile", "backend": "kernel", **profile})
    emit({"phase": "main_profile", "backend": "torch", **plain_profile})
    return launches


def interleaved_rtf(torch, engines, audios, audio_seconds, pairs: int = AB_PAIRS):
    """Real-time factor of each engine over ``pairs`` rounds, alternating
    which runs first (one process, one card)."""
    runs = {name: [] for name in engines}
    names = list(engines)
    for i in range(pairs):
        for name in names if i % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].encode_batch(audios, sr=SR, defer=True)()
            torch.cuda.synchronize()
            runs[name].append(audio_seconds / (time.perf_counter() - t0))
    return {
        "pairs": pairs,
        "median_rtf": {n: float(np.median(r)) for n, r in runs.items()},
        "rtf_runs": runs,
    }


def device_breakdown(torch, run, top: int = 12):
    """One profiled run of ``run``: device time by kernel name (top
    ``top``), total device time, wall time and the device's busy share
    (union of device intervals over the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return {"device_time": "not measured (no device events in the trace)"}
    by_name, busy, cur_s, cur_e = {}, 0.0, spans[0][0], spans[0][1]
    for s, e, name in spans:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + (e - s)
        if s > cur_e:
            busy, cur_s = busy + (cur_e - cur_s), s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall * 1e3,
        "device_ms": total / 1e3,
        "busy_share": busy / 1e6 / wall,
        "top_kernels_ms": [[n, t / 1e3] for n, t in top_k],
    }


def phase_tie(torch):
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params

    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    n = 3 * SR
    tt = np.arange(n) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    cpu = MimiEncoderEngine(params, cfg, num_codebooks=32, device="cpu").encode_chunk(audio)
    gpu = MimiEncoderEngine(params, cfg, num_codebooks=32).encode_chunk(audio)
    check(cpu.shape == gpu.shape, f"cpu {cpu.shape} vs card {gpu.shape}")
    frame_match = float((cpu == gpu).all(axis=0).mean())
    code_match = float((cpu == gpu).mean())
    emit({"phase": "tie", "frames": int(cpu.shape[1]), "card_vs_cpu_frame_match": frame_match,
          "card_vs_cpu_code_match": code_match})
    check(frame_match >= 0.999, f"card vs CPU frame match {frame_match} < 0.999")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from tokenize_audio_tpu_torch.ops.cuda import _build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    variant, peak_flops, peak_bw = peaks_for(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"variant": variant, "fp32_flops": peak_flops, "hbm_bytes_per_s": peak_bw}})
    try:
        t0 = time.perf_counter()
        seconds = _build.build()
        ptxas = {
            k: [ln.strip() for ln in _build.build_log(k).splitlines()
                if "registers" in ln or "spill" in ln]
            for k in _build.KERNELS
        }
        emit({"phase": "build", "seconds": seconds, "wall_seconds": time.perf_counter() - t0,
              "ptxas": ptxas})
        records = phase_kernels(torch, peak_flops, peak_bw)
        launches = phase_main(torch)
        for r in records:
            r["launches"] = launches[r["name"]]
        phase_tie(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
