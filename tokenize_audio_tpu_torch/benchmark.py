"""Benchmark CLIs of the port: engine-only and full-pipeline throughput.

    python -m tokenize_audio_tpu_torch.benchmark             # engine bench
    python -m tokenize_audio_tpu_torch.benchmark --pipeline  # full YODAS2 path
    python -m tokenize_audio_tpu_torch.benchmark --compare   # pipeline/engine ratio
    python -m tokenize_audio_tpu_torch.benchmark --soak 30   # sustained soak (min)

Each runs on the CUDA device (``--device cpu`` for the CPU) and prints ONE
JSON line {"metric", "value", "unit", "detail"}; ``detail.device`` is the
card's name and power limit as ``nvidia-smi`` gives them, or "cpu".

- The **engine bench** measures the batch-encode engine alone (bucketing,
  samples-budget batching, masked encode, trim) on a seeded synthetic
  workload whose length distribution mimics web speech: audio-hours
  tokenized per wall hour on one card.
- The **pipeline bench** drives the WHOLE production path — tar fetch +
  extract, WAV decode, centisecond chunk slicing, batched encode, uint16
  JSON serialization, batched hub upload — against a synthetic local
  mirror, end to end.

Both use seeded random weights (codes are parity-pinned elsewhere; the
throughput path is weight-agnostic) and one warm pass before measuring.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tarfile
import tempfile
import time
from typing import Callable, Optional

import numpy as np
import torch

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.datasets.yodas2 import (
    LocalSource,
    SubShardProcessor,
    Yodas2ShardProcessor,
    slice_chunks,
)
from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import LocalHub
from tokenize_audio_tpu_torch.io import write_wav
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params


def _noop(stage: str) -> None:
    pass


def _check(cond: bool, what) -> None:
    if not cond:
        raise RuntimeError(f"benchmark check failed: {what}")


def _bench_engine_cfg() -> EngineConfig:
    """The single-card bench configuration (shared by all modes)."""
    return EngineConfig(
        min_bucket_seconds=2.0,
        bucket_growth=1.15,  # 26 buckets
        samples_per_batch=192 * 24_000,  # ~3.2 min of audio per call
        max_batch_size=128,
    )


def device_label(dev: torch.device) -> str:
    """``detail.device``: the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (a card
    may be set below its maximum power and run slower), or the device type
    off the card."""
    if dev.type != "cuda":
        return dev.type
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        lines = out.stdout.strip().splitlines()
        return lines[index] if index < len(lines) else lines[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def _claim_device(progress: Callable[[str], None], dev: torch.device) -> None:
    """First device touch under its own heartbeat, so a slow or failing
    device claim is told apart from param generation and first-use set-up.
    Call this BEFORE constructing an engine — engine init moves the params
    to the device, which would otherwise hide the claim inside 'params'."""
    progress("device_claim")
    torch.zeros(8, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _build_pipeline_engine(mimi_cfg, engine_cfg, progress: Callable[[str], None], dev):
    """Engine for the pipeline/soak modes (all codebooks — the raw YODAS2
    stage stores every book, yodas2-mimi/process_shard.py:520-523); the
    engine moves the seeded random params to ``dev`` (``params_to_torch``)."""
    cfg = mimi_cfg or MimiConfig()
    _claim_device(progress, dev)
    progress("params")
    params = random_params(cfg, seed=0)
    return MimiEncoderEngine(
        params,
        cfg,
        engine_cfg or _bench_engine_cfg(),
        num_codebooks=cfg.num_quantizers,
        device=dev,
    )


def _process_shard_once(tmp, mirror, engine, tag, subshards):
    """One full shard pass of the production path against fresh hub /
    work / progress state; returns (wall_seconds, report)."""
    proc = Yodas2ShardProcessor(
        "en000",
        LocalSource(mirror),
        LocalHub(os.path.join(tmp, f"hub_{tag}")),
        engine,
        os.path.join(tmp, f"work_{tag}"),
        os.path.join(tmp, f"prog_{tag}"),
        max_subshards=subshards,
        max_consecutive_missing=2,
        upload_batch_size=2,
    )
    t0 = time.perf_counter()
    rep = proc.process()
    return time.perf_counter() - t0, rep


# ---------------------------------------------------------------------------
# engine bench


def engine_workload(n_utts: int, seed: int, ecfg: EngineConfig):
    """The engine bench's seeded int16 workload: ``n_utts`` lognormal
    lengths (median ~6.7 s, clipped to [0.8, 59] s), the utterances at the
    engine rate, then the same lengths at 16 kHz for the fused-resample
    stage — drawn from one generator in the JAX bench's order. Audio is
    int16 PCM, the production wire format (YODAS2 WAV tars / LibriSpeech
    FLAC are 16-bit): the engine ships raw PCM and normalizes on device.
    Returns ``(audios, audios16)``."""
    rng = np.random.default_rng(seed)
    sr = ecfg.sample_rate
    lengths_s = np.clip(
        rng.lognormal(mean=1.9, sigma=0.8, size=n_utts),
        0.8,
        min(59.0, ecfg.max_chunk_seconds - 0.05),
    )
    audios = [
        (rng.standard_normal(int(s * sr)) * 0.3 * 32767).astype(np.int16)
        for s in lengths_s
    ]
    sr16 = sr * 2 // 3
    audios16 = [
        (rng.standard_normal(int(s * sr16)) * 0.3 * 32767).astype(np.int16)
        for s in lengths_s
    ]
    return audios, audios16


def run_engine_bench(
    *,
    n_utts: int = 256,
    passes: int = 5,
    seed: int = 0,
    mimi_cfg=None,
    engine_cfg=None,
    progress: Callable[[str], None] = _noop,
    on_headline: Optional[Callable[[dict], None]] = None,
    fused_16k: bool = True,
    device=None,
) -> dict:
    """Engine-only throughput: audio-hours tokenized per wall hour per card.

    One warm pass (first-use kernel builds, cuDNN set-up and the caching
    allocator's pools for every bucket shape), then ``passes`` measured
    passes with the best reported — production shards run for hours at
    steady state, and a card shares its host with others, so the best pass
    is the least-noise estimate of what the card can do (every pass is in
    detail.pass_x_realtime). ``encode_batch`` returns host arrays, so each
    timed window ends on the host.

    ``on_headline`` (if given) receives the result dict the moment the
    headline passes finish, BEFORE the secondary fused-16 kHz stage runs, so
    a failure in that stage cannot lose the measured headline. The fused
    number is then added to ``detail`` in place (callers holding the
    emitted dict see it too).
    """
    if passes < 1:
        raise ValueError(f"passes must be >= 1, got {passes}")
    dev = resolve_device(device)
    cfg = mimi_cfg or MimiConfig()
    _claim_device(progress, dev)
    progress("params")
    params = random_params(cfg, seed=0)
    ecfg = engine_cfg or _bench_engine_cfg()
    engine = MimiEncoderEngine(params, cfg, ecfg, device=dev)

    audios, audios16 = engine_workload(n_utts, seed, ecfg)
    sr = ecfg.sample_rate
    total_audio_s = sum(len(a) for a in audios) / sr

    progress("warmup")
    engine.encode_batch(audios)  # warm pass: every bucket shape once

    pass_rts = []
    best_stats, best_wall = None, None
    spf = engine.cfg.samples_per_frame
    for i in range(passes):
        progress(f"measured_pass_{i + 1}")
        engine.stats = EngineStats()
        t0 = time.perf_counter()
        codes = engine.encode_batch(audios)  # measured steady-state pass
        wall = time.perf_counter() - t0
        frames = sum(c.shape[1] for c in codes)
        expected = sum(-(-len(a) // spf) for a in audios)
        _check(frames == expected, f"frames {frames} != expected {expected}")
        pass_rts.append(total_audio_s / wall)
        if pass_rts[-1] == max(pass_rts):
            best_stats, best_wall = engine.stats, wall

    rt = max(pass_rts)
    engine.stats = best_stats
    result = {
        "metric": "audio_hours_per_hour_per_chip",
        "value": round(rt, 2),
        "unit": "x_realtime",
        "detail": {
            "device": device_label(dev),
            "audio_seconds": round(total_audio_s, 1),
            "wall_seconds": round(best_wall, 3),
            "utterances": n_utts,
            "pass_x_realtime": [round(p, 1) for p in pass_rts],
            "bucket_efficiency": round(engine.stats.bucket_efficiency, 4),
            "code_transfer_format": engine.engine_cfg.code_transfer_format,
            "bucket_growth": ecfg.bucket_growth,
            "stage_seconds": {
                k: round(v, 3) for k, v in engine.stats.stage_seconds.items()
            },
        },
    }
    if on_headline is not None:
        on_headline(result)
    if not fused_16k:
        return result

    # secondary: MLS-shaped 16 kHz int16 workload through the FUSED
    # on-device resample (source-rate upload + polyphase conv inside
    # encode). Reported in detail only; the headline stays the 24 kHz run.
    sr16 = sr * 2 // 3
    total16_s = sum(len(a) for a in audios16) / sr16
    engine.stats = EngineStats()  # keep the 16k passes out of best_stats
    progress("fused_16k")
    engine.encode_batch(audios16, sr=sr16)  # warm fused shapes
    t0 = time.perf_counter()
    engine.encode_batch(audios16, sr=sr16)
    rt16 = total16_s / (time.perf_counter() - t0)
    engine.stats = best_stats  # report the best headline pass's stats
    result["detail"]["fused_16khz_x_realtime"] = round(rt16, 1)
    return result


# ---------------------------------------------------------------------------
# full-pipeline bench


def build_mirror(
    root, shard, subshards, audios_per, seconds, sr=24_000, container="wav"
):
    """Synthetic YODAS2-layout local mirror: per sub-shard a tar.gz of WAVs
    plus the chunk-id metadata JSON (centisecond spans, reference id scheme
    yodas2-mimi/process_shard.py:400-427).

    ``sr`` is an int or a sequence of ints cycled per audio: real YODAS2
    tars hold ORIGINAL-rate WAVs (16/44.1/48 kHz web audio), and the
    reference pays a librosa resample to 24 kHz per file
    (yodas2-mimi/process_shard.py:188) — a source-rate mirror makes the
    pipeline bench exercise the on-device resample stage the same way.

    ``container="mp3"`` writes real lame-encoded mp3 files instead — the
    Emilia / Common Voice payload class (mp3-in-tar,
    emilia-mimi/process_shard.py:473-537), whose host decode costs far more
    than WAV's and therefore stresses whether the decode prefetch pool keeps
    the card fed. mp3 is lossy, so an mp3 mirror measures throughput, never
    parity."""
    # the chunk loop below needs headroom past the minimum 1.5 s chunk:
    # at seconds <= 2 it emits ZERO chunks while total_audio still counts
    # the full files — the bench would "process" everything, encode
    # nothing, and report a bogus x_realtime
    if seconds <= 2.0:
        raise ValueError(f"seconds must be > 2.0 to emit chunks, got {seconds}")
    rng = np.random.default_rng(0)
    if container == "mp3":
        from tokenize_audio_tpu_torch.io.mp3enc import encode_mp3
    elif container != "wav":
        raise ValueError(f"container must be 'wav' or 'mp3', got {container!r}")
    rates = [sr] if isinstance(sr, int) else list(sr)
    total_audio = 0.0
    n_chunks = 0
    for s in range(subshards):
        sid = f"{s:08d}"
        sdir = os.path.join(root, shard)
        os.makedirs(sdir, exist_ok=True)
        wav_dir = os.path.join(root, f"_b{sid}")
        os.makedirs(wav_dir, exist_ok=True)
        meta = []
        for a in range(audios_per):
            sr = rates[a % len(rates)]
            audio_id = f"vid-{sid}-{a}"
            t = np.arange(int(seconds * sr)) / sr
            x = (
                0.3 * np.sin(2 * np.pi * (120 + 40 * a) * t)
                + 0.1 * rng.standard_normal(len(t))
            ).astype(np.float32)
            if container == "mp3":
                pcm = np.clip(x * 32767.0, -32768, 32767).astype(np.int16)
                with open(os.path.join(wav_dir, f"{audio_id}.mp3"), "wb") as fa:
                    fa.write(encode_mp3(pcm, sample_rate=sr))
            else:
                write_wav(os.path.join(wav_dir, f"{audio_id}.wav"), x, sr)
            total_audio += seconds
            # ~3 s mean chunks in centiseconds, lognormal-ish lengths
            text = {}
            pos = 0
            idx = 0
            while pos < seconds * 100 - 200:
                dur = int(np.clip(rng.lognormal(5.6, 0.6), 150, 3000))  # cs
                end = min(pos + dur, int(seconds * 100))
                text[f"{audio_id}-{idx:05d}-{pos:08d}-{end:08d}"] = f"chunk {idx}"
                pos = end
                idx += 1
                n_chunks += 1
            meta.append({"audio_id": audio_id, "text": text})
        with tarfile.open(os.path.join(sdir, f"{sid}.tar.gz"), "w:gz") as tf:
            tf.add(wav_dir, arcname="audio")
        with open(os.path.join(sdir, f"{sid}.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(wav_dir)
    return total_audio, n_chunks


def _rates_list(source_rate) -> list:
    return [source_rate] if isinstance(source_rate, int) else list(source_rate)


def run_pipeline_bench(
    *,
    subshards: int = 4,
    audios: int = 6,
    seconds: float = 90.0,
    source_rate=24_000,
    container: str = "wav",
    mimi_cfg=None,
    engine_cfg=None,
    engine=None,
    work_root: Optional[str] = None,
    progress: Callable[[str], None] = _noop,
    device=None,
) -> dict:
    """Full production-path throughput on one card: synthetic YODAS2
    mirror -> tar fetch/extract -> WAV decode -> chunk slicing -> batched
    encode (all codebooks, raw stage) -> uint16 JSON -> batched upload to
    a local hub. Warm pass first, then one measured pass over fresh
    progress/hub state. Pass ``engine`` to reuse a live, already-claimed
    engine (it keeps its own device); otherwise one is built from
    ``mimi_cfg``/``engine_cfg`` on ``device``.

    ``source_rate`` (int or sequence, cycled per audio) sets the mirror's
    WAV sample rates: non-24 kHz sources add the per-file on-device
    resample the reference pays librosa for on real YODAS2 audio
    (yodas2-mimi/process_shard.py:188) — the 24 kHz default measures the
    resample-free path.
    """
    dev = engine.device if engine is not None else resolve_device(device)
    tmp = work_root or tempfile.mkdtemp(prefix="pipe_bench_")
    own_tmp = work_root is None
    try:
        mirror = os.path.join(tmp, "mirror")
        progress("build_mirror")
        total_audio, n_chunks = build_mirror(
            mirror, "en000", subshards, audios, seconds, sr=source_rate,
            container=container,
        )

        if engine is None:
            engine = _build_pipeline_engine(mimi_cfg, engine_cfg, progress, dev)

        progress("warm_pass")
        wall_warm, _ = _process_shard_once(tmp, mirror, engine, "warm", subshards)
        engine.stats = EngineStats()
        progress("measured_pass")
        # fresh hub/progress: re-processes everything
        wall, rep = _process_shard_once(tmp, mirror, engine, "m", subshards)

        _check(rep["processed"] == subshards, rep)
        rt = total_audio / wall
        return {
            "metric": "pipeline_audio_hours_per_hour_per_chip",
            "value": round(rt, 1),
            "unit": "x_realtime",
            "detail": {
                "device": device_label(dev),
                "audio_hours": round(total_audio / 3600, 3),
                "wall_seconds": round(wall, 2),
                "chunks": n_chunks,
                "subshards": subshards,
                "source_rates": _rates_list(source_rate),
                "container": container,
                "transient_retries": engine.stats.transient_retries,
                "engine_stage_seconds": {
                    k: round(v, 2) for k, v in engine.stats.stage_seconds.items()
                },
                "warm_pass_seconds": round(wall_warm, 2),
            },
        }
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# pipeline-vs-engine comparison (one process, one engine, same chunk set)


def run_compare(
    *,
    subshards: int = 4,
    audios: int = 6,
    seconds: float = 90.0,
    source_rate=24_000,
    container: str = "wav",
    passes: int = 3,
    mimi_cfg=None,
    engine_cfg=None,
    work_root: Optional[str] = None,
    progress: Callable[[str], None] = _noop,
    device=None,
) -> dict:
    """Measure how much of the engine's throughput the FULL pipeline
    delivers, within one process on one engine.

    Wall-clock numbers from separate runs drift with the host the card
    shares, so the pipeline-vs-engine gap is measured within one process:
    this decodes + slices the mirror's chunks ONCE on the host, times
    ``encode_batch`` alone over exactly those chunks, then times the whole
    production path (fetch/extract/decode/slice/encode/serialize/upload)
    over the same mirror. The ratio is engine_wall / pipeline_wall —
    identical encode work, so everything below 1.0 is host-pipeline cost —
    and the per-stage table (of the fastest pipeline round) says where it
    went.
    """
    dev = resolve_device(device)
    tmp = work_root or tempfile.mkdtemp(prefix="compare_bench_")
    own_tmp = work_root is None
    try:
        mirror = os.path.join(tmp, "mirror")
        progress("build_mirror")
        total_audio, n_chunks = build_mirror(
            mirror, "en000", subshards, audios, seconds, sr=source_rate,
            container=container,
        )
        engine = _build_pipeline_engine(mimi_cfg, engine_cfg, progress, dev)

        # host-side decode + slice, once: the exact segments the pipeline
        # will encode
        progress("slice_chunks")
        src = LocalSource(mirror)
        sub_work = os.path.join(tmp, "work_slice")
        os.makedirs(sub_work, exist_ok=True)
        sub = SubShardProcessor(engine, sub_work)
        segments = []
        for s in range(subshards):
            sid = f"{s:08d}"
            tar_path, txt_path = src.fetch("en000", sid, sub_work)
            sub.prepare(tar_path)
            with open(txt_path) as f:
                meta = json.load(f)
            for entry in meta:
                audio = sub._load_entry_audio(entry, sub._extract_dir_for(tar_path))
                _check(audio is not None, f"no audio for {entry['audio_id']}")
                _, segs = slice_chunks(audio, entry.get("text", {}), sub.sample_rate)
                segments.extend(segs)
        _check(len(segments) == n_chunks, (len(segments), n_chunks))
        chunk_audio = sum(len(x) for x in segments) / engine.engine_cfg.sample_rate

        progress("engine_warm")
        engine.encode_batch(segments)  # every bucket shape once
        progress("pipeline_warm")
        wall_warm, _ = _process_shard_once(tmp, mirror, engine, "warm", subshards)

        # INTERLEAVED rounds: the host's speed drifts across minutes, so an
        # engine-block-then-pipeline-block timing mostly measures drift.
        # Each round times one engine pass and one pipeline pass
        # back-to-back; the per-round ratio cancels the drift and the
        # MEDIAN round decides.
        eng_walls, pipe_walls, ratios = [], [], []
        stages = {}
        for i in range(passes):
            progress(f"engine_pass_{i + 1}")
            t0 = time.perf_counter()
            engine.encode_batch(segments)
            eng_walls.append(time.perf_counter() - t0)
            engine.stats = EngineStats()
            progress(f"pipeline_pass_{i + 1}")
            wall, rep = _process_shard_once(tmp, mirror, engine, f"p{i}", subshards)
            _check(rep["processed"] == subshards, rep)
            pipe_walls.append(wall)
            if wall == min(pipe_walls):
                # a copy: the next round's engine pass adds into this same
                # stats object before it is replaced
                stages = dict(engine.stats.stage_seconds)
            ratios.append(eng_walls[-1] / wall)
            for d in (f"hub_p{i}", f"work_p{i}", f"prog_p{i}"):
                shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)
        eng_wall = min(eng_walls)
        pipe_wall = min(pipe_walls)

        ratio = float(np.median(ratios))  # same chunk set on both sides
        return {
            "metric": "pipeline_vs_engine_ratio",
            "value": round(ratio, 3),
            "unit": "ratio",
            "detail": {
                "device": device_label(dev),
                "chunk_audio_seconds": round(chunk_audio, 1),
                "chunks": n_chunks,
                "subshards": subshards,
                "engine_wall_seconds": [round(w, 3) for w in eng_walls],
                "pipeline_wall_seconds": [round(w, 3) for w in pipe_walls],
                "round_ratios": [round(r, 3) for r in ratios],
                "engine_x_realtime": round(chunk_audio / eng_wall, 1),
                "pipeline_x_realtime": round(total_audio / pipe_wall, 1),
                "pipeline_x_realtime_chunk_basis": round(chunk_audio / pipe_wall, 1),
                "warm_pass_seconds": round(wall_warm, 2),
                # host_* stages are summed worker-THREAD seconds (overlap
                # encode); engine stages are main-thread wall
                "pipeline_stage_seconds": {k: round(v, 3) for k, v in stages.items()},
            },
        }
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# production-path soak


def run_soak(
    *,
    minutes: float = 30.0,
    subshards: int = 4,
    audios: int = 6,
    seconds: float = 90.0,
    source_rate=24_000,
    container: str = "wav",
    mimi_cfg=None,
    engine_cfg=None,
    work_root: Optional[str] = None,
    progress: Callable[[str], None] = _noop,
    device=None,
) -> dict:
    """Soak the FULL production path continuously for ``minutes`` on one
    card: one long-lived engine (the production shape — one job, one
    process, hours of work) looping whole shard volumes of the YODAS2
    pipeline, recording per-iteration throughput, cumulative engine
    transient-fault retries, and any iteration-level exception. A soak runs
    inside ONE job, so no walltime events occur here by design.

    Emits one heartbeat per iteration via ``progress`` and returns a
    summary with the sustained-throughput band.
    """
    dev = resolve_device(device)
    tmp = work_root or tempfile.mkdtemp(prefix="soak_")
    own_tmp = work_root is None
    try:
        mirror = os.path.join(tmp, "mirror")
        progress("build_mirror")
        total_audio, n_chunks = build_mirror(
            mirror, "en000", subshards, audios, seconds, sr=source_rate,
            container=container,
        )

        engine = _build_pipeline_engine(mimi_cfg, engine_cfg, progress, dev)

        def run_iter(tag):
            # a soak accumulates artifacts forever; clean as production
            # does — in a finally, so a FAILED iteration (the case a soak
            # exists to surface) doesn't leak its partial dirs and turn a
            # disk-pressure failure into disk exhaustion
            try:
                return _process_shard_once(tmp, mirror, engine, tag, subshards)
            finally:
                for d in (f"hub_{tag}", f"work_{tag}", f"prog_{tag}"):
                    shutil.rmtree(os.path.join(tmp, d), ignore_errors=True)

        progress("warm_pass")
        run_iter("warm")  # first-use set-up; not counted

        # fresh stats for the measured window so the cumulative per-stage
        # wall table (engine stages = main-thread wall, host_* stages =
        # summed worker-thread seconds that overlap encode) excludes the
        # warm pass
        engine.stats = EngineStats()

        t_start = time.monotonic()
        budget_end = t_start + minutes * 60
        iters = []
        errors = []
        last_error = None  # most recent error, kept even past the 100 cap:
        # a failure mode that CHANGES late in a long soak (disk-full after
        # hours of transient network errors) must stay visible
        n_errors = 0
        consec_failures = 0
        retries_before = engine.stats.transient_retries
        i = 0
        # run until the budget elapses (plus one trailing iteration if none
        # counted yet); a PERSISTENT failure must terminate, not soak
        # forever — 3 straight failures with zero successes means the path
        # is broken, so bail instead of burning the whole walltime
        while time.monotonic() < budget_end or not iters:
            i += 1
            try:
                wall, rep = run_iter(f"i{i}")
                _check(rep["processed"] == subshards, rep)
                consec_failures = 0
                iters.append(
                    {
                        "iter": i,
                        "x_realtime": round(total_audio / wall, 1),
                        "wall_s": round(wall, 2),
                        "t_min": round((time.monotonic() - t_start) / 60, 2),
                        "transient_retries_total": engine.stats.transient_retries,
                    }
                )
                progress(f"iter_{i}_rt_{iters[-1]['x_realtime']}")
            except Exception as e:  # record, keep soaking (production survives)
                # bound the error log: a persistent FAST failure after one
                # early success would otherwise spin at failure speed for
                # the whole budget and return millions of entries verbatim
                # in the one-JSON-line result
                last_error = {"iter": i, "error": f"{type(e).__name__}: {e}"}
                if len(errors) < 100:
                    errors.append(last_error)
                n_errors += 1
                consec_failures += 1
                progress(f"iter_{i}_ERROR")
                if not iters:
                    if consec_failures >= 3:
                        break  # broken path, not a transient: fail fast
                else:
                    # back off before retrying so a persistent fast failure
                    # after an early success doesn't spin at failure speed
                    # for the whole budget — clamped to the remaining budget
                    # so an expired soak exits instead of oversleeping
                    time.sleep(
                        min(
                            30.0,
                            2.0 * consec_failures,
                            max(0.0, budget_end - time.monotonic()),
                        )
                    )

        if not iters:
            raise RuntimeError(
                f"soak: no successful iterations in {n_errors} attempts; "
                f"last error: {last_error['error']}"
            )
        rts = [it["x_realtime"] for it in iters]
        wall_min = (time.monotonic() - t_start) / 60
        return {
            "metric": "pipeline_soak_sustained",
            "value": float(np.median(rts)),
            "unit": "x_realtime",
            "detail": {
                "device": device_label(dev),
                "soak_minutes": round(wall_min, 1),
                "source_rates": _rates_list(source_rate),
                "container": container,
                "iterations": len(iters),
                "audio_hours_processed": round(len(iters) * total_audio / 3600, 2),
                "chunks_per_iter": n_chunks,
                "rt_min": min(rts),
                "rt_median": float(np.median(rts)),
                "rt_max": max(rts),
                "band_pct": round(100 * (max(rts) - min(rts)) / float(np.median(rts)), 1),
                "transient_retries": engine.stats.transient_retries - retries_before,
                "stage_seconds": {
                    k: round(v, 3) for k, v in engine.stats.stage_seconds.items()
                },
                "error_count": n_errors,
                "iteration_errors": errors,  # first 100 only
                "last_error": last_error,  # survives the 100 cap
                "per_iteration": iters,
            },
        }
    finally:
        if own_tmp:
            shutil.rmtree(tmp, ignore_errors=True)


def _seconds_arg(value: str):
    """Parse ``--seconds`` as a proper usage error instead of the deep
    ValueError traceback build_mirror's library-level guard raises."""
    try:
        s = float(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"expected a number, got {value!r}")
    if s <= 2.0:
        raise argparse.ArgumentTypeError(
            f"--seconds must be > 2.0 (shorter mirror files emit zero "
            f"chunks and the bench would measure nothing), got {value}"
        )
    return s


def _rates_arg(value: str):
    """Parse ``--source-rate`` ("24000" or "16000,48000") into an int or a
    tuple of ints, as a proper usage error rather than a deep traceback."""
    parts = [p.strip() for p in str(value).split(",")]
    try:
        rates = tuple(int(p) for p in parts if p)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected HZ or a comma-list of HZ, got {value!r}"
        )
    if not rates or any(r <= 0 for r in rates):
        raise argparse.ArgumentTypeError(
            f"expected positive sample rate(s), got {value!r}"
        )
    return rates[0] if len(rates) == 1 else rates


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tokenize_audio_tpu_torch.benchmark",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument(
        "--pipeline",
        action="store_true",
        help="full YODAS2 production path instead of the engine-only bench",
    )
    ap.add_argument(
        "--compare",
        action="store_true",
        help="pipeline-vs-engine ratio within ONE process: time encode_batch "
        "over the mirror's exact chunk set, then the full production path "
        "over the same mirror",
    )
    ap.add_argument(
        "--soak",
        type=float,
        default=None,
        metavar="MINUTES",
        help="soak the full production path continuously for MINUTES with "
        "one long-lived engine, reporting the sustained-throughput band, "
        "cumulative transient retries, and any iteration errors",
    )
    ap.add_argument("--subshards", type=int, default=4, help="pipeline: sub-shards")
    ap.add_argument("--audios", type=int, default=6, help="pipeline: audios per sub-shard")
    ap.add_argument(
        "--seconds", type=_seconds_arg, default=90.0,
        help="pipeline: seconds per audio (must be > 2.0)",
    )
    ap.add_argument(
        "--source-rate",
        default=24_000,
        type=_rates_arg,
        metavar="HZ[,HZ...]",
        help="pipeline/soak: mirror WAV sample rate(s), cycled per audio "
        "(e.g. 16000,48000 — real YODAS2 tars are original-rate web audio, "
        "so non-24 kHz adds the per-file on-device resample to the path)",
    )
    ap.add_argument(
        "--container",
        default="wav",
        choices=["wav", "mp3"],
        help="pipeline/soak/compare: mirror payload container — mp3 is the "
        "Emilia/Common Voice class (lame-encoded; a far costlier host decode "
        "than WAV, the case that stresses the decode prefetch pool)",
    )
    ap.add_argument("--utterances", type=int, default=256, help="engine: workload size")
    ap.add_argument("--passes", type=int, default=5, help="engine/compare: measured passes")
    ap.add_argument(
        "--no-fused-16k",
        action="store_true",
        help="engine: skip the secondary fused-resample 16 kHz stage",
    )
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to run on (default: the CUDA device; 'cpu' for the CPU)",
    )
    args = ap.parse_args(argv)

    def progress(stage: str) -> None:
        print(json.dumps({"hb": stage}), file=sys.stderr, flush=True)

    common = dict(progress=progress, device=args.device)
    pipeline_kw = dict(
        subshards=args.subshards,
        audios=args.audios,
        seconds=args.seconds,
        source_rate=args.source_rate,
        container=args.container,
        **common,
    )
    if args.soak is not None:
        result = run_soak(minutes=args.soak, **pipeline_kw)
    elif args.compare:
        result = run_compare(passes=args.passes, **pipeline_kw)
    elif args.pipeline:
        result = run_pipeline_bench(**pipeline_kw)
    else:
        # the headline must be unlosable: if the optional fused stage
        # raises or the operator interrupts it, the already-measured
        # headline still reaches stdout
        stash: dict = {}
        try:
            result = run_engine_bench(
                n_utts=args.utterances,
                passes=args.passes,
                on_headline=lambda r: stash.update(result=r),
                fused_16k=not args.no_fused_16k,
                **common,
            )
        except BaseException:
            if "result" in stash:
                print(json.dumps(stash["result"]))
                sys.stdout.flush()
            raise
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
