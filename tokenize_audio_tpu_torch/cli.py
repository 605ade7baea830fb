"""Shared CLI plumbing for the dataset processors: engine flags + bootstrap."""

from __future__ import annotations

import argparse
import atexit
import logging
from typing import Optional

import torch

from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors, random_params

logger = logging.getLogger(__name__)


def _depth_arg(v: str):
    """--pipeline-depth: 'auto', 'auto-data', or an int >= 1 — validated
    at parse time (a typo'd 'aut0' or a depth of 0 should be a usage
    error, not a traceback from deep inside engine construction)."""
    if v in ("auto", "auto-data"):
        return v
    try:
        iv = int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto'/'auto-data', got {v!r}"
        )
    if iv < 1:
        raise argparse.ArgumentTypeError(f"depth must be >= 1, got {iv}")
    return iv


def add_engine_args(ap: argparse.ArgumentParser, batch_size: int = 16) -> None:
    ap.add_argument("--params", default=None, help="mimi safetensors checkpoint")
    ap.add_argument(
        "--device",
        default=None,
        help="torch device to encode on (default: the CUDA device; 'cpu' runs "
        "the plain PyTorch path on the CPU)",
    )
    ap.add_argument("--batch-size", type=int, default=batch_size)
    ap.add_argument("--samples-per-batch", type=int, default=None)
    ap.add_argument("--max-chunk-seconds", type=float, default=60.0)
    ap.add_argument(
        "--growth",
        type=float,
        default=None,
        help="bucket-lattice growth factor (default EngineConfig.bucket_growth; "
        "finer = less padding waste but more distinct batch shapes)",
    )
    ap.add_argument(
        "--fast",
        action="store_true",
        help="bfloat16 compute (SEANet, transformer and downsample; RVQ and "
        "streaming stay float32): NOT a parity mode, codes differ from "
        "parity's (the fused resblock kernel, float32 only, gives way to "
        "the plain convs)",
    )
    ap.add_argument(
        "--precision",
        default="highest",
        choices=["highest", "high"],
        help="float32 conv/matmul precision: highest = IEEE fp32, bit-exact "
        "parity (default); high = TF32 on the card for the SEANet convs, "
        "transformer and downsample (resample, quantizer and RVQ stay IEEE) "
        "— a throughput mode, not parity",
    )
    ap.add_argument(
        "--rvq-backend",
        default="kernel",
        choices=["kernel", "torch"],
        help="kernel = the hand-written CUDA RVQ kernel (default); torch = "
        "plain PyTorch ops",
    )
    ap.add_argument(
        "--seanet-backend",
        default="kernel",
        choices=["kernel", "torch"],
        help="kernel = the fused SEANet-resblock CUDA kernel (default); torch "
        "= plain PyTorch convs",
    )
    ap.add_argument(
        "--code-transfer-format",
        default=None,
        choices=["padded", "packed", "compact", "auto", "auto-data"],
        help="device->host code wire format (default EngineConfig default; "
        "see config.py — 'compact' fetches only packed valid frames). "
        "'auto' probes packed vs padded on this machine with an "
        "interleaved A/B at startup and keeps the fastest; 'auto-data' "
        "defers the probe to the first real batch and times the shard's "
        "own utterances instead of a synthetic workload",
    )
    ap.add_argument(
        "--pipeline-depth",
        default=None,
        type=_depth_arg,
        help="in-flight device batches (int >= 1; engine default 18). "
        "'auto' probes {6,12,18} on a synthetic workload at startup; "
        "'auto-data' probes on the first real batch",
    )
    ap.add_argument(
        "--drain-policy",
        default=None,
        choices=["fifo", "ready", "threaded", "auto"],
        help="in-flight batch collection order (default EngineConfig "
        "default): fifo = dispatch order; ready = whichever batch's codes "
        "reached the host first; threaded = a small fetch pool collects "
        "them. Bit- and order-identical in every mode (pure transport "
        "scheduling). 'auto' runs the interleaved probe at startup",
    )
    ap.add_argument(
        "--autotune-seconds",
        type=float,
        default=40.0,
        help="with an auto/auto-data format, depth or drain: seconds of "
        "audio per probe pass (smaller = faster startup, noisier pick)",
    )
    ap.add_argument(
        "--profile-dir",
        default=None,
        help="record a torch.profiler trace (host and CUDA activity) of the "
        "whole run into this directory as a Chrome trace (*.pt.trace.json; "
        "open in Perfetto or TensorBoard)",
    )
    ap.add_argument(
        "--warmup",
        action="store_true",
        help="encode one full batch per bucket of the 24/16/48 kHz lattices "
        "before processing, so the kernels' build, cuDNN's algorithm "
        "selection and the allocator's pools are set up before the first "
        "shard",
    )
    ap.add_argument(
        "--warmup-tails",
        action="store_true",
        help="with --warmup: also warm every tail-ladder batch size",
    )
    ap.add_argument(
        "--long-audio-policy",
        default="split",
        choices=["split", "stream"],
        help="split = reference-parity 60s cuts; stream = exact codes via "
        "the streaming encoder up to 320s",
    )


def _start_profiler(trace_dir: str) -> None:
    """Record a torch.profiler trace from now until the process exits. It
    holds the program's ``tokenize_audio::`` ranges (``ranges.span``) on
    the kernels' clock, from every thread: the processors' prefetch and
    upload workers and the engine's deferred collects too."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(trace_dir),
    )
    prof.start()
    atexit.register(prof.stop)  # writes the trace


def engine_from_args(
    args, num_codebooks: Optional[int] = None, **engine_overrides
) -> MimiEncoderEngine:
    """Build the encode engine from the shared flags, on ``--device`` (the
    CUDA device unless the caller asks for another)."""
    cfg = MimiConfig(
        compute_dtype="bfloat16" if getattr(args, "fast", False) else "float32",
        matmul_precision=getattr(args, "precision", "highest"),
        rvq_backend=getattr(args, "rvq_backend", "kernel"),
        seanet_backend=getattr(args, "seanet_backend", "kernel"),
    )
    if args.params:
        params = params_from_safetensors(args.params, cfg)
    else:
        logger.warning("no --params given; using seeded random weights")
        params = random_params(cfg)
    if getattr(args, "growth", None) is not None:
        engine_overrides.setdefault("bucket_growth", args.growth)
    fmt_arg = getattr(args, "code_transfer_format", None)
    if fmt_arg is not None and fmt_arg not in ("auto", "auto-data"):
        engine_overrides.setdefault("code_transfer_format", fmt_arg)
    drain_arg = getattr(args, "drain_policy", None)
    if drain_arg is not None and drain_arg != "auto":
        engine_overrides.setdefault("drain_policy", drain_arg)
    depth_arg = getattr(args, "pipeline_depth", None)
    depth_kw = {}
    if depth_arg is not None and depth_arg not in ("auto", "auto-data"):
        depth_kw["pipeline_depth"] = int(depth_arg)
    ecfg = EngineConfig(
        batch_size=args.batch_size,
        samples_per_batch=getattr(args, "samples_per_batch", None),
        max_chunk_seconds=getattr(args, "max_chunk_seconds", 60.0),
        long_audio_policy=getattr(args, "long_audio_policy", "split"),
        **engine_overrides,
    )
    engine = MimiEncoderEngine(
        params, cfg, ecfg, num_codebooks=num_codebooks,
        device=getattr(args, "device", None), **depth_kw,
    )
    if getattr(args, "profile_dir", None):
        _start_profiler(args.profile_dir)

    def run_warmup() -> None:
        # warm every standard corpus rate's lattice: 24 kHz (YODAS2/
        # Emilia/LibriTTS), 16 kHz (LibriSpeech/MLS — the fused-resample
        # SOURCE-rate lattice is a different set of batch shapes), 48 kHz
        # (Common Voice)
        tails = getattr(args, "warmup_tails", False)
        n = sum(
            engine.warmup(sr=sr, include_tails=tails)
            for sr in (24_000, 16_000, 48_000)
        )
        logger.info("warmed %d bucket batch shapes", n)

    warmup = getattr(args, "warmup", False)
    if warmup:
        # warm BEFORE the probes, so the default format's first-use set-up
        # never lands in a probe's timings
        run_warmup()
    probe_s = getattr(args, "autotune_seconds", 40.0)
    if "auto" in (fmt_arg, depth_arg, drain_arg):
        fmt_before = engine.engine_cfg.code_transfer_format
        if fmt_arg == "auto":
            engine.autotune_transfer(seconds=probe_s)
        if depth_arg == "auto":
            engine.autotune_pipeline_depth(seconds=probe_s)
        if drain_arg == "auto":
            engine.autotune_drain_policy(seconds=probe_s)
        if warmup and engine.engine_cfg.code_transfer_format != fmt_before:
            # the probe warmed only the chosen format's shapes for ITS
            # durations; re-warm the full lattices for the chosen format
            run_warmup()
    if "auto-data" in (fmt_arg, depth_arg):
        fmt_before_deferred = engine.engine_cfg.code_transfer_format

        def rewarm_if_format_switched() -> None:
            # the same contract for the probe on the first real batch
            if warmup and engine.engine_cfg.code_transfer_format != fmt_before_deferred:
                run_warmup()

        engine.request_autotune(
            transfer=fmt_arg == "auto-data",
            depth=depth_arg == "auto-data",
            seconds=probe_s,
            on_complete=rewarm_if_format_switched,
        )
    return engine
