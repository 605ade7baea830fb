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
        help="bfloat16 compute: not a parity mode, and not ported yet (the "
        "engine raises NotImplementedError)",
    )
    ap.add_argument(
        "--precision",
        default="highest",
        choices=["highest", "high"],
        help="matmul precision: highest = IEEE fp32, bit-exact parity "
        "(default); high is not ported yet (the engine raises "
        "NotImplementedError)",
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
        "'auto' and 'auto-data' (probe the formats at startup or on the "
        "first real batch) are not ported yet: the engine raises "
        "NotImplementedError",
    )
    ap.add_argument(
        "--pipeline-depth",
        default=None,
        type=_depth_arg,
        help="in-flight device batches (int >= 1; engine default 18). "
        "'auto' and 'auto-data' (probe the depth) are not ported yet: the "
        "engine raises NotImplementedError",
    )
    ap.add_argument(
        "--drain-policy",
        default=None,
        choices=["fifo", "ready", "threaded", "auto"],
        help="in-flight batch collection order (default EngineConfig "
        "default): fifo = dispatch order. ready, threaded and auto are not "
        "ported yet: the engine raises NotImplementedError",
    )
    ap.add_argument(
        "--autotune-seconds",
        type=float,
        default=40.0,
        help="with an auto/auto-data format or depth: seconds of audio "
        "per probe pass",
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
    """Record a torch.profiler trace from now until the process exits."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
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

    # the format/depth/drain probes are not ported yet (ROADMAP queue A #12):
    # each of these calls raises NotImplementedError, before any warmup
    probe_s = getattr(args, "autotune_seconds", 40.0)
    if fmt_arg == "auto":
        engine.autotune_transfer(seconds=probe_s)
    if depth_arg == "auto":
        engine.autotune_pipeline_depth(seconds=probe_s)
    if drain_arg == "auto":
        engine.autotune_drain_policy(seconds=probe_s)
    if "auto-data" in (fmt_arg, depth_arg):
        engine.request_autotune(
            transfer=fmt_arg == "auto-data",
            depth=depth_arg == "auto-data",
            seconds=probe_s,
        )
    if getattr(args, "warmup", False):
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
    return engine
