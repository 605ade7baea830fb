"""PyTorch port, CLI: the shared engine flags (``add_engine_args``) reach the
port's engine (``engine_from_args``) on the tiny config, the kernel backends
are the default, unported features parse and then raise
NotImplementedError, --long-audio-policy stream streams, and --warmup /
--profile-dir do what they say."""

import argparse
import dataclasses
import glob
import os
import types

import numpy as np
import pytest
import torch

from tests.mimi_fixtures import tiny_jax_config
from tokenize_audio_tpu_torch import cli
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
from tokenize_audio_tpu_torch.mimi.weights import random_params

TINY = MimiConfig(**{f.name: getattr(tiny_jax_config(), f.name)
                     for f in dataclasses.fields(MimiConfig)
                     if f.name not in ("rvq_backend", "seanet_backend")})


@pytest.fixture
def parse(monkeypatch):
    """Parse engine flags with the tiny config and its seeded random params
    standing in for the full-width model."""
    monkeypatch.setattr(cli, "MimiConfig", lambda **kw: dataclasses.replace(TINY, **kw))
    monkeypatch.setattr(cli, "random_params", lambda c: random_params(c, seed=0))
    ap = argparse.ArgumentParser()
    cli.add_engine_args(ap)
    return ap.parse_args


def test_defaults_are_the_kernels_on_the_card(parse):
    args = parse([])
    assert (args.rvq_backend, args.seanet_backend, args.device) == ("kernel", "kernel", None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.engine_from_args(args)


def test_flag_plumbing(parse):
    eng = cli.engine_from_args(parse([
        "--device", "cpu", "--growth", "1.3", "--code-transfer-format", "padded",
        "--batch-size", "4", "--samples-per-batch", "96000", "--max-chunk-seconds", "2",
        "--pipeline-depth", "3", "--drain-policy", "fifo", "--rvq-backend", "torch",
    ]), num_codebooks=6)
    assert eng.device == torch.device("cpu") and eng.num_codebooks == 6
    assert (eng.cfg.rvq_backend, eng.cfg.seanet_backend) == ("torch", "kernel")
    ecfg = eng.engine_cfg
    assert (ecfg.bucket_growth, ecfg.code_transfer_format, ecfg.batch_size) == (1.3, "padded", 4)
    assert (ecfg.samples_per_batch, ecfg.max_chunk_seconds, eng.pipeline_depth) == (96000, 2.0, 3)
    rng = np.random.default_rng(0)
    codes = eng.encode_batch([(rng.standard_normal(2000) * 0.3).astype(np.float32)])
    assert codes[0].shape == (6, 2)


@pytest.mark.parametrize("flag", ["--rvq-backend", "--seanet-backend"])
@pytest.mark.parametrize("value", ["xla", "pallas"])
def test_jax_backend_names_are_refused(parse, flag, value):
    with pytest.raises(SystemExit):
        parse([flag, value])


@pytest.mark.parametrize("flags", [
    ["--fast"], ["--precision", "high"],
    ["--code-transfer-format", "auto"], ["--code-transfer-format", "auto-data"],
    ["--pipeline-depth", "auto"], ["--pipeline-depth", "auto-data"],
    ["--drain-policy", "auto"], ["--drain-policy", "ready"], ["--drain-policy", "threaded"],
])
def test_unported_features_parse_then_raise(parse, monkeypatch, flags):
    warmed = []
    monkeypatch.setattr(MimiEncoderEngine, "warmup",
                        lambda self, sr=24_000, include_tails=False: warmed.append(sr) or 0)
    args = parse(flags + ["--device", "cpu", "--warmup"])
    with pytest.raises(NotImplementedError):
        cli.engine_from_args(args)
    assert warmed == []  # refused before any warmup work


def test_long_audio_policy_stream_reaches_the_engine(parse):
    eng = cli.engine_from_args(parse(["--device", "cpu", "--long-audio-policy", "stream",
                                      "--max-chunk-seconds", "0.25"]))
    assert eng.engine_cfg.long_audio_policy == "stream"
    audio = (np.random.default_rng(1).standard_normal(12_000) * 0.3).astype(np.float32)
    assert eng.encode_chunk(audio).shape == (8, 7)
    assert eng.stats.stage_seconds["stream"] > 0  # over the cap: streamed


@pytest.mark.parametrize("tails", [False, True])
def test_warmup_flags(parse, monkeypatch, tails):
    calls = []
    monkeypatch.setattr(MimiEncoderEngine, "warmup",
                        lambda self, sr=24_000, include_tails=False:
                        calls.append((sr, include_tails)) or 0)
    cli.engine_from_args(parse(["--device", "cpu", "--warmup"]
                               + (["--warmup-tails"] if tails else [])))
    assert calls == [(24_000, tails), (16_000, tails), (48_000, tails)]


def test_pipeline_depth_validation(parse):
    for bad in ("aut0", "0", "-3", "2.5"):
        with pytest.raises(SystemExit):
            parse(["--pipeline-depth", bad])
    assert parse(["--pipeline-depth", "7"]).pipeline_depth == 7
    assert parse(["--pipeline-depth", "auto"]).pipeline_depth == "auto"


def test_profile_dir_records_a_torch_profiler_trace(parse, tmp_path, monkeypatch):
    stoppers = []
    monkeypatch.setattr(cli, "atexit", types.SimpleNamespace(register=stoppers.append))
    trace_dir = str(tmp_path / "trace")
    eng = cli.engine_from_args(parse(["--device", "cpu", "--profile-dir", trace_dir,
                                      "--batch-size", "1"]))
    eng.encode_batch([np.zeros(2000, dtype=np.float32)])
    assert len(stoppers) == 1
    stoppers[0]()  # what the process does at exit
    found = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(found) == 1 and os.path.getsize(found[0]) > 0
