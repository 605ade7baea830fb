"""PyTorch port, CLI: the shared engine flags (``add_engine_args``) reach the
port's engine (``engine_from_args``) on the tiny config, the kernel backends
are the default, --fast, --precision high, the drains and the auto /
auto-data probes run (mirroring tests/test_cli.py of the JAX package),
--long-audio-policy stream streams, and --warmup / --profile-dir do what
they say."""

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


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's many small CPU encodes on one torch thread: under
    the parallel test runner the cores are shared by several workers, and
    each tiny op's wait on its sibling threads costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("flags", [["--drain-policy", "threaded"],
                                   ["--code-transfer-format", "compact"]])
def test_removed_drain_and_format_are_refused(parse, capsys, flags):
    """The "threaded" drain and the "compact" wire format are gone: the
    parser refuses either before an engine is built."""
    with pytest.raises(SystemExit):
        parse(flags)
    assert f"invalid choice: '{flags[1]}'" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--fast"], ["--precision", "high"],
    ["--code-transfer-format", "auto"], ["--code-transfer-format", "auto-data"],
    ["--pipeline-depth", "auto"], ["--pipeline-depth", "auto-data"],
    ["--drain-policy", "auto"], ["--drain-policy", "ready"],
])
def test_unported_features_parse_then_raise(parse, monkeypatch, flags):
    """Each of these flags, refused before its feature was ported, now
    reaches the engine: the mode is set, or its probe runs (at startup for
    'auto', on the first batch for 'auto-data'), after --warmup, and the
    engine encodes."""
    warmed = []
    monkeypatch.setattr(MimiEncoderEngine, "warmup",
                        lambda self, sr=24_000, include_tails=False: warmed.append(sr) or 0)
    args = parse(flags + ["--device", "cpu", "--warmup", "--autotune-seconds", "1",
                          "--batch-size", "2", "--max-chunk-seconds", "2"])
    eng = cli.engine_from_args(args)
    assert warmed[:3] == [24_000, 16_000, 48_000]  # warmed before any probe
    probed = {"--code-transfer-format": "last_autotune", "--pipeline-depth": "last_autotune_depth",
              "--drain-policy": "last_autotune_drain"}.get(flags[0])
    value = flags[-1]
    if value == "auto":
        assert getattr(eng, probed)
    elif value == "auto-data":
        assert eng._pending_autotune is not None and not getattr(eng, probed)
    rng = np.random.default_rng(0)
    codes = eng.encode_batch([(rng.standard_normal(5000) * 0.3).astype(np.float32)])
    assert codes[0].shape == (8, 3)
    if value == "auto-data":
        assert eng._pending_autotune is None and getattr(eng, probed)
    assert eng.cfg.compute_dtype == ("bfloat16" if flags == ["--fast"] else "float32")
    assert eng.cfg.matmul_precision == ("high" if flags[0] == "--precision" else "highest")
    if value == "ready":
        assert eng.engine_cfg.drain_policy == value


def test_pipeline_depth_and_autodata_flag_plumbing(parse, monkeypatch):
    """--pipeline-depth N reaches the engine; 'auto' runs the depth probe at
    startup with --autotune-seconds; 'auto-data' + --code-transfer-format
    auto-data defer both probes to the first real batch."""
    assert cli.engine_from_args(parse(["--device", "cpu", "--pipeline-depth", "5"])
                                ).pipeline_depth == 5
    calls = {}
    monkeypatch.setattr(MimiEncoderEngine, "autotune_pipeline_depth",
                        lambda self, **kw: calls.setdefault("depth", kw) or 7)
    monkeypatch.setattr(MimiEncoderEngine, "autotune_transfer",
                        lambda self, **kw: calls.setdefault("transfer", kw) or "packed")
    cli.engine_from_args(parse(["--device", "cpu", "--pipeline-depth", "auto",
                                "--autotune-seconds", "2.5"]))
    assert calls["depth"]["seconds"] == 2.5 and "transfer" not in calls
    eng = cli.engine_from_args(parse(["--device", "cpu", "--pipeline-depth", "auto-data",
                                      "--code-transfer-format", "auto-data"]))
    pa = eng._pending_autotune
    assert pa and pa["transfer"] and pa["depth"]


def fake_tune(self, **kw):
    self._set_transfer_format("padded")  # switch away from the default
    return "padded"


def test_warmup_reruns_after_autotune_format_switch(parse, monkeypatch):
    """--warmup + --code-transfer-format auto: when the probe switches the
    format, the lattices are warmed again for the chosen one."""
    warmed = []
    monkeypatch.setattr(MimiEncoderEngine, "warmup",
                        lambda self, sr=24_000, include_tails=False: warmed.append(sr) or 0)
    monkeypatch.setattr(MimiEncoderEngine, "autotune_transfer", fake_tune)
    cli.engine_from_args(parse(["--device", "cpu", "--warmup", "--code-transfer-format", "auto"]))
    assert warmed == [24_000, 16_000, 48_000] * 2


def test_warmup_reruns_after_deferred_autodata_format_switch(parse, monkeypatch):
    """--warmup + --code-transfer-format auto-data: the probe runs on the
    first real batch, and when it switches formats there the lattices are
    warmed again (request_autotune's on_complete)."""
    warmed = []
    monkeypatch.setattr(MimiEncoderEngine, "warmup",
                        lambda self, sr=24_000, include_tails=False: warmed.append(sr) or 0)
    monkeypatch.setattr(MimiEncoderEngine, "autotune_transfer", fake_tune)
    eng = cli.engine_from_args(parse(["--device", "cpu", "--warmup", "--code-transfer-format",
                                      "auto-data", "--batch-size", "2"]))
    assert warmed == [24_000, 16_000, 48_000]
    eng.encode_batch([(np.random.default_rng(1).standard_normal(6000) * 0.3).astype(np.float32)])
    assert warmed == [24_000, 16_000, 48_000] * 2


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
