"""PyTorch port, engine modes on the CPU at the tiny oracle config: the
"ready" drain, transient-fault retry and the autotune
probes, held against the JAX package's engine (codes bit-equal) and
mirroring its tests (tests/test_engine.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.engine import encoder as enc_mod
from tokenize_audio_tpu_torch.mimi.streaming import StreamingMimiEncoder
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

KW = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0)
# one utterance list for every test held against the JAX engine, so the
# JAX side compiles its batch shapes once
LENGTHS = [5000, 19200, 30000]
DRAIN_KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=4.0)
DRAIN_LENGTHS = [1000, 5000, 19200, 26000, 7777, 1920, 600, 95000, 3333, 40000]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run this module's many small CPU encodes on one torch thread: under
    the parallel test runner the cores are shared by several workers, and
    each tiny op's wait on its sibling threads costs more than the op."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return params, jcfg, config_from_hf(model.config)


def utts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]


@pytest.fixture(scope="module")
def audios():
    return utts(0, LENGTHS)


@pytest.fixture(scope="module")
def want(oracle, audios):
    """The JAX engine's codes for ``audios`` under KW."""
    params, jcfg, _ = oracle
    return JaxEngine(params, jcfg, JaxEngineConfig(**KW)).encode_batch(audios)


@pytest.fixture(scope="module")
def fifo_drain(oracle):
    """A FIFO engine's codes and frame counters for the drain workload."""
    eng = engine(oracle, **DRAIN_KW, pipeline_depth=4)
    got = eng.encode_batch(utts(5, DRAIN_LENGTHS))
    return got, eng.stats.frames, eng.stats.padded_frames


def engine(oracle, **kw):
    params, _, cfg = oracle
    depth = kw.pop("pipeline_depth", 18)
    return MimiEncoderEngine(params, cfg, EngineConfig(**{**KW, **kw}), pipeline_depth=depth,
                             device="cpu")


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def oom():
    return torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def flaky(real, fails, exc=oom):
    """``real`` that raises ``exc()`` while ``fails["n"]`` counts down."""
    def call(*a, **k):
        if fails["n"]:
            fails["n"] -= 1
            raise exc()
        return real(*a, **k)

    return call


def test_collect_fault_retried_once(oracle, audios, want, monkeypatch):
    """A transient fault at collect re-dispatches the batch once (encode is
    stateless): codes equal the JAX engine's and the retry is counted. A
    persistent fault still raises (the second failure propagates)."""
    eng = engine(oracle)
    fails = {"n": 1}
    monkeypatch.setattr(eng, "_collect", flaky(eng._collect, fails))
    assert_same(eng.encode_batch(audios), want)
    assert eng.stats.transient_retries == 1
    fails["n"] = 10_000
    with pytest.raises(torch.OutOfMemoryError):
        eng.encode_batch(audios)


def test_dispatch_fault_retried_once(oracle, audios, want, monkeypatch):
    """A fault raised synchronously inside _dispatch (an allocation on the
    card) gets the same single retry."""
    eng = engine(oracle)
    monkeypatch.setattr(enc_mod, "mimi_encode", flaky(enc_mod.mimi_encode, {"n": 1}))
    assert_same(eng.encode_batch(audios), want)
    assert eng.stats.transient_retries == 1


def test_stream_fault_retried_once(oracle, monkeypatch):
    """A stream group that dies with a transient fault re-streams from
    scratch (encode_streams resets carried state at entry, so the retry is
    exact)."""
    eng = engine(oracle, max_chunk_seconds=2.0, long_audio_policy="stream")
    audios = utts(2, [int(24_000 * 2.6)])
    ref = eng.encode_batch(audios)
    monkeypatch.setattr(StreamingMimiEncoder, "encode_streams",
                        flaky(StreamingMimiEncoder.encode_streams, {"n": 1}))
    assert_same(eng.encode_batch(audios), ref)
    assert eng.stats.transient_retries == 1


def test_build_and_launch_failures_are_not_retried(oracle, monkeypatch):
    """A failed kernel build or launch (a plain RuntimeError from
    ops/cuda) would fail the same way again: it raises at once, uncounted."""
    eng = engine(oracle)
    for msg in ("nvcc failed to build rvq.cu", "resblock kernel launch failed: cudaError 1"):
        fails = {"n": 1}
        monkeypatch.setattr(enc_mod, "mimi_encode",
                            flaky(enc_mod.mimi_encode, fails, lambda: RuntimeError(msg)))
        with pytest.raises(RuntimeError, match=msg.split()[0]):
            eng.encode_batch(utts(3, [5000]))
        assert fails["n"] == 0 and eng.stats.transient_retries == 0


def test_accelerator_error_retried_only_if_the_device_recovers(oracle, audios, want,
                                                              monkeypatch):
    """A CUDA error is retried when a health probe afterwards runs, and
    re-raised when it fails (a sticky error poisons the context)."""
    err = getattr(torch, "AcceleratorError", None)
    if err is None:
        pytest.skip("this torch has no AcceleratorError")
    eng = engine(oracle)
    fails = {"n": 1}
    monkeypatch.setattr(enc_mod, "mimi_encode",
                        flaky(enc_mod.mimi_encode, fails, lambda: err("an illegal memory access")))
    assert_same(eng.encode_batch(audios), want)
    assert eng.stats.transient_retries == 1
    fails["n"] = 1
    monkeypatch.setattr(eng, "_device_recovers", lambda exc: False)
    with pytest.raises(err):
        eng.encode_batch(audios)
    assert eng.stats.transient_retries == 1


@pytest.mark.parametrize("policy", ["ready"])
def test_drains_bit_equal_to_fifo(oracle, fifo_drain, policy):
    """"ready" collects whichever batch is ready first (FIFO on the CPU,
    where no batch has an event): order and bits equal FIFO's (held equal
    to the JAX engine's by tests/test_torch_engine.py) across buckets and
    tails at depth 4, eager and deferred, with the same frame counters."""
    fifo, frames, padded = fifo_drain
    other = engine(oracle, **DRAIN_KW, drain_policy=policy, pipeline_depth=4)
    audios = utts(5, DRAIN_LENGTHS)
    assert_same(other.encode_batch(audios), fifo)
    assert (other.stats.frames, other.stats.padded_frames) == (frames, padded)
    assert_same(other.encode_batch(audios, defer=True)(), fifo)


def test_drain_policy_validated(oracle):
    with pytest.raises(ValueError, match="drain_policy"):
        engine(oracle, drain_policy="lifo")


def test_autotune_transfer(oracle, audios, want):
    """autotune_transfer probes the eligible wire formats, keeps the
    fastest, and is numerically invisible; throughput stats never see the
    probe."""
    eng = engine(oracle)
    stats_before = eng.stats
    chosen = eng.autotune_transfer(seconds=3.0, rounds=1)
    assert chosen in ("packed", "padded") and eng.engine_cfg.code_transfer_format == chosen
    assert set(eng.last_autotune) == {"packed", "padded"}
    assert eng.stats is stats_before and eng.stats.utterances == 0
    assert_same(eng.encode_batch(audios), want)


def test_autotune_on_samples(oracle, audios, want):
    """samples= probes the caller's real utterances, capped to seconds."""
    eng = engine(oracle)
    chosen = eng.autotune_transfer(seconds=1.0, rounds=1, samples=audios)
    assert chosen in ("packed", "padded") and set(eng.last_autotune) == {"packed", "padded"}
    assert_same(eng.encode_batch(audios), want)


def test_autotune_pipeline_depth(oracle, audios, want):
    eng = engine(oracle)
    best = eng.autotune_pipeline_depth(depths=(1, 2), seconds=2.0, rounds=1)
    assert best in (1, 2) and eng.pipeline_depth == best
    assert set(eng.last_autotune_depth) == {1, 2}
    assert_same(eng.encode_batch(audios), want)
    with pytest.raises(ValueError, match="depths"):
        eng.autotune_pipeline_depth(depths=(0,), seconds=0.5, rounds=1)


def test_autotune_drain_policy(oracle, audios, want):
    """The probe picks a policy, records per-policy medians, and rejects
    junk names and the removed "threaded" drain."""
    eng = engine(oracle)
    best = eng.autotune_drain_policy(seconds=2.0, rounds=1)
    assert best in ("fifo", "ready") and eng.engine_cfg.drain_policy == best
    assert set(eng.last_autotune_drain) == {"fifo", "ready"}
    assert_same(eng.encode_batch(audios), want)
    with pytest.raises(ValueError, match="drain"):
        eng.autotune_drain_policy(policies=("fifo", "bogus"), seconds=0.5, rounds=1)
    with pytest.raises(ValueError, match="threaded"):
        eng.autotune_drain_policy(policies=("fifo", "threaded"), seconds=0.5, rounds=1)


def test_request_autotune_defers_to_first_batch(oracle, audios, want):
    """request_autotune probes on the FIRST encode_batch call's own
    utterances, then encodes that batch with the chosen config; stats count
    only the real batch."""
    eng = engine(oracle)
    eng.request_autotune(transfer=True, depth=True, seconds=1.0, rounds=1, depths=(1, 2))
    assert eng._pending_autotune is not None and not eng.last_autotune
    assert_same(eng.encode_batch(audios), want)
    assert eng._pending_autotune is None
    assert eng.last_autotune and eng.last_autotune_depth
    assert eng.stats.utterances == len(audios)


def test_request_autotune_on_complete(oracle):
    """on_complete runs once, after the deferred probes pick and before the
    triggering batch encodes."""
    eng = engine(oracle)
    fired = []
    eng.request_autotune(transfer=True, seconds=1.0, rounds=1,
                         on_complete=lambda: fired.append(dict(eng.last_autotune)))
    audios = utts(11, [7000])
    eng.encode_batch(audios)
    [at_fire] = fired
    assert set(at_fire) == {"packed", "padded"}
    eng.encode_batch(audios)
    assert len(fired) == 1


def test_probe_workload_caps_channels_first_samples(oracle):
    """The seconds cap measures the TIME axis of (C, T) samples."""
    eng = engine(oracle)
    rng = np.random.default_rng(12)
    stereo = [(rng.standard_normal((2, 48_000)) * 0.3).astype(np.float32) for _ in range(10)]
    got, _ = eng._probe_workload(seconds=4.0, seed=0, samples=stereo)
    assert len(got) == 2


def test_autotune_single_candidate_skips_probe(oracle, monkeypatch):
    params, _, cfg = oracle
    eng = MimiEncoderEngine(params, cfg, EngineConfig(batch_size=2, min_bucket_seconds=0.5),
                            num_codebooks=1, device="cpu")
    monkeypatch.setattr(MimiEncoderEngine, "_interleaved_ab",
                        lambda *a, **k: pytest.fail("probe must not run for a single candidate"))
    assert eng.autotune_transfer(seconds=5.0) == "padded"
    assert eng.engine_cfg.code_transfer_format == "padded"


# (probe, the encode_batch call it is interrupted at): a pass run under a
# candidate other than the engine's own
@pytest.mark.parametrize("probe,at", [("transfer", 3), ("depth", 3), ("drain", 4)])
def test_interrupted_probe_restores_the_engine(oracle, monkeypatch, probe, at):
    """A probe interrupted mid-way (KeyboardInterrupt, which ``except
    Exception`` would miss) leaves the engine in its own config, depth and
    stats."""
    eng = engine(oracle, batch_size=2, code_transfer_format="padded", pipeline_depth=5)
    cfg_before, stats_before = eng.engine_cfg, eng.stats
    real, calls = MimiEncoderEngine.encode_batch, {"n": 0}

    def interrupted(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == at:
            raise KeyboardInterrupt
        return real(self, *a, **k)

    monkeypatch.setattr(MimiEncoderEngine, "encode_batch", interrupted)
    run = {
        "transfer": lambda: eng.autotune_transfer(seconds=1.0, rounds=1),
        "depth": lambda: eng.autotune_pipeline_depth(depths=(1, 2, 3), seconds=1.0, rounds=1),
        "drain": lambda: eng.autotune_drain_policy(seconds=1.0, rounds=1),
    }[probe]
    with pytest.raises(KeyboardInterrupt):
        run()
    assert calls["n"] == at
    assert eng.engine_cfg is cfg_before and eng.pipeline_depth == 5
    assert eng.stats is stats_before and eng.stats.utterances == 0
    monkeypatch.setattr(MimiEncoderEngine, "encode_batch", real)
    assert eng.encode_batch(utts(13, [5000]))[0].shape == (8, 3)


def test_bf16_engine_launch_path(oracle):
    """A bf16 engine casts its conv/transformer weights once and packs no
    resblock weights (the fused kernel takes float32 only); its stream
    encoders get the float32 tree."""
    params, _, cfg = oracle
    eng = MimiEncoderEngine(params, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                            device="cpu")
    assert eng.params["enc_in"]["w"].dtype == torch.bfloat16
    assert eng.params["rvq"]["semantic"]["embed"].dtype == torch.float32
    assert "packed" not in eng.params["blocks"][0]["res"][0]
    assert eng.params["rvq"]["semantic"]["packed"][0].dtype == torch.float32
    assert eng._stream_params["enc_in"]["w"].dtype == torch.float32
    assert eng._stream_params["rvq"] is eng.params["rvq"]
