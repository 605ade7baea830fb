"""PyTorch port, benchmark: the synthetic mirror and the mp3 encoder
byte-identical to the JAX package's, the engine bench's seeded workload and
its codes (24 kHz and fused 16 kHz) equal to the JAX engine's (tiny config,
the same params), and the contracts of every mode on the CPU
(``device="cpu"``): engine, pipeline (source rates, mp3), compare (with the
fastest round's own stage table), soak, the argument parsers and ``main``.
No result line carries ``vs_baseline``."""

import argparse
import json
import os
import tarfile

import numpy as np
import pytest
import torch

import tokenize_audio_tpu.engine as jax_engine_module
from tests.mimi_fixtures import make_oracle, tiny_hf_config, tiny_jax_config
from tokenize_audio_tpu import benchmark as jax_bench
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu.io import mp3enc as jax_mp3enc
from tokenize_audio_tpu_torch import benchmark as B
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.io import mp3enc
from tokenize_audio_tpu_torch.mimi import random_params
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

SPF = 1920
TINY = config_from_hf(tiny_hf_config())
KEYS = {"metric", "value", "unit", "detail"}


def tiny_engine_cfg(**kw):
    return EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0, **kw)


# the tiny config on the CPU, as every runner below is called
ON_CPU = dict(mimi_cfg=TINY, engine_cfg=tiny_engine_cfg(), device="cpu")


def assert_result_line(res, metric):
    assert set(res) == KEYS and res["metric"] == metric
    assert res["detail"]["device"] == "cpu"
    assert "vs_baseline" not in json.dumps(res)


def tar_members(path):
    with tarfile.open(path, "r:gz") as tf:
        return {m.name: (tf.extractfile(m).read() if m.isfile() else None)
                for m in tf.getmembers()}


# ---------------------------------------------------------------------------
# the mirror and the mp3 encoder against the JAX package's


@pytest.mark.parametrize("container,sr", [
    ("wav", 24_000), ("wav", (16_000, 48_000)), ("mp3", 24_000), ("mp3", (16_000, 44_100)),
])
def test_build_mirror_equals_jax(tmp_path, container, sr):
    """The same tar members with the same bytes, the same metadata JSON and
    the same (total_audio, n_chunks)."""
    args = ("en000", 2, 2, 4.5)
    got = B.build_mirror(str(tmp_path / "port"), *args, sr=sr, container=container)
    want = jax_bench.build_mirror(str(tmp_path / "jax"), *args, sr=sr, container=container)
    assert got == want and got[1] > 0
    ext = ".mp3" if container == "mp3" else ".wav"
    for s in range(2):
        base = os.path.join("en000", f"{s:08d}")
        port_tar = tar_members(str(tmp_path / "port" / f"{base}.tar.gz"))
        assert port_tar == tar_members(str(tmp_path / "jax" / f"{base}.tar.gz"))
        assert sorted(k for k, v in port_tar.items() if v is not None) == [
            f"audio/vid-{s:08d}-{a}{ext}" for a in range(2)]
        with open(tmp_path / "port" / f"{base}.json", "rb") as f, \
                open(tmp_path / "jax" / f"{base}.json", "rb") as g:
            assert f.read() == g.read()
    assert sorted(os.listdir(tmp_path / "port")) == ["en000"]  # staging dirs removed


@pytest.mark.parametrize("channels,sr,bitrate", [(1, 24_000, 128), (2, 44_100, 64), (1, 16_000, 32)])
def test_encode_mp3_equals_jax(channels, sr, bitrate):
    rng = np.random.default_rng(channels + sr)
    shape = (sr // 3,) if channels == 1 else (sr // 3, 2)
    pcm = np.clip(rng.standard_normal(shape) * 6000, -32768, 32767).astype(np.int16)
    got = mp3enc.encode_mp3(pcm, sample_rate=sr, bitrate=bitrate)
    assert got == jax_mp3enc.encode_mp3(pcm, sample_rate=sr, bitrate=bitrate)
    assert got[:2] == b"\xff\xfb" or got[:2] == b"\xff\xf3"  # an MPEG frame sync, no tag


def test_encode_mp3_without_the_library_names_it(monkeypatch):
    monkeypatch.setattr(mp3enc, "_lib", None)
    monkeypatch.setattr(mp3enc, "LIBRARY", "libmp3lame-absent.so.0")
    with pytest.raises(OSError, match="libmp3lame-absent.so.0"):
        mp3enc.encode_mp3(np.zeros(2400, dtype=np.int16))


# ---------------------------------------------------------------------------
# the engine bench's workload and its codes against the JAX package's


class RecordingJaxEngine:
    """Stands in for the JAX engine inside ``tokenize_audio_tpu.benchmark``:
    records each ``encode_batch`` call's audio and rate, and returns codes of
    the right frame counts."""

    calls = []

    def __init__(self, params, cfg, engine_cfg, **kw):
        from tokenize_audio_tpu.engine.metrics import EngineStats

        self.cfg, self.engine_cfg, self.stats = cfg, engine_cfg, EngineStats()

    def encode_batch(self, audios, sr=24_000):
        self.calls.append((sr, [a.copy() for a in audios]))
        spf = SPF * sr // 24_000
        return [np.zeros((8, -(-len(a) // spf)), np.int32) for a in audios]


def test_engine_workload_equals_jax_draws(monkeypatch):
    """engine_workload gives the audio the JAX bench encodes, in its order,
    at 24 kHz and at 16 kHz."""
    monkeypatch.setattr(jax_engine_module, "MimiEncoderEngine", RecordingJaxEngine)
    monkeypatch.setattr(RecordingJaxEngine, "calls", [])
    ecfg = JaxEngineConfig(max_chunk_seconds=12.0)
    jax_bench.run_engine_bench(n_utts=7, passes=1, seed=3, mimi_cfg=tiny_jax_config(),
                               engine_cfg=ecfg)
    (sr_w, warm), (sr_m, measured), (sr_16, fused), _ = RecordingJaxEngine.calls
    assert (sr_w, sr_m, sr_16) == (24_000, 24_000, 16_000)
    audios, audios16 = B.engine_workload(7, 3, EngineConfig(max_chunk_seconds=12.0))
    for got, want in ((audios, warm), (audios, measured), (audios16, fused)):
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int16
            np.testing.assert_array_equal(g, w)
    assert max(len(a) for a in audios) <= int(11.95 * 24_000)


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return params, jcfg, config_from_hf(model.config)


def test_workload_codes_equal_jax(oracle):
    """Six utterances of the bench workload through the port's CPU engine
    and the JAX engine (tiny config, the same params, 8 codebooks as the
    bench): equal codes at 24 kHz and through the fused 16 kHz resample,
    of shape (8, ceil(ceil(len * 3 / 2) / 1920)) at 16 kHz."""
    params, jcfg, cfg = oracle
    kw = dict(batch_size=8, min_bucket_seconds=2.0, max_chunk_seconds=4.0, bucket_growth=2.0)
    audios, audios16 = B.engine_workload(6, 0, EngineConfig(**kw))
    jax_eng = JaxEngine(params, jcfg, JaxEngineConfig(**kw))
    port_eng = MimiEncoderEngine(params, cfg, EngineConfig(**kw), device="cpu")
    for rows, sr in ((audios, 24_000), (audios16, 16_000)):
        want = jax_eng.encode_batch(rows, sr=sr)
        got = port_eng.encode_batch(rows, sr=sr)
        for a, g, w in zip(rows, got, want):
            valid = -(-len(a) * 24_000 // sr)
            assert g.shape == w.shape == (8, -(-valid // SPF))
            np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# contracts of the modes (tests/test_benchmark.py's, for the port)


def test_engine_bench_contract():
    emitted, stages = [], []

    def on_headline(r):
        # the headline is emitted BEFORE the fused stage, then enriched in place
        emitted.append(("fused_16khz_x_realtime" in r["detail"], stages[-1], r))

    res = B.run_engine_bench(n_utts=6, passes=2, on_headline=on_headline,
                             progress=stages.append, **ON_CPU)
    assert_result_line(res, "audio_hours_per_hour_per_chip")
    assert res["unit"] == "x_realtime" and res["value"] > 0
    d = res["detail"]
    assert len(d["pass_x_realtime"]) == 2 and res["value"] == pytest.approx(
        max(d["pass_x_realtime"]), abs=0.06)
    assert d["fused_16khz_x_realtime"] > 0
    assert 0 < d["bucket_efficiency"] <= 1
    assert d["code_transfer_format"] == "packed" and d["utterances"] == 6
    json.dumps(res)
    [(fused_at_emit, stage_at_emit, emitted_dict)] = emitted
    assert not fused_at_emit and stage_at_emit == "measured_pass_2"
    assert emitted_dict is res
    assert stages == ["device_claim", "params", "warmup", "measured_pass_1",
                      "measured_pass_2", "fused_16k"]


def test_engine_bench_without_fused_stage():
    res = B.run_engine_bench(n_utts=3, passes=1, fused_16k=False, **ON_CPU)
    assert_result_line(res, "audio_hours_per_hour_per_chip")
    assert "fused_16khz_x_realtime" not in res["detail"]


def test_engine_bench_rejects_zero_passes():
    with pytest.raises(ValueError, match="passes"):
        B.run_engine_bench(passes=0, **ON_CPU)


def test_entry_points_need_a_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.run_engine_bench(n_utts=2, passes=1, mimi_cfg=TINY, engine_cfg=tiny_engine_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        B.main(["--pipeline", "--subshards", "1", "--audios", "1", "--seconds", "3"])


def test_cli_keeps_headline_when_fused_stage_raises(monkeypatch, capsys):
    headline = {"metric": "audio_hours_per_hour_per_chip", "value": 1.0}

    def fake_bench(**kw):
        assert kw["device"] == "cpu"
        kw["on_headline"](headline)
        raise RuntimeError("fused stage failed")

    monkeypatch.setattr(B, "run_engine_bench", fake_bench)
    with pytest.raises(RuntimeError, match="fused stage failed"):
        B.main(["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == headline


@pytest.mark.parametrize("container,source_rate", [
    ("wav", 24_000), ("wav", (16_000, 48_000)), ("mp3", 24_000),
])
def test_pipeline_bench(tmp_path, container, source_rate):
    """The whole YODAS2 path on a tiny mirror (warm pass + measured pass);
    a source-rate mirror resamples every file on the device, an mp3 mirror
    decodes through libmpg123; every sub-shard reaches the measured hub."""
    stages = []
    res = B.run_pipeline_bench(subshards=2, audios=2, seconds=4.5, container=container,
                               source_rate=source_rate, work_root=str(tmp_path),
                               progress=stages.append, **ON_CPU)
    assert_result_line(res, "pipeline_audio_hours_per_hour_per_chip")
    d = res["detail"]
    assert res["value"] > 0 and d["chunks"] > 0 and d["subshards"] == 2
    assert d["container"] == container
    assert d["source_rates"] == ([source_rate] if isinstance(source_rate, int)
                                 else list(source_rate))
    assert d["transient_retries"] == 0 and d["warm_pass_seconds"] > 0
    # stage seconds are rounded to 10 ms: a tiny mirror's stages show by name
    assert "host_decode" in d["engine_stage_seconds"]
    assert ("resample" in d["engine_stage_seconds"]) == (source_rate != 24_000)
    hub = tmp_path / "hub_m" / "data" / "en000"
    assert sorted(p.name for p in hub.glob("*.json")) == ["00000000.json", "00000001.json"]
    # the device is claimed before the engine is built
    assert stages[:4] == ["build_mirror", "device_claim", "params", "warm_pass"]
    assert stages[-1] == "measured_pass"


def test_pipeline_bench_reuses_a_live_engine(tmp_path):
    engine = MimiEncoderEngine(random_params(TINY, seed=0), TINY, tiny_engine_cfg(),
                               num_codebooks=12, device="cpu")
    stages = []
    res = B.run_pipeline_bench(subshards=1, audios=1, seconds=3.5, engine=engine,
                               work_root=str(tmp_path), progress=stages.append)
    assert_result_line(res, "pipeline_audio_hours_per_hour_per_chip")
    assert "params" not in stages and engine.stats.frames > 0


def test_compare_mode_same_chunk_set(tmp_path):
    res = B.run_compare(subshards=2, audios=1, seconds=5.0, passes=2,
                        work_root=str(tmp_path), **ON_CPU)
    assert_result_line(res, "pipeline_vs_engine_ratio")
    assert res["unit"] == "ratio" and 0 < res["value"]
    d = res["detail"]
    assert d["chunks"] > 0
    assert len(d["engine_wall_seconds"]) == len(d["pipeline_wall_seconds"]) == 2
    assert len(d["round_ratios"]) == 2
    for k in ("host_decode", "host_serialize", "host_extract", "hub_upload", "dispatch"):
        assert k in d["pipeline_stage_seconds"], d["pipeline_stage_seconds"]
    assert not list(tmp_path.glob("hub_p*"))  # each round's artifacts removed
    json.dumps(res)


def test_compare_reports_the_fastest_rounds_own_stage_table(tmp_path, monkeypatch):
    """The first of 3 rounds has the fastest pipeline pass: the reported
    stage table is that round's own, with no later round's engine pass
    added into it."""
    real = B._process_shard_once
    tables = {}

    def first_round_fastest(tmp, mirror, engine, tag, subshards):
        _, rep = real(tmp, mirror, engine, tag, subshards)
        tables[tag] = {k: round(v, 3) for k, v in engine.stats.stage_seconds.items()}
        return (1.0 if tag == "p0" else 2.0), rep

    monkeypatch.setattr(B, "_process_shard_once", first_round_fastest)
    res = B.run_compare(subshards=1, audios=1, seconds=4.0, passes=3,
                        work_root=str(tmp_path), **ON_CPU)
    d = res["detail"]
    assert d["pipeline_wall_seconds"] == [1.0, 2.0, 2.0]
    assert d["pipeline_stage_seconds"] == tables["p0"]
    assert d["pipeline_stage_seconds"]["dispatch"] > 0


def test_soak_contract(tmp_path):
    res = B.run_soak(minutes=0.001, subshards=1, audios=1, seconds=4.0,
                     work_root=str(tmp_path), **ON_CPU)
    assert_result_line(res, "pipeline_soak_sustained")
    d = res["detail"]
    assert d["iterations"] >= 1 and d["error_count"] == 0
    assert d["rt_min"] <= res["value"] <= d["rt_max"]
    assert d["transient_retries"] == 0 and d["iteration_errors"] == []
    assert len(d["per_iteration"]) == d["iterations"]
    assert not list(tmp_path.glob("hub_i*")) and not list(tmp_path.glob("work_i*"))
    json.dumps(res)


@pytest.mark.parametrize("leave_dirs", [False, True])
def test_soak_terminates_on_persistent_failure(tmp_path, monkeypatch, leave_dirs):
    """3 consecutive failures with no counted iteration raise instead of
    soaking; a failed iteration's hub/work/progress dirs are removed."""
    calls = []

    def always_broken(tmp, mirror, engine, tag, subshards):
        if tag == "warm":
            return 0.1, {"processed": subshards}
        calls.append(tag)
        if leave_dirs:
            for d in (f"hub_{tag}", f"work_{tag}", f"prog_{tag}"):
                os.makedirs(os.path.join(tmp, d), exist_ok=True)
        raise OSError("disk full")

    monkeypatch.setattr(B, "_process_shard_once", always_broken)
    with pytest.raises(RuntimeError, match="no successful iterations"):
        B.run_soak(minutes=10.0, subshards=1, audios=1, seconds=4.0,
                   work_root=str(tmp_path), **ON_CPU)
    assert calls == ["i1", "i2", "i3"]
    assert not list(tmp_path.glob("hub_i*")) and not list(tmp_path.glob("work_i*"))


def test_soak_caps_error_log_and_backs_off(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(B.time, "sleep", lambda s: sleeps.append(s))
    state = {"n": 0}
    clock = {"t": 0.0}
    real_monotonic = B.time.monotonic
    monkeypatch.setattr(B.time, "monotonic", lambda: real_monotonic() + clock["t"])

    def one_success_then_broken(tmp, mirror, engine, tag, subshards):
        if tag in ("warm", "i1"):
            return 0.1, {"processed": subshards}
        state["n"] += 1
        if state["n"] >= 150:
            clock["t"] += 10_000.0
        raise OSError("broken")

    monkeypatch.setattr(B, "_process_shard_once", one_success_then_broken)
    res = B.run_soak(minutes=10.0, subshards=1, audios=1, seconds=4.0,
                     work_root=str(tmp_path), **ON_CPU)
    d = res["detail"]
    assert d["iterations"] == 1
    assert d["error_count"] == state["n"] >= 150
    assert len(d["iteration_errors"]) == 100
    assert d["last_error"]["iter"] > d["iteration_errors"][-1]["iter"]
    assert len(sleeps) == state["n"] and max(sleeps) == 30.0 and sleeps[-1] == 0.0


def test_build_mirror_rejects_chunkless_seconds_and_unknown_containers(tmp_path):
    with pytest.raises(ValueError, match="seconds"):
        B.build_mirror(str(tmp_path), "en000", 1, 1, seconds=2.0)
    with pytest.raises(ValueError, match="container"):
        B.build_mirror(str(tmp_path), "en000", 1, 1, seconds=3.0, container="ogg")


def test_seconds_and_rates_args():
    assert B._seconds_arg("4.5") == 4.5
    for bad in ("2", "2.0", "-1", "abc"):
        with pytest.raises(argparse.ArgumentTypeError):
            B._seconds_arg(bad)
    assert B._rates_arg("24000") == 24000
    assert B._rates_arg("16000, 48000") == (16000, 48000)
    assert B._rates_arg("16000,") == 16000
    for bad in ("", ",", "abc", "16000,-1", "0"):
        with pytest.raises(argparse.ArgumentTypeError):
            B._rates_arg(bad)


@pytest.mark.parametrize("argv,runner,metric", [
    ([], "run_engine_bench", "audio_hours_per_hour_per_chip"),
    (["--pipeline"], "run_pipeline_bench", "pipeline_audio_hours_per_hour_per_chip"),
    (["--compare"], "run_compare", "pipeline_vs_engine_ratio"),
    (["--soak", "0.001"], "run_soak", "pipeline_soak_sustained"),
])
def test_main_prints_one_json_line(tmp_path, capsys, monkeypatch, argv, runner, metric):
    """``main([... "--device", "cpu"])`` prints exactly one JSON line on
    stdout (heartbeats go to stderr), the tiny config patched in."""
    real = getattr(B, runner)
    extra = {} if runner == "run_engine_bench" else {"work_root": str(tmp_path)}
    monkeypatch.setattr(B, runner, lambda **kw: real(
        **{**kw, "mimi_cfg": TINY, "engine_cfg": tiny_engine_cfg(), **extra}))
    small = ["--subshards", "1", "--audios", "1", "--seconds", "4", "--utterances", "3",
             "--passes", "1"]
    assert B.main(argv + small + ["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    out = captured.out.strip().splitlines()
    assert len(out) == 1
    res = json.loads(out[0])
    assert_result_line(res, metric)
    heartbeats = [json.loads(line)["hb"] for line in captured.err.strip().splitlines()
                  if line.startswith('{"hb"')]
    assert heartbeats[0] in ("device_claim", "build_mirror")
