"""PyTorch port, streaming: the port's StreamingMimiEncoder on the CPU against
the port's one-shot encode and the JAX package's StreamingMimiEncoder on the
same seeded audio (tiny oracle config): codes equal, every case mirrored
from tests/test_streaming.py, windowed ones included; the carried state
after two steps close to JAX's; the engine's ``long_audio_policy="stream"``
and the YODAS2 CLI's ``--long-audio-policy stream`` equal to the JAX
package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.datasets import yodas2 as jax_yodas2
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu.hub import LocalHub as JaxLocalHub
from tokenize_audio_tpu.mimi import streaming as jax_streaming
from tokenize_audio_tpu_torch import cli
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.datasets import yodas2
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import encode, params_to_torch
from tokenize_audio_tpu_torch.mimi import streaming
from tokenize_audio_tpu_torch.mimi.streaming import StreamingMimiEncoder
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf
from torch_yodas2_mirror import Entry, noise_pcm, write_mirror

SPF = 1920
SR = 24_000
WINDOWED = dict(layer_scale_initial_scale=1.0, initializer_range=0.1, sliding_window=4)


def build(hf_cfg, windowed=False):
    model, params, jcfg = make_oracle(hf_cfg)
    cfg = config_from_hf(model.config)
    if windowed:
        cfg = dataclasses.replace(cfg, use_sliding_window=True)
        jcfg = dataclasses.replace(jcfg, use_sliding_window=True)
    return params, jcfg, cfg


@pytest.fixture(scope="module")
def oracle():
    return build(tiny_hf_config())


@pytest.fixture(scope="module")
def windowed():
    """A window of 4 positions in a mask-sensitive regime (LayerScale 1)."""
    return build(tiny_hf_config(**WINDOWED), windowed=True)


def noise(rng, n):
    return (rng.standard_normal(n) * 0.3).astype(np.float32)


def one_shot(params, cfg, audio):
    """The port's one-shot encode of (T,) audio -> (K, frames)."""
    n = len(audio)
    a = np.pad(audio, (0, -(-n // SPF) * SPF - n))[None]
    codes, valid = encode(params_to_torch(params, "cpu"), cfg, torch.from_numpy(a),
                          torch.tensor([n], dtype=torch.int32))
    return codes.numpy()[0, :, : int(valid[0])]


def encoders(params, jcfg, cfg, chunk_frames, **kw):
    """The port's and the JAX package's encoders at the same settings."""
    kw["chunk_seconds"] = chunk_frames * SPF / SR
    return (StreamingMimiEncoder(params, cfg, device="cpu", **kw),
            jax_streaming.StreamingMimiEncoder(params, jcfg, **kw))


def assert_codes(got, *wants):
    for want in wants:
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,chunk_frames", [(12 * SPF, 4), (7 * SPF + 1000, 3)],
                         ids=["aligned", "ragged_tail"])
def test_stream_equals_one_shot_and_jax(oracle, n, chunk_frames):
    """A ragged final chunk (odd 25 Hz length) exercises the masked
    replicate-pad path of the downsample."""
    params, jcfg, cfg = oracle
    audio = noise(np.random.default_rng(n), n)
    enc, jenc = encoders(params, jcfg, cfg, chunk_frames)
    got = enc.encode_stream(audio)
    assert_codes(got, one_shot(params, cfg, audio), jenc.encode_stream(audio))


def test_stream_incremental_push(oracle):
    params, jcfg, cfg = oracle
    audio = noise(np.random.default_rng(3), 6 * SPF)
    enc, jenc = encoders(params, jcfg, cfg, 2)
    cs = enc.chunk_samples
    parts = [enc.push(audio[i : i + cs]) for i in range(0, len(audio), cs)]
    jparts = [jenc.push(audio[i : i + cs]) for i in range(0, len(audio), cs)]
    got = np.concatenate([p[0] for p in parts], axis=1)
    assert_codes(got, one_shot(params, cfg, audio), np.concatenate([p[0] for p in jparts], 1))
    # reset gives a fresh stream (same first-chunk codes)
    enc.reset()
    assert_codes(enc.push(audio[:cs])[0], parts[0][0])


def test_encode_streams_multiplexed(oracle):
    """Batched multiplexing of variable-length streams == serial
    encode_stream of each == JAX's multiplexed codes — including rows that
    end mid-batch (per-row valid), a zero-length row, and ragged tails."""
    params, jcfg, cfg = oracle
    rng = np.random.default_rng(4)
    audios = [noise(rng, n) for n in (12 * SPF, 3 * SPF + 700, 5 * SPF, 0)]
    enc, jenc = encoders(params, jcfg, cfg, 2, batch=4)
    serial = StreamingMimiEncoder(params, cfg, batch=1, chunk_seconds=enc.chunk_samples / SR,
                                  device="cpu")
    for a, g, w in zip(audios, enc.encode_streams(audios), jenc.encode_streams(audios)):
        assert_codes(g, serial.encode_stream(a), w)


def test_encode_streams_horizon_cut(oracle):
    """Streams beyond the KV horizon reset at the same whole-chunk boundary
    the serial piece loop cuts at: batched == piece-wise serial == JAX."""
    params, jcfg, cfg = oracle
    max_s = 5 * SPF / SR  # horizon floors to 2 chunks (4 frames)
    enc, jenc = encoders(params, jcfg, cfg, 2, batch=2, max_seconds=max_s)
    serial = StreamingMimiEncoder(params, cfg, chunk_seconds=enc.chunk_samples / SR,
                                  max_seconds=max_s, device="cpu")
    rng = np.random.default_rng(5)
    audios = [noise(rng, n) for n in (11 * SPF + 300, 6 * SPF)]
    horizon = (enc.max_frames_25 * SPF // 2) // enc.chunk_samples * enc.chunk_samples
    for a, g, w in zip(audios, enc.encode_streams(audios), jenc.encode_streams(audios)):
        pieces = [serial.encode_stream(a[s : s + horizon]) for s in range(0, len(a), horizon)]
        assert_codes(g, np.concatenate(pieces, axis=1), w)


def test_kv_capacity_guard(oracle):
    params, _, cfg = oracle
    enc = StreamingMimiEncoder(params, cfg, chunk_seconds=2 * SPF / SR,
                               max_seconds=3 * SPF / SR, device="cpu")
    enc.push(np.zeros(enc.chunk_samples, dtype=np.float32))
    with pytest.raises(ValueError, match="KV-cache capacity"):
        enc.push(np.zeros(enc.chunk_samples, dtype=np.float32))


def test_push_refuses_rows_that_end_apart_and_a_push_after_the_end(oracle):
    params, _, cfg = oracle
    enc = StreamingMimiEncoder(params, cfg, batch=2, chunk_seconds=2 * SPF / SR, device="cpu")
    chunk = np.zeros((2, enc.chunk_samples), dtype=np.float32)
    with pytest.raises(ValueError, match="differ"):
        enc.push(chunk, np.array([enc.chunk_samples, 100]))
    enc.push(chunk, np.array([100, 100]))
    with pytest.raises(ValueError, match="reset"):
        enc.push(chunk)
    with pytest.raises(ValueError, match="whole frames"):
        enc.push(chunk[:, :1000])


def test_windowed_stream_equals_windowed_batch(windowed):
    """use_sliding_window=True: the bounded KV cache == windowed batch
    encode == JAX at T >> window, with O(window) cache memory and no
    capacity ceiling."""
    params, jcfg, cfg = windowed
    # 24 frames @12.5Hz = 48 positions @25Hz >> window 4
    audio = noise(np.random.default_rng(6), 24 * SPF)
    ref = one_shot(params, cfg, audio)
    full = one_shot(params, dataclasses.replace(cfg, use_sliding_window=False), audio)
    assert (ref != full).any(), "window too weak to discriminate"
    enc, jenc = encoders(params, jcfg, cfg, 3, max_seconds=6 * SPF / SR)  # << stream length
    assert enc.state.kv.shape[-2] == 4  # bounded by the window, not the stream
    assert_codes(enc.encode_stream(audio), ref, jenc.encode_stream(audio))


def test_windowed_encode_streams_never_resets(windowed):
    """Multiplexed windowed streams past the nominal max_seconds horizon:
    no reset — every row equals its windowed one-shot encode and JAX."""
    params, jcfg, cfg = windowed
    enc, jenc = encoders(params, jcfg, cfg, 3, batch=2, max_seconds=6 * SPF / SR)
    rng = np.random.default_rng(7)
    audios = [noise(rng, n) for n in (24 * SPF, 9 * SPF + 500)]
    for a, g, w in zip(audios, enc.encode_streams(audios), jenc.encode_streams(audios)):
        assert_codes(g, one_shot(params, cfg, a), w)


def test_windowed_stream_ragged_tail():
    params, jcfg, cfg = build(tiny_hf_config(sliding_window=4), windowed=True)
    audio = noise(np.random.default_rng(8), 7 * SPF + 777)
    enc, jenc = encoders(params, jcfg, cfg, 2)
    assert_codes(enc.encode_stream(audio), one_shot(params, cfg, audio), jenc.encode_stream(audio))


@pytest.mark.parametrize("which", ["full", "windowed"])
def test_state_after_two_steps_close_to_jax(oracle, windowed, which):
    """Conv caches and KV after two stream_steps (the second one a partial
    chunk) within 1e-5 * max|JAX|, and the codes equal."""
    params, jcfg, cfg = oracle if which == "full" else windowed
    rng = np.random.default_rng(9)
    cs, b = 2 * SPF, 2
    chunks = [noise(rng, b * cs).reshape(b, cs) for _ in range(2)]
    valids = [np.full(b, cs, dtype=np.int32), np.array([cs, 700], dtype=np.int32)]
    chunks[1][1, 700:] = 0.0
    jstate = jax_streaming.init_state(jcfg, b, max_frames_25hz=16)
    state = streaming.init_state(cfg, b, max_frames_25hz=16, device="cpu")
    tparams = params_to_torch(params, "cpu")
    for a, v in zip(chunks, valids):
        jcodes, jv12, jstate = jax_streaming.stream_step(
            params, jcfg, jstate, jnp.asarray(a), jnp.asarray(v), num_quantizers=8)
        codes, v12 = streaming.stream_step(
            tparams, cfg, state, torch.from_numpy(a), torch.from_numpy(v), num_quantizers=8)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(v12.numpy(), np.asarray(jv12))
    assert state.t_off == int(jstate.t_off) and state.is_first == bool(jstate.is_first)
    pairs = list(zip(state.conv_caches, jstate.conv_caches)) + [(state.kv, jstate.kv)]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        if want.size == 0:  # the k=1 convs keep no context
            continue
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(float(np.abs(want).max()), 1e-30))


# --- the engine's stream policy, against the JAX engine -------------------

STREAM_KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=4 * SPF / SR,
                 long_audio_policy="stream")


def engines(oracle, **kw):
    params, jcfg, cfg = oracle
    kw = {**STREAM_KW, **kw}
    return (MimiEncoderEngine(params, cfg, EngineConfig(**kw), device="cpu"),
            JaxEngine(params, jcfg, JaxEngineConfig(**kw)))


def test_engine_int16_stream_policy_equals_jax(oracle):
    """int16 input through the stream policy normalizes before the
    streaming encoder: codes equal the JAX engine's and the port's one-shot
    encode of the float audio."""
    params, _, cfg = oracle
    eng, jeng = engines(oracle, max_chunk_seconds=2.0)
    pcm = (np.random.default_rng(10).standard_normal(int(SR * 3.1)) * 8000).astype(np.int16)
    got = eng.encode_chunk(pcm)
    assert_codes(got, jeng.encode_chunk(pcm), one_shot(params, cfg, pcm / np.float32(32768)))
    assert eng.stats.stage_seconds["stream"] > 0


def test_engine_stream_policy_is_exact(oracle):
    """>cap utterances get the one-shot codes, where "split" differs across
    the cut; short utterances in the same call still take the bucketed
    path; the JAX engine gives the same codes."""
    params, _, cfg = oracle
    rng = np.random.default_rng(11)
    audio, short = noise(rng, 9 * SPF), noise(rng, 2 * SPF)
    eng, jeng = engines(oracle)
    got = eng.encode_batch([short, audio])
    want = jeng.encode_batch([short, audio])
    assert_codes(got[1], one_shot(params, cfg, audio), want[1])
    assert_codes(got[0], one_shot(params, cfg, short), want[0])
    split = MimiEncoderEngine(params, cfg, EngineConfig(**{**STREAM_KW, "long_audio_policy": "split"}),
                              device="cpu").encode_chunk(audio)
    assert (split != got[1]).any()  # the cut is real
    stats = eng.stats.as_dict()
    assert stats["frames"] == 2 + 9  # streamed frames counted on both sides
    assert stats["bucket_efficiency"] <= 1


@pytest.mark.parametrize("sr", [24_000, 16_000])
def test_engine_stream_multiplexes_equal_jax(oracle, sr):
    """Several >cap utterances in one deferred call share one batch-4
    streaming encoder (per-row ends), each equal to its one-shot encode and
    to the JAX engine; at 16 kHz (the fused-resample lattice) the long rows
    are resampled first, and a uint16 transfer dtype is kept."""
    params, _, cfg = oracle
    rng = np.random.default_rng(12)
    n = [9 * SPF, 2 * SPF, 6 * SPF + 500, 13 * SPF]
    audios = [noise(rng, k * sr // SR) for k in n]
    eng, jeng = engines(oracle, code_transfer_dtype="uint16")
    got = eng.encode_batch(audios, sr=sr, defer=True)()
    assert set(eng._stream_encoders) == {4}  # one batch-4 encoder, not 3 serial
    for g, w in zip(got, jeng.encode_batch(audios, sr=sr)):
        assert g.dtype == np.uint16
        assert_codes(g, w)
    if sr == SR:
        for a, g in zip(audios, got):
            assert_codes(g, one_shot(params, cfg, a).astype(np.uint16))


def test_stream_encoder_shares_the_engines_device_params(oracle):
    eng, _ = engines(oracle, stream_batch=3)
    enc = eng._stream_encoder_for(3)
    assert enc.batch == 3  # the cap bounds, it does not round up
    assert eng._stream_encoder_for(2).batch == 2
    for head in ("semantic", "acoustic"):
        assert enc.params["rvq"][head]["embed"] is eng.params["rvq"][head]["embed"]
        assert enc.params["rvq"][head]["packed"][0] is eng.params["rvq"][head]["packed"][0]
    assert enc.params["tfm"][0]["q"] is eng.params["tfm"][0]["q"]


# --- the YODAS2 CLI with --long-audio-policy stream -----------------------

SHARD = "en000"


def test_yodas2_cli_stream_policy_equals_jax(oracle, tmp_path, monkeypatch, capsys):
    """``datasets.yodas2.main`` with ``--long-audio-policy stream`` on the
    CPU: the hub JSON equals the JAX processor's under the same policy, and
    the chunk over the 2 s cap differs from the split policy's codes."""
    params, jcfg, cfg = oracle
    rng = np.random.default_rng(13)
    chunks = [(0, 100), (100, 100), (50, 300)]
    root = write_mirror(str(tmp_path / "mirror"), SHARD, [[
        Entry("vid-0", noise_pcm(rng, 3 * SR), SR, "wav", chunks),
        Entry("vid-1", noise_pcm(rng, int(3.5 * 16_000)), 16_000, "wav", chunks),
    ]])
    kw = dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)

    def jax_hub(policy):
        hub = tmp_path / f"jax_{policy}"
        engine = JaxEngine(params, jcfg, JaxEngineConfig(**kw, long_audio_policy=policy),
                           num_codebooks=12)
        jax_yodas2.Yodas2ShardProcessor(
            SHARD, jax_yodas2.LocalSource(root), JaxLocalHub(str(hub)), engine,
            str(hub / "work"), str(hub / "prog"), max_consecutive_missing=2,
        ).process()
        return json.loads((hub / "data" / SHARD / "00000000.json").read_text())

    monkeypatch.setattr(cli, "MimiConfig", lambda **k: dataclasses.replace(cfg, **k))
    monkeypatch.setattr(cli, "random_params", lambda c: params)
    monkeypatch.setattr(yodas2, "MimiConfig", lambda: cfg)
    report = yodas2.main([
        "--shard-id", SHARD, "--source", f"dir:{root}", "--hub", f"dir:{tmp_path / 'hub'}",
        "--progress-dir", str(tmp_path / "prog"), "--work-dir", str(tmp_path / "work"),
        "--device", "cpu", "--batch-size", "4", "--max-chunk-seconds", "2",
        "--long-audio-policy", "stream",
    ])
    assert report["processed"] == 1 and report["uploaded"] == 1 and report["failed"] == 0
    got = json.loads((tmp_path / "hub" / "data" / SHARD / "00000000.json").read_text())
    assert got == jax_hub("stream")
    split = jax_hub("split")
    long_id = [c for c in got[0]["codes"] if c.endswith("00000050-00000300")]
    assert len(long_id) == 1
    assert got[0]["codes"][long_id[0]] != split[0]["codes"][long_id[0]]
