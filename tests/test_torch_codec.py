"""PyTorch port, decoder and codec API on the CPU (tiny oracle config):
``conv_transpose1d`` and ``split_rvq_decode`` against the JAX package's
within 1e-5, ``decode`` against JAX and HF ``MimiModel.decode`` within
atol 3e-4 * max|ref|, rtol 1e-3 (tests/test_mimi_decoder.py's tolerance),
MimiCodec's round trips and ``from_hf_dir`` (mirroring
tests/test_codec_api.py), and ``python -m tokenize_audio_tpu_torch``'s
encode / decode / info with ``--device cpu``."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu.codec import MimiCodec as JaxCodec
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.mimi import decoder as jax_decoder
from tokenize_audio_tpu_torch import __main__ as cli_main
from tokenize_audio_tpu_torch.codec import MimiCodec
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.io import read_wav, write_wav
from tokenize_audio_tpu_torch.mimi import decode, params_to_torch
from tokenize_audio_tpu_torch.mimi.decoder import conv_transpose1d, split_rvq_decode
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

SPF = 1920
ENGINE_KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=2.0)


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return model, params, jcfg, config_from_hf(model.config)


@pytest.fixture(scope="module")
def codec(oracle):
    _, params, _, cfg = oracle
    return MimiCodec(params, cfg, EngineConfig(**ENGINE_KW), num_codebooks=8, device="cpu")


def assert_audio_close(got, ref):
    ref = np.asarray(ref).reshape(got.shape)
    scale = np.abs(ref).max() + 1e-9
    np.testing.assert_allclose(got, ref, atol=3e-4 * scale, rtol=1e-3)


def hf_decode(model, codes):
    with torch.no_grad():
        return model.decode(torch.from_numpy(np.asarray(codes))).audio_values.numpy()


@pytest.mark.parametrize("groups,stride,k", [(1, 4, 8), (1, 5, 10), (6, 2, 4), (3, 3, 3)])
def test_conv_transpose1d_equals_jax(groups, stride, k):
    rng = np.random.default_rng(stride * 10 + groups)
    cin, cout, t = 6, 12, 9
    x = rng.standard_normal((2, cin, t)).astype(np.float32)
    wt = rng.standard_normal((cin, cout // groups, k)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    want = np.asarray(jax_decoder.conv_transpose1d(
        jnp.asarray(x), jnp.asarray(wt), stride, groups=groups, bias=jnp.asarray(b)))
    got = conv_transpose1d(torch.from_numpy(x), torch.from_numpy(wt), stride, groups=groups,
                           bias=torch.from_numpy(b))
    assert got.shape == want.shape == (2, cout, t * stride)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("k", [1, 8, 12])
def test_split_rvq_decode_equals_jax(oracle, k):
    _, params, _, _ = oracle
    codes = np.random.default_rng(k).integers(0, 64, size=(2, k, 5))
    want = np.asarray(jax_decoder.split_rvq_decode(params["rvq"], jnp.asarray(codes)))
    got = split_rvq_decode(params_to_torch(params["rvq"], "cpu"), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape", [(2, 8, 6), (1, 12, 4)], ids=["8_books", "all_books"])
def test_decode_matches_jax_and_hf(oracle, shape):
    model, params, jcfg, cfg = oracle
    codes = np.random.default_rng(shape[1]).integers(0, cfg.codebook_size, size=shape)
    got = decode(params_to_torch(params, "cpu"), cfg, torch.from_numpy(codes)).numpy()
    assert got.shape == (shape[0], shape[2] * SPF)
    assert_audio_close(got, jax_decoder.decode(params, jcfg, jnp.asarray(codes)))
    assert_audio_close(got, hf_decode(model, codes))


def test_audio_to_str_to_audio(oracle, codec):
    model, _, _, _ = oracle
    audio = (np.random.default_rng(1).standard_normal(3 * SPF) * 0.3).astype(np.float32)
    s = codec.audio_to_str(audio)
    assert len(s) == 3 * 8
    wav = codec.str_to_audio(s)
    assert wav.shape == (3 * SPF,)
    with torch.no_grad():
        ref_codes = model.encode(torch.from_numpy(audio)[None, None, :]).audio_codes[:, :8]
    assert_audio_close(wav, hf_decode(model, ref_codes))


def test_codec_equals_jax_codec(oracle, codec):
    """Code strings equal the JAX codec's at 24 and 16 kHz; decoded audio
    within tolerance of the JAX codec's; batch decode of (B, K, T)."""
    _, params, jcfg, _ = oracle
    jcodec = JaxCodec(params, jcfg, JaxEngineConfig(**ENGINE_KW), num_codebooks=8)
    rng = np.random.default_rng(2)
    for sr, n in ((24_000, 5000), (16_000, 16_000)):
        audio = (rng.standard_normal(n) * 0.3).astype(np.float32)
        s = codec.audio_to_str(audio, sr=sr)
        assert s == jcodec.audio_to_str(audio, sr=sr)
        assert len(s) == 8 * -(-n * 24_000 // sr // SPF)
        assert_audio_close(codec.str_to_audio(s), jcodec.str_to_audio(s))
    codes = rng.integers(0, 64, size=(2, 8, 3))
    assert codec.decode(codes).shape == (2, 3 * SPF)
    with pytest.raises(ValueError, match="empty code stream"):
        codec.decode(np.zeros((8, 0), dtype=np.int64))


def test_encode_resamples(codec):
    audio16 = (np.random.default_rng(3).standard_normal(16_000) * 0.3).astype(np.float32)
    assert codec.encode(audio16, sr=16_000).shape == (8, -(-24_000 // SPF))
    assert [c.shape for c in codec.encode_batch([audio16[:4000], audio16], sr=16_000)] == [
        (8, 4), (8, 13)]


def test_codec_device_and_mesh(oracle):
    """The codec runs where its engine runs: the card unless asked
    otherwise (and without a card that raises); a mesh is refused."""
    _, params, _, cfg = oracle
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MimiCodec(params, cfg)
    with pytest.raises(NotImplementedError):
        MimiCodec(params, cfg, mesh=object(), device="cpu")


def test_from_hf_dir(tmp_path):
    """A local HF snapshot (config.json + model.safetensors) loads with the
    checkpoint's own (non-default) configuration."""
    from safetensors.torch import save_file

    hf_cfg = tiny_hf_config()
    model, _, _ = make_oracle(hf_cfg)
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              str(tmp_path / "model.safetensors"))
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    codec = MimiCodec.from_hf_dir(str(tmp_path), device="cpu")
    assert codec.cfg.num_filters == 8  # the tiny checkpoint's config, not defaults
    audio = (np.random.default_rng(4).standard_normal(2 * SPF) * 0.3).astype(np.float32)
    with torch.no_grad():
        ref = model.encode(torch.from_numpy(audio)[None, None, :]).audio_codes[0, :8].numpy()
    np.testing.assert_array_equal(codec.encode(audio), ref)
    codec2 = MimiCodec.from_safetensors(str(tmp_path / "model.safetensors"), cfg=codec.cfg,
                                        device="cpu")
    np.testing.assert_array_equal(codec2.encode(audio), ref)


def test_command_line_encode_decode_info(oracle, tmp_path, monkeypatch, capsys):
    """``encode`` writes frames x 8 characters (the JAX codec's string),
    ``decode`` writes frames x 1920 samples, ``info`` prints the JSON probe;
    the tiny config and the oracle's params stand in for the full-width
    random ones."""
    _, params, jcfg, cfg = oracle
    monkeypatch.setattr(cli_main, "MimiConfig", lambda: cfg)
    monkeypatch.setattr(cli_main, "random_params", lambda c: params)
    n = 7000
    audio = (np.random.default_rng(5).standard_normal(n) * 0.3).astype(np.float32)
    wav = tmp_path / "in.wav"
    write_wav(str(wav), audio, 24_000)
    frames = -(-n // SPF)

    assert cli_main.main(["info", str(wav)]) == 0
    probe = json.loads(capsys.readouterr().out.strip())
    assert probe == {"file": str(wav), "sample_rate": 24_000, "samples": n,
                     "seconds": round(n / 24_000, 3), "frames_at_12_5hz": frames}

    codes_txt = tmp_path / "codes.txt"
    assert cli_main.main(["encode", str(wav), "-o", str(codes_txt), "--device", "cpu"]) == 0
    s = codes_txt.read_text().strip()
    assert len(s) == frames * 8
    pcm, _ = read_wav(str(wav))
    jcodec = JaxCodec(params, jcfg, num_codebooks=8)
    assert s == jcodec.audio_to_str(pcm)

    out_wav = tmp_path / "back.wav"
    assert cli_main.main(["decode", str(codes_txt), "-o", str(out_wav), "--device", "cpu"]) == 0
    back, sr = read_wav(str(out_wav))
    assert sr == 24_000 and back.shape == (frames * SPF,)
    want = jcodec.str_to_audio(s)
    peak = max(np.abs(want).max(), 1e-9)
    # the WAV holds 16-bit PCM of the decoded audio (clipped to [-1, 1])
    np.testing.assert_allclose(back, np.clip(want, -1, 1), atol=2 / 32767 + 3e-4 * peak)
