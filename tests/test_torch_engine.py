"""PyTorch port, engine: MimiEncoderEngine(device="cpu") codes bit-equal to
the JAX package's engine on the same utterance lists."""

import numpy as np
import pytest
import torch

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf
from tokenize_audio_tpu_torch.parallel.mesh import make_mesh

SPF = 1920


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return model, params, jcfg, config_from_hf(model.config)


def utterances(rng):
    """Mixed lengths, one raw-int16 row, and one row over the 2 s cap."""
    lengths = [1000, 5000, 19_200, 26_000, 7777, 1920, int(24_000 * 5.3)]
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in lengths]
    audios[2] = (audios[2] * 32767).astype(np.int16)
    return audios


def assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["padded", "packed", "compact"])
def test_engine_equals_jax(oracle, fmt):
    """defer=True + finish(), >cap split, int16 rows, every transfer format."""
    _, params, jcfg, cfg = oracle
    kw = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0,
              code_transfer_format=fmt)
    audios = utterances(np.random.default_rng(0))
    want = JaxEngine(params, jcfg, JaxEngineConfig(**kw), num_codebooks=12).encode_batch(audios)
    eng = MimiEncoderEngine(params, cfg, EngineConfig(**kw), num_codebooks=12,
                            pipeline_depth=2, device="cpu")
    finish = eng.encode_batch(audios, defer=True)
    assert callable(finish)
    assert_same(finish(), want)
    stats = eng.stats.as_dict()
    assert stats["utterances"] == len(audios)
    assert stats["frames"] == sum(-(-len(a) // SPF) for a in audios)


def test_engine_mixed_rates_equal_jax(oracle):
    """encode_batch_mixed: 24 kHz, fused 16 kHz and 48 kHz resample."""
    _, params, jcfg, cfg = oracle
    kw = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0)
    rng = np.random.default_rng(1)
    items = [
        ((rng.standard_normal(7000) * 0.3).astype(np.float32), 24_000),
        ((rng.standard_normal(12_000) * 8000).astype(np.int16), 16_000),
        ((rng.standard_normal(30_000) * 0.3).astype(np.float32), 48_000),
        ((rng.standard_normal(4801) * 8000).astype(np.int16), 16_000),
    ]
    want = JaxEngine(params, jcfg, JaxEngineConfig(**kw)).encode_batch_mixed(items)
    got = MimiEncoderEngine(params, cfg, EngineConfig(**kw), device="cpu").encode_batch_mixed(items)
    assert_same(got, want)


def test_engine_matches_hf_standalone(oracle):
    """Each utterance's codes equal its standalone HF encode, whatever its
    batch and bucket."""
    model, params, _, cfg = oracle
    eng = MimiEncoderEngine(
        params, cfg, EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0),
        device="cpu",
    )
    rng = np.random.default_rng(2)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (1000, 26_000, 7777)]
    for a, g in zip(audios, eng.encode_batch(audios)):
        with torch.no_grad():
            ref = model.encode(torch.from_numpy(a)[None, None]).audio_codes[0, :8].numpy()
        np.testing.assert_array_equal(g, ref)
    assert eng.encode_chunk(audios[0]).shape == (8, 1)


def test_engine_needs_a_device(oracle):
    """Without device='cpu' and with no GPU the constructor raises: the
    engine never quietly runs on the CPU."""
    _, params, _, cfg = oracle
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MimiEncoderEngine(params, cfg)


@pytest.mark.parametrize(
    "kw",
    [
        {"engine_cfg": EngineConfig(drain_policy="ready")},
        {"engine_cfg": EngineConfig(drain_policy="threaded")},
        {"mesh": object()},
    ],
)
def test_engine_unported_options_raise(oracle, kw):
    """Options refused before they were ported now run: the "ready" and
    "threaded" drains give FIFO's codes, and so does a 1 x 1 mesh, where an
    object that is not a mesh raises TypeError."""
    _, params, _, cfg = oracle
    if "mesh" in kw:
        with pytest.raises(TypeError, match="Mesh"):
            MimiEncoderEngine(params, cfg, device="cpu", **kw)
        kw = {"mesh": make_mesh(device="cpu")}
    audios = utterances(np.random.default_rng(4))[:4]
    want = MimiEncoderEngine(params, cfg, device="cpu").encode_batch(audios)
    assert_same(MimiEncoderEngine(params, cfg, device="cpu", pipeline_depth=2, **kw)
                .encode_batch(audios), want)


def test_engine_rejects_bad_options(oracle):
    _, params, _, cfg = oracle
    with pytest.raises(ValueError, match="drain_policy"):
        MimiEncoderEngine(params, cfg, EngineConfig(drain_policy="lifo"), device="cpu")
    with pytest.raises(ValueError, match="even"):
        MimiEncoderEngine(params, cfg, EngineConfig(code_transfer_format="compact"),
                          num_codebooks=7, device="cpu")
    eng = MimiEncoderEngine(params, cfg, num_codebooks=7, device="cpu")
    assert eng.engine_cfg.code_transfer_format == "padded"  # odd K falls back
    # the one legal format: picked without a probe
    assert eng.autotune_transfer() == "padded" and eng.last_autotune == {"padded": 0.0}
