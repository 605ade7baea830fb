"""PyTorch port, model: per-layer activations against the JAX package's
functions, and codes bit-equal to JAX ``encode`` and HF ``MimiModel.encode``
on the tiny oracle config, on the CPU (the plain path of every kernel)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tokenize_audio_tpu.core.audio import resample as jax_resample
from tokenize_audio_tpu.mimi.model import encode as jax_encode
from tokenize_audio_tpu.mimi.model import seanet_encode as jax_seanet
from tokenize_audio_tpu.mimi.model import transformer_apply as jax_tfm
from tokenize_audio_tpu_torch.core.audio import resample
from tokenize_audio_tpu_torch.mimi import encode, params_from_torch_model, params_to_torch
from tokenize_audio_tpu_torch.mimi.model import seanet_encode, transformer_apply
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

SPF = 1920
K = 12


@pytest.fixture(scope="module")
def oracle():
    model, jparams, jcfg = make_oracle(tiny_hf_config())
    cfg = config_from_hf(model.config)
    params = params_to_torch(params_from_torch_model(model), "cpu")
    return model, jparams, jcfg, params, cfg


def hf_codes(model, audio):
    with torch.no_grad():
        return model.encode(torch.from_numpy(audio)[None, None, :]).audio_codes[0, :K].numpy()


def ragged_batch(rng, lengths, bucket):
    batch = np.zeros((len(lengths), bucket), dtype=np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = (rng.standard_normal(n) * 0.3).astype(np.float32)
    return batch


@pytest.mark.parametrize("masked", [True, False])
def test_layer_activations_close_to_jax(oracle, masked):
    _, jparams, jcfg, params, cfg = oracle
    rng = np.random.default_rng(1)
    lengths = [4 * SPF, 2 * SPF + 311]
    audio = ragged_batch(rng, lengths, 4 * SPF)
    jv = jnp.asarray(lengths) if masked else None
    tv = torch.tensor(lengths, dtype=torch.int32) if masked else None
    want, want_v = jax_seanet(jparams, jcfg, jnp.asarray(audio)[:, None, :], jv)
    got, got_v = seanet_encode(params, cfg, torch.from_numpy(audio)[:, None, :], tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    if masked:
        assert got_v.tolist() == np.asarray(want_v).tolist()
    h = np.asarray(want).transpose(0, 2, 1)
    want_t = np.asarray(jax_tfm(jparams["tfm"], jcfg, jnp.asarray(h)))
    got_t = transformer_apply(params["tfm"], cfg, torch.from_numpy(np.ascontiguousarray(h)))
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_codes_bit_equal_jax(oracle, masked, backend):
    """Mixed valid lengths in one bucket, both masking modes and both
    backends (the kernel backend's CPU path is the plain version)."""
    _, jparams, jcfg, params, cfg = oracle
    cfg = dataclasses.replace(cfg, rvq_backend=backend, seanet_backend=backend)
    rng = np.random.default_rng(2)
    lengths = [3000, 9600, 5555, 6 * SPF]
    batch = ragged_batch(rng, lengths, 6 * SPF)
    want, want_v = jax_encode(
        jparams, jcfg, jnp.asarray(batch), jnp.asarray(lengths), num_quantizers=K, masked=masked
    )
    got, got_v = encode(
        params, cfg, torch.from_numpy(batch), torch.tensor(lengths, dtype=torch.int32),
        num_quantizers=K, masked=masked,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_v.tolist() == np.asarray(want_v).tolist()


def test_codes_bit_equal_hf_standalone(oracle):
    """Masked mode: each ragged row equals its standalone unpadded HF encode."""
    model, _, _, params, cfg = oracle
    rng = np.random.default_rng(3)
    lengths = [7000, 1920, 11111]
    batch = ragged_batch(rng, lengths, 6 * SPF)
    got, valid = encode(
        params, cfg, torch.from_numpy(batch), torch.tensor(lengths, dtype=torch.int32),
        num_quantizers=K,
    )
    for i, n in enumerate(lengths):
        ref = hf_codes(model, batch[i, :n])
        assert int(valid[i]) == ref.shape[1]
        np.testing.assert_array_equal(got[i, :, : ref.shape[1]].numpy(), ref)


@pytest.mark.parametrize("transfer", ["packed", "padded"])
def test_transfer_formats_equal_jax(oracle, transfer):
    _, jparams, jcfg, params, cfg = oracle
    rng = np.random.default_rng(4)
    lengths = [2500, 6 * SPF, 4000]
    batch = ragged_batch(rng, lengths, 6 * SPF)
    want, _ = jax_encode(
        jparams, jcfg, jnp.asarray(batch), jnp.asarray(lengths), num_quantizers=K,
        transfer=transfer,
    )
    got, _ = encode(
        params, cfg, torch.from_numpy(batch), torch.tensor(lengths, dtype=torch.int32),
        num_quantizers=K, transfer=transfer,
    )
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int16_and_fused_16k_resample_equal_jax(oracle):
    """int16 PCM normalizes on the device; the fused 16 kHz resample gives
    the JAX codes, and the port's resampler agrees with the JAX one."""
    model, jparams, jcfg, params, cfg = oracle
    rng = np.random.default_rng(5)
    lengths = [8000, 12_800, 3333]
    pcm = np.zeros((3, 12_800), dtype=np.int16)
    for i, n in enumerate(lengths):
        pcm[i, :n] = (rng.standard_normal(n) * 8000).astype(np.int16)
    kw = dict(num_quantizers=K, resample=(3, 2))
    want, want_v = jax_encode(jparams, jcfg, jnp.asarray(pcm), jnp.asarray(lengths), **kw)
    got, got_v = encode(
        params, cfg, torch.from_numpy(pcm), torch.tensor(lengths, dtype=torch.int32), **kw
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got_v.tolist() == np.asarray(want_v).tolist()
    a16 = pcm[0, : lengths[0]].astype(np.float32) / 32768.0
    r_jax = np.asarray(jax_resample(a16, 16_000, 24_000))
    r_port = resample(a16, 16_000, 24_000, device="cpu").numpy()
    np.testing.assert_allclose(r_port, r_jax, atol=1e-6)
    # the fused path equals resample-then-encode of the same row (HF)
    f = int(got_v[0])
    np.testing.assert_array_equal(got[0, :, :f].numpy(), hf_codes(model, r_port)[:, :f])


def test_unported_modes_raise(oracle):
    """The bf16 and TF32 modes, refused before they were ported, now encode
    (tests/test_torch_modes.py holds them against JAX); a JAX backend name
    still raises, and every mode leaves the TF32 flags as it found them."""
    _, _, _, params, cfg = oracle
    audio = torch.zeros((1, SPF))
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    for kw in ({"compute_dtype": "bfloat16"}, {"matmul_precision": "high"}):
        codes, _ = encode(params, dataclasses.replace(cfg, **kw), audio)
        assert codes.shape == (1, 8, 1)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
    with pytest.raises(ValueError, match="rvq_backend"):
        encode(params, dataclasses.replace(cfg, rvq_backend="pallas"), audio)
    # the TF32 flags are restored after encode
    before = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    encode(params, cfg, audio)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before


def tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("before", [(True, True), (True, False), (False, True)])
def test_ieee_fp32_is_safe_across_threads(monkeypatch, before):
    """Two threads enter and leave ieee_fp32() in overlapping order (A in,
    B in, A out, B out): both TF32 flags stay False while either is inside,
    and come back to their old values only after the last one leaves."""
    import threading

    from tokenize_audio_tpu_torch.config import ieee_fp32

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", before[0])
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", before[1])
    steps = {name: threading.Event() for name in ("a_in", "b_in", "a_out", "b_out")}
    seen = []

    def thread_a():
        with ieee_fp32():
            seen.append(("a inside", tf32_flags()))
            steps["a_in"].set()
            steps["b_in"].wait(10)
        steps["a_out"].set()

    def thread_b():
        steps["a_in"].wait(10)
        with ieee_fp32():
            seen.append(("b inside", tf32_flags()))
            steps["b_in"].set()
            steps["a_out"].wait(10)
            seen.append(("b inside after a left", tf32_flags()))
        steps["b_out"].set()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    assert [s for s, _ in seen] == ["a inside", "b inside", "b inside after a left"]
    assert all(flags == (False, False) for _, flags in seen), seen
    assert tf32_flags() == before


def test_ieee_fp32_stress_many_threads(monkeypatch):
    """Many threads entering and leaving at random never see a flag on, and
    the flags are restored at the end."""
    import sys
    import threading

    from tokenize_audio_tpu_torch.config import ieee_fp32

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    bad = []

    def work():
        for _ in range(300):
            with ieee_fp32():
                if tf32_flags() != (False, False):
                    bad.append(tf32_flags())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert bad == []
    assert tf32_flags() == (True, True)


@pytest.mark.parametrize("rates", [(16_000, 24_000), (48_000, 24_000)])
def test_resample_conv_runs_in_ieee_fp32(monkeypatch, rates):
    """The polyphase conv of resample / resample_many sees both TF32 flags
    False, whatever the caller left them at (the conv is cuDNN's on a card)."""
    import torch.nn.functional as F

    from tokenize_audio_tpu_torch.core.audio import resample_many

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    real, seen = F.conv1d, []

    def spy(*args, **kwargs):
        seen.append(tf32_flags())
        return real(*args, **kwargs)

    monkeypatch.setattr(F, "conv1d", spy)
    audio = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    resample(audio, *rates, device="cpu")
    resample_many([audio, audio[:777]], *rates, device="cpu")  # two length groups
    assert len(seen) == 3 and all(flags == (False, False) for flags in seen), seen
    assert tf32_flags() == (True, True)
