"""PyTorch port, kernels: each wrapper's CPU path (its plain version) against
the JAX package's Pallas kernel, run in interpret mode as the JAX tests run
it. The CUDA kernels themselves are held against the same plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tokenize_audio_tpu.ops.pallas.rvq import rvq_quantize_pallas
from tokenize_audio_tpu.ops.pallas.seanet import resblock_elu_pallas
from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet


@pytest.fixture(autouse=True)
def _no_launches():
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    yield
    # CPU tensors take the plain versions: no kernel is ever launched
    assert rvq.rvq_quantize.launches == r0 == 0
    assert seanet.resblock_elu.launches == s0 == 0


@pytest.mark.parametrize("n,d,k,v", [(300, 16, 4, 64), (33, 32, 3, 100)])
def test_rvq_equals_pallas(n, d, k, v):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    embeds = rng.standard_normal((k, v, d)).astype(np.float32)
    want = np.asarray(rvq_quantize_pallas(jnp.asarray(x), jnp.asarray(embeds), interpret=True))
    got = rvq.rvq_quantize(torch.from_numpy(x), torch.from_numpy(embeds))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rvq_first_index_ties():
    """Exact distance ties (duplicated codebook rows) resolve to the first
    index, as in the Pallas kernel (mirrors test_pallas_rvq.py's tie test)."""
    rng = np.random.default_rng(123)
    n, d, v = 64, 8, 16
    xs = rng.standard_normal((n, d)).astype(np.float32)
    e = rng.standard_normal((v, d)).astype(np.float32)
    e[7] = e[3]
    e[12] = e[3]
    xs[0] = e[3]
    want = np.asarray(rvq_quantize_pallas(jnp.asarray(xs), jnp.asarray(e[None]), interpret=True))
    got = rvq.rvq_quantize(torch.from_numpy(xs), torch.from_numpy(e[None])).numpy()
    np.testing.assert_array_equal(got, want)
    assert 3 in got and 7 not in got and 12 not in got


# small widths with many Pallas tiles, then the main path's own widths at a
# ragged T: the plain version is the kernel's oracle on the card, so it is
# held to the Pallas kernel at every stage width
@pytest.mark.parametrize(
    "c,t", [(8, 9000), (16, 5000), (64, 2500), (128, 301), (256, 301), (512, 301)]
)
def test_resblock_close_to_pallas(c, t):
    """Within 1e-5: the summation-order class ops/pallas/seanet.py:27-29
    documents (the Pallas kernel's shifted dots vs a conv)."""
    rng = np.random.default_rng(c)
    c2 = c // 2
    # weights shrink with fan-in past C = 64, as a trained model's do, so the
    # activations stay O(1) at every width
    ws = 0.2 * min(1.0, (64 / c) ** 0.5)
    w3 = (rng.standard_normal((c2, c, 3)) * ws).astype(np.float32)
    b3 = (rng.standard_normal(c2) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((c, c2, 1)) * ws).astype(np.float32)
    b1 = (rng.standard_normal(c) * 0.1).astype(np.float32)
    x = (rng.standard_normal((3, c, t)) * 0.5).astype(np.float32)
    valid = np.array([t, t // 2 + 5, 1], dtype=np.int32)
    for i, vl in enumerate(valid):
        x[i, :, vl:] = 0.0
    want = np.asarray(
        resblock_elu_pallas(*(jnp.asarray(a) for a in (x, valid, w3, b3, w1, b1)), interpret=True)
    )
    got = seanet.resblock_elu(*(torch.from_numpy(a) for a in (x, valid, w3, b3, w1, b1)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert (got.numpy()[1, :, valid[1]:] == 0).all()


def _resblock_from_packed(x, valid, w3p, b3, w1p, b1):
    """The kernel's arithmetic in plain torch, reading the conv weights only
    through their packed layout (w3p[c, k, m], w1p[j, m], zero-padded)."""
    c, c2, t = x.shape[1], b3.shape[0], x.shape[-1]
    elu = torch.nn.functional.elu
    xe = torch.nn.functional.pad(elu(x), (2, 0))  # causal halo, zero before t = 0
    h = sum(torch.einsum("cm,bct->bmt", w3p[:, k], xe[:, :, k:k + t]) for k in range(3))
    h = elu(h[:, :c2] + b3[:, None])
    y = x + torch.einsum("jm,bjt->bmt", w1p, h)[:, :c] + b1[:, None]
    y = torch.where(torch.arange(t)[None, None, :] < valid[:, None, None], y, 0.0)
    return elu(y)


@pytest.mark.parametrize("c", [6, 12, 64, 512])
def test_packed_weights_unpack_to_hf_layout(c):
    """The packed layout unpacks to HF's (C/2, C, 3) and (C, C/2, 1); its
    rows are zero-padded to multiples of 4 floats."""
    rng = np.random.default_rng(c)
    c2 = c // 2
    w3 = torch.from_numpy(rng.standard_normal((c2, c, 3)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((c, c2, 1)).astype(np.float32))
    w3p, w1p = seanet.pack_weights(w3, w1)
    ld3, ld1 = -(-c2 // 4) * 4, -(-c // 4) * 4
    assert tuple(w3p.shape) == (c, 3, ld3) and tuple(w1p.shape) == (c2, ld1)
    assert w3p.is_contiguous() and w1p.is_contiguous()
    assert float(w3p[0, 2, 1]) == float(w3[1, 0, 2])
    assert bool((w3p[:, :, c2:] == 0).all()) and bool((w1p[:, c:] == 0).all())
    # unpacked: HF's (C/2, C, 3) and (C, C/2, 1) again
    assert torch.equal(w3p[:, :, :c2].permute(2, 0, 1), w3)
    assert torch.equal(w1p[:, :c].T[:, :, None], w1)


@pytest.mark.parametrize("c,t", [(12, 301), (64, 700)])
def test_packed_layout_computes_the_block(c, t):
    """The block computed from the packed layout equals the plain version."""
    rng = np.random.default_rng(c + t)
    c2 = c // 2
    x = (rng.standard_normal((3, c, t)) * 0.5).astype(np.float32)
    valid = np.array([t, t // 2 + 5, 1], dtype=np.int32)
    for i, vl in enumerate(valid):
        x[i, :, vl:] = 0.0
    args = [torch.from_numpy(a) for a in (
        x, valid,
        (rng.standard_normal((c2, c, 3)) * 0.2).astype(np.float32),
        (rng.standard_normal(c2) * 0.1).astype(np.float32),
        (rng.standard_normal((c, c2, 1)) * 0.2).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
    )]
    want = seanet.resblock_elu_reference(*args)
    x, v, w3, b3, w1, b1 = args
    w3p, w1p = seanet.pack_weights(w3, w1)
    np.testing.assert_allclose(_resblock_from_packed(x, v, w3p, b3, w1p, b1).numpy(),
                               want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("inference", [False, True])
def test_engine_codes_unchanged_through_packed_layout(monkeypatch, inference):
    """The tiny-config engine gives the JAX engine's codes when every
    resblock is computed from the weights the engine packed at start-up,
    also when the engine is built and run under torch.inference_mode()."""
    import contextlib

    from tests.mimi_fixtures import make_oracle, tiny_hf_config
    from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
    from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

    model, params, jcfg = make_oracle(tiny_hf_config())
    kw = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(5)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (5000, 19_200, 7777)]
    want = JaxEngine(params, jcfg, JaxEngineConfig(**kw), num_codebooks=12).encode_batch(audios)
    calls = []

    def from_packed(x, valid, w3, b3, w1, b1, packed=None):
        calls.append(x.shape)
        return _resblock_from_packed(x, valid, packed[0], b3, packed[1], b1)

    monkeypatch.setattr(seanet, "resblock_elu", from_packed)
    with torch.inference_mode() if inference else contextlib.nullcontext():
        eng = MimiEncoderEngine(params, config_from_hf(model.config), EngineConfig(**kw),
                                num_codebooks=12, device="cpu")
        got = eng.encode_batch(audios)
    assert calls
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k,v,d", [(1, 2048, 256), (3, 100, 40), (2, 7, 16), (0, 8, 16)])
def test_packed_codebooks_unpack_to_embeds(k, v, d):
    """The packed codebooks unpack to the (K, V, D) input, their columns
    past V are zero, and their e2 is the plain expression, bit for bit."""
    rng = np.random.default_rng(v + d)
    e = torch.from_numpy(rng.standard_normal((k, v, d)).astype(np.float32))
    cb, e2 = rvq.pack_codebooks(e)
    vp = -(-v // 4) * 4
    assert tuple(cb.shape) == (k, d, vp) and tuple(e2.shape) == (k, v)
    assert cb.is_contiguous() and e2.is_contiguous()
    assert torch.equal(cb[:, :, :v].transpose(1, 2), e)
    assert bool((cb[:, :, v:] == 0).all())
    assert torch.equal(e2, (e * e).sum(-1))


def _rvq_from_packed(x, embeds, packed):
    """The plain chain reading the codebooks only through their packed
    layout (cb (K, D, VP), e2 (K, V))."""
    cb, e2 = packed
    v = e2.shape[1]
    residual, codes = x, []
    for k in range(cb.shape[0]):
        e = cb[k, :, :v].T.contiguous()  # (V, D), unpacked
        x2 = (residual * residual).sum(-1, keepdim=True)
        idx = torch.argmin(x2 - 2.0 * (residual @ e.T) + e2[k][None, :], dim=-1)
        codes.append(idx.to(torch.int32))
        residual = residual - e[idx]
    return torch.stack(codes, dim=1)


@pytest.mark.parametrize("inference", [False, True])
def test_engine_codes_unchanged_through_packed_codebooks(monkeypatch, inference):
    """The tiny-config engine gives the JAX engine's codes when every RVQ
    search is computed from the codebooks the engine packed at start-up,
    also when the engine is built and run under torch.inference_mode()."""
    import contextlib

    from tests.mimi_fixtures import make_oracle, tiny_hf_config
    from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
    from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

    model, params, jcfg = make_oracle(tiny_hf_config())
    kw = dict(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(7)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (4000, 19_200, 9999)]
    want = JaxEngine(params, jcfg, JaxEngineConfig(**kw), num_codebooks=12).encode_batch(audios)
    calls = []

    def from_packed(x, embeds, packed=None):
        calls.append((tuple(x.shape), tuple(packed[0].shape)))
        assert packed[0].shape[0] == embeds.shape[0]
        return _rvq_from_packed(x, embeds, packed)

    monkeypatch.setattr(rvq, "rvq_quantize", from_packed)
    with torch.inference_mode() if inference else contextlib.nullcontext():
        eng = MimiEncoderEngine(params, config_from_hf(model.config), EngineConfig(**kw),
                                num_codebooks=12, device="cpu")
        got = eng.encode_batch(audios)
    # a semantic and an acoustic search per batch, each with its own books
    assert calls and {c[1][0] for c in calls} == {1, 11}
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_wrappers_refuse_non_cpu_tensors_without_cuda():
    """A tensor off the CPU never takes the plain version: it launches the
    kernel on CUDA or raises (here: the meta device)."""
    x = torch.empty((4, 16), device="meta")
    e = torch.empty((2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        rvq.rvq_quantize(x, e)
    xs = torch.empty((1, 8, 32), device="meta")
    args = (
        torch.empty(1, dtype=torch.int32, device="meta"),
        torch.empty((4, 8, 3), device="meta"),
        torch.empty(4, device="meta"),
        torch.empty((8, 4, 1), device="meta"),
        torch.empty(8, device="meta"),
    )
    with pytest.raises(ValueError, match="CUDA"):
        seanet.resblock_elu(xs, *args)
