"""PyTorch port on the card: each CUDA kernel against its plain version at
small and ragged shapes, and the tiny-config encode and engine on the card
against the same code on the CPU. Each test asks for the ``cuda`` fixture,
which skips it where no CUDA device is present; run on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and a GPU machine need not have)."""

import dataclasses

import numpy as np
import pytest
import torch

from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, encode, params_to_torch, random_params
from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

TINY = MimiConfig(
    num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
    codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
    upsample_groups=32,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,d,k,v", [(300, 16, 4, 64), (33, 40, 3, 100), (1000, 256, 2, 2048)])
def test_rvq_kernel_equals_plain(cuda, n, d, k, v):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.standard_normal((k, v, d)).astype(np.float32)).to(cuda)
    before = rvq.rvq_quantize.launches
    got = rvq.rvq_quantize(x, e)
    assert rvq.rvq_quantize.launches == before + 1
    want = rvq.rvq_quantize_reference(x, e)
    assert got.dtype == torch.int32 and got.shape == (n, k)
    assert torch.equal(got, want)


def test_rvq_kernel_first_index_ties(cuda):
    rng = np.random.default_rng(123)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    e = rng.standard_normal((16, 8)).astype(np.float32)
    e[7] = e[3]
    e[12] = e[3]
    xs[0] = e[3]
    got = rvq.rvq_quantize(torch.from_numpy(xs).to(cuda), torch.from_numpy(e[None]).to(cuda))
    got = got.cpu().numpy()
    want = rvq.rvq_quantize_reference(torch.from_numpy(xs), torch.from_numpy(e[None])).numpy()
    np.testing.assert_array_equal(got, want)
    assert 3 in got and 7 not in got and 12 not in got


@pytest.mark.parametrize("c,t", [(8, 9000), (16, 5000), (64, 2500), (96, 777), (512, 301)])
def test_resblock_kernel_close_to_plain(cuda, c, t):
    rng = np.random.default_rng(c)
    c2 = c // 2
    arrs = [
        (rng.standard_normal((3, c, t)) * 0.5).astype(np.float32),
        np.array([t, t // 2 + 5, 1], dtype=np.int32),
        (rng.standard_normal((c2, c, 3)) * 0.2).astype(np.float32),
        (rng.standard_normal(c2) * 0.1).astype(np.float32),
        (rng.standard_normal((c, c2, 1)) * 0.2).astype(np.float32),
        (rng.standard_normal(c) * 0.1).astype(np.float32),
    ]
    for i, vl in enumerate(arrs[1]):
        arrs[0][i, :, vl:] = 0.0
    args = [torch.from_numpy(a).to(cuda) for a in arrs]
    before = seanet.resblock_elu.launches
    got = seanet.resblock_elu(*args)
    assert seanet.resblock_elu.launches == before + 1
    want = seanet.resblock_elu_reference(*args)
    tol = 1e-5 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol
    assert bool((got[1, :, int(arrs[1][1]):] == 0).all())


def test_wrappers_check_their_inputs(cuda):
    x = torch.zeros((8, 16), device=cuda)
    e = torch.zeros((2, 8, 16), device=cuda)
    with pytest.raises(TypeError):
        rvq.rvq_quantize(x.double(), e)
    with pytest.raises(ValueError, match="contiguous"):
        rvq.rvq_quantize(torch.zeros((16, 8), device=cuda).T, e)
    with pytest.raises(ValueError):
        rvq.rvq_quantize(x, torch.zeros((2, 8, 15), device=cuda))
    xs = torch.zeros((1, 8, 32), device=cuda)
    w = [torch.zeros(s, device=cuda) for s in ((4, 8, 3), (4,), (8, 4, 1), (8,))]
    with pytest.raises(TypeError):
        seanet.resblock_elu(xs, torch.zeros(1, device=cuda), *w)
    with pytest.raises(ValueError):
        seanet.resblock_elu(xs, torch.zeros(2, dtype=torch.int32, device=cuda), *w)


def test_encode_on_card_equals_cpu(cuda):
    params = random_params(TINY, seed=0)
    rng = np.random.default_rng(4)
    lengths = [3000, 9600, 5555, 6 * 1920]
    batch = np.zeros((4, 6 * 1920), dtype=np.float32)
    for i, n in enumerate(lengths):
        batch[i, :n] = (rng.standard_normal(n) * 0.3).astype(np.float32)
    valid = torch.tensor(lengths, dtype=torch.int32)
    want, _ = encode(params_to_torch(params, "cpu"), TINY, torch.from_numpy(batch), valid,
                     num_quantizers=12)
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    got, _ = encode(params_to_torch(params, cuda), TINY, torch.from_numpy(batch).to(cuda),
                    valid.to(cuda), num_quantizers=12)
    assert rvq.rvq_quantize.launches == r0 + 2  # semantic + acoustic
    assert seanet.resblock_elu.launches == s0 + 4  # one per SEANet stage
    match = float((got.cpu() == want).float().mean())
    assert match >= 0.99, match
    plain = dataclasses.replace(TINY, rvq_backend="torch", seanet_backend="torch")
    got_plain, _ = encode(params_to_torch(params, cuda), plain, torch.from_numpy(batch).to(cuda),
                          valid.to(cuda), num_quantizers=12)
    assert float((got_plain == got).float().mean()) >= 0.99


def test_engine_on_card_equals_cpu(cuda):
    params = random_params(TINY, seed=1)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(5)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16)
              for n in (1000, 5000, 19_200, 26_000, int(24_000 * 5.3))]
    want = MimiEncoderEngine(params, TINY, ecfg, device="cpu").encode_batch(audios)
    got = MimiEncoderEngine(params, TINY, ecfg).encode_batch(audios, defer=True)()
    same = np.concatenate([(g == w).reshape(-1) for g, w in zip(got, want)])
    assert [g.shape for g in got] == [w.shape for w in want]
    assert same.mean() >= 0.99, same.mean()
