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


@pytest.mark.parametrize("c,t", [(8, 9000), (16, 5000), (64, 2500)])
def test_resblock_close_to_pallas(c, t):
    """Within 1e-5: the summation-order class ops/pallas/seanet.py:27-29
    documents (the Pallas kernel's shifted dots vs a conv)."""
    rng = np.random.default_rng(c)
    c2 = c // 2
    w3 = (rng.standard_normal((c2, c, 3)) * 0.2).astype(np.float32)
    b3 = (rng.standard_normal(c2) * 0.1).astype(np.float32)
    w1 = (rng.standard_normal((c, c2, 1)) * 0.2).astype(np.float32)
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
