"""PyTorch port, weights: the same seeded random params as the JAX package,
and HF-oracle params that reproduce the oracle's codes."""

import dataclasses

import numpy as np
import pytest
import torch

from tests.mimi_fixtures import make_oracle, tiny_hf_config, tiny_jax_config
from tokenize_audio_tpu.mimi import weights as jw
from tokenize_audio_tpu_torch.mimi import MimiConfig, encode, weights as tw


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _port_cfg(jcfg):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    kw.pop("rvq_backend"), kw.pop("seanet_backend")
    return MimiConfig(**kw)


@pytest.mark.parametrize("seed", [0, 7])
def test_random_params_equal_jax(seed):
    jcfg = tiny_jax_config()
    want = dict(_leaves(jw.random_params(jcfg, seed=seed)))
    got = dict(_leaves(tw.random_params(_port_cfg(jcfg), seed=seed)))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_hf_conversion_equals_jax():
    model, jparams, jcfg = make_oracle(tiny_hf_config())
    assert _port_cfg(jcfg) == tw.config_from_hf(model.config)
    got = dict(_leaves(tw.params_from_torch_model(model)))
    want = dict(_leaves(jparams))
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_params_to_torch_oracle_codes():
    """params_to_torch(params_from_torch_model(oracle)) encodes to the
    oracle's own codes; conv weights keep the HF (O, I, K) layout."""
    model, _, _ = make_oracle(tiny_hf_config())
    cfg = tw.config_from_hf(model.config)
    params = tw.params_to_torch(tw.params_from_torch_model(model), "cpu")
    assert params["enc_in"]["w"].shape == model.encoder.layers[0].conv.weight.shape
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(3 * 1920 + 77) * 0.3).astype(np.float32)
    padded = np.zeros((1, 4 * 1920), dtype=np.float32)  # a frame-aligned bucket
    padded[0, : audio.size] = audio
    got, _ = encode(
        params, cfg, torch.from_numpy(padded), torch.tensor([audio.size], dtype=torch.int32),
        num_quantizers=12,
    )
    with torch.no_grad():
        ref = model.encode(torch.from_numpy(audio)[None, None]).audio_codes[0, :12].numpy()
    np.testing.assert_array_equal(got[0].numpy(), ref)


def test_params_to_torch_needs_a_device():
    """With no GPU and no device='cpu', placing params raises instead of
    running on the CPU."""
    params = tw.random_params(_port_cfg(tiny_jax_config()), seed=0)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.params_to_torch(params)
    cpu = tw.params_to_torch(params, "cpu")
    assert cpu["blocks"][0]["res"][0]["c1"]["w"].device.type == "cpu"
