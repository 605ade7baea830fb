"""PyTorch port, qualification scripts, part 3: the parity census and
sweep against the JAX package's scripts (``scripts/``, loaded by path), both
on the tiny HF oracle on the CPU (the JAX scripts' ``mimi_fixtures.make_oracle``
and the port's ``qualify._random_oracle`` patched to the tiny widths in
the test only): census reports equal, flips and margins included, and
sweep summaries equal, plain, ``--int16`` and ``--sensitive``."""

import json
import sys
import types

import pytest

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from tests.torch_scripts import load_jax_script, no_compile_cache, run_jax_main
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu_torch import qualify
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.scripts import parity_census, parity_sweep


def _tiny_oracle(hf_cfg=None, seed=0):
    """make_oracle at the tiny widths, keeping a --sensitive config's
    LayerScale and init range."""
    kw = {}
    if hf_cfg is not None:
        kw = dict(layer_scale_initial_scale=hf_cfg.layer_scale_initial_scale,
                  initializer_range=hf_cfg.initializer_range)
    return make_oracle(tiny_hf_config(**kw), seed=seed)


@pytest.fixture
def tiny_oracles(monkeypatch):
    """The JAX scripts' ``mimi_fixtures.make_oracle`` and the port's
    ``qualify._random_oracle`` at the tiny widths."""
    no_compile_cache(monkeypatch)
    monkeypatch.setitem(sys.modules, "mimi_fixtures", types.SimpleNamespace(
        make_oracle=lambda hf_cfg=None, seed=0: _tiny_oracle(hf_cfg, seed)))
    monkeypatch.setattr(qualify, "_random_oracle",
                        lambda seed, hf_cfg=None: _tiny_oracle(hf_cfg, seed)[0])


CENSUS_ENGINE = dict(min_bucket_seconds=1.0, bucket_growth=1.7, samples_per_batch=96 * 24_000)


@pytest.mark.parametrize("seed", [0, 3])
def test_parity_census_seed_equals_jax(tiny_oracles, seed):
    """``census_seed`` of both packages on the tiny HF oracle: the same
    frames, seconds, flips and margins."""
    jax_mod = load_jax_script("parity_census")
    want = jax_mod.census_seed(seed, 4, 2.0, JaxEngineConfig(**CENSUS_ENGINE))
    got = parity_census.census_seed(seed, 4, 2.0, EngineConfig(**CENSUS_ENGINE), device="cpu")
    assert got == want
    assert got["frames"] > 0 and got["frame_exact"] == 1.0 - got["flipped_frames"] / got["frames"]


def test_parity_census_main(tiny_oracles, capsys):
    summary, reports = parity_census.main(["--seeds", "1,2", "--n", "3", "--max-seconds", "2",
                                           "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(ln) for ln in lines] == reports + [summary]
    census = summary["census"]
    assert census["seeds"] == 2 and census["device"] == "cpu"
    assert census["frames"] == sum(r["frames"] for r in reports)


@pytest.mark.parametrize("flags", [[], ["--int16"], ["--sensitive"]])
def test_parity_sweep_equals_jax(tiny_oracles, monkeypatch, capsys, flags):
    argv = ["--n", "4", "--max-seconds", "2", "--seed", "2"] + flags
    run_jax_main(load_jax_script("parity_sweep"), argv, monkeypatch)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    got = parity_sweep.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert got.pop("device") == "cpu"
    want.pop("device")
    assert got == want and got["frames"] > 0
