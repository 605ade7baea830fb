"""PyTorch port, qualification scripts, part 5: the warmup-tails receipt and
the conv-layout probe against the JAX package's scripts (``scripts/``,
loaded by path) on the tiny oracle config on the CPU.

- The receipt on a cut lattice (2.5 s cap, 4 x 24 000 samples a batch, at
  most 4 rows), with tails, without, and at growth 1.25: the programs
  (batch shapes warmed) per lattice equal, the ``RESULT`` and per-lattice
  keys equal, and the first line the JAX keys plus the two kernel-build
  flags.
- The conv-layout probe at 2 x 1 s: the printed lines with the port's
  names (JAX ``seanet NCH``/``NHC`` are ``seanet NCL torch``/``NLC``, and
  the port adds ``seanet NCL kernel``).
- ``seanet_nlc`` (channels-last conv2d) within 1e-5 abs of JAX's
  ``seanet_nhc`` and of JAX's ``seanet_encode`` on the same params: the
  SEANet's outputs reach ~6.2 here, and the two sum each conv in another
  order (measured 4-6e-6).
"""

import contextlib
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tokenize_audio_tpu.config as jax_config
import tokenize_audio_tpu.mimi as jax_mimi
from tests.torch_scripts import (
    load_jax_script,
    no_compile_cache,
    run_jax_main,
    tiny_jax,
    tiny_port_config,
)
from tokenize_audio_tpu.mimi.model import seanet_encode as jax_seanet_encode
from tokenize_audio_tpu.mimi.weights import random_params as jax_random_params
from tokenize_audio_tpu_torch.mimi import params_to_torch
from tokenize_audio_tpu_torch.scripts import conv_layout_probe, warmup_tails_receipt

NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
CUT = {"max_chunk_seconds": 2.5, "samples_per_batch": 4 * 24_000, "max_batch_size": 4}
RECEIPTS = [[], ["--no-tails"], ["--growth", "1.25"]]
ATOL = 1e-5


def cut_engine_config(real):
    return lambda **kw: real(**{**kw, **CUT})


def json_lines(out: str) -> list:
    return [json.loads(ln.removeprefix("RESULT ")) for ln in out.splitlines()]


@pytest.fixture(scope="module")
def jax_receipts():
    """The JAX receipt's JSON lines for each argv of RECEIPTS."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        no_compile_cache(mp)
        mp.setattr(jax_mimi, "MimiConfig", tiny_jax)
        mp.setattr(jax_config, "EngineConfig", cut_engine_config(jax_config.EngineConfig))
        for argv in RECEIPTS:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run_jax_main(load_jax_script("warmup_tails_receipt"), argv, mp)
            runs[" ".join(argv)] = json_lines(out.getvalue())
    return runs


@pytest.mark.parametrize("argv", RECEIPTS, ids=lambda a: " ".join(a) or "tails")
def test_warmup_tails_receipt_matches_jax(jax_receipts, monkeypatch, capsys, argv):
    want = jax_receipts[" ".join(argv)]
    monkeypatch.setattr(warmup_tails_receipt, "MimiConfig", tiny_port_config)
    monkeypatch.setattr(warmup_tails_receipt, "EngineConfig",
                        cut_engine_config(warmup_tails_receipt.EngineConfig))
    got = warmup_tails_receipt.main(argv + ["--device", "cpu"])
    lines = json_lines(capsys.readouterr().out)
    assert len(lines) == len(want) == 5
    header, rows, result = lines[0], lines[1:4], lines[4]
    assert set(header) == set(want[0]) | {"kernels_built_before", "kernels_loaded_before"}
    assert header["growth"] == want[0]["growth"] and header["device"] == got["device"] == "cpu"
    assert header["kernels_loaded_before"] is False  # nothing is built on the CPU
    assert [r["sr"] for r in rows] == [r["sr"] for r in want[1:4]] == [24_000, 16_000, 48_000]
    assert [r["programs"] for r in rows] == [r["programs"] for r in want[1:4]]
    assert all(r["programs"] > 0 and set(r) == set(w) for r, w in zip(rows, want[1:4]))
    assert set(result) == set(want[4]) and result == got["result"]
    assert result["include_tails"] == want[4]["include_tails"] == ("--no-tails" not in argv)
    assert result["total_programs"] == want[4]["total_programs"]
    assert result["per_lattice"] == rows


# the port's line names for the JAX ones (its one new line: the kernel SEANet)
RENAMED = {"full encode": "full encode", "seanet NCH ": "seanet NCL torch ",
           "seanet NHC ": "seanet NLC       ", "transformer": "transformer",
           "rvq (8 bks)": "rvq (8 bks)",
           "NHC == NCH (f32 bitwise)": "NLC == NCL torch (f32 bitwise)"}


def test_conv_layout_probe_matches_jax(monkeypatch, capsys):
    no_compile_cache(monkeypatch)
    monkeypatch.setattr(jax_mimi, "MimiConfig", tiny_jax)
    argv = ["--batch", "2", "--seconds", "1"]
    run_jax_main(load_jax_script("conv_layout_probe"), argv, monkeypatch)
    want = [ln.split(":")[0] for ln in capsys.readouterr().out.splitlines()[1:]]
    monkeypatch.setattr(conv_layout_probe, "MimiConfig", tiny_port_config)
    got = conv_layout_probe.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu"
    names = [ln.split(":")[0] for ln in out[1:]]
    expected = [RENAMED[n] for n in want]
    expected.insert(1, "seanet NCL kernel")
    assert names == expected
    assert NUMBER.sub("#", out[-1]).endswith(f"(f# bitwise): {got['nlc_vs_ncl_torch_bitwise']}"
                                             f"  maxdiff: #")
    assert list(got["ms"]) == [n.strip() for n in names[:-1]]
    assert all(t > 0 for t in got["ms"].values())
    assert got["nlc_vs_ncl_torch_maxdiff"] <= ATOL
    assert got["nlc_vs_ncl_torch_maxdiff_full"] <= ATOL * max(1.0, got["ncl_torch_max_abs_full"])


@pytest.mark.parametrize("kw", [{}, {"num_residual_layers": 2}, {"pad_mode": "replicate"}],
                         ids=["tiny", "dilated", "replicate"])
def test_seanet_nlc_matches_jax(kw):
    """The channels-last SEANet on JAX's params: against JAX's NCH
    ``seanet_encode`` (every config: dilation 2 in the second residual
    layer, the replicate pad) and JAX's ``seanet_nhc`` (which pads with
    zeros whatever ``pad_mode`` says, so not under "replicate")."""
    jcfg = tiny_jax(**kw)
    cfg = tiny_port_config(**kw)
    params = jax_random_params(jcfg, seed=0)
    audio = (np.random.default_rng(3).standard_normal((2, 3 * 1920)) * 0.3).astype(np.float32)
    jparams, jaudio = jax.device_put(params), jnp.asarray(audio)
    want = np.asarray(jax.jit(lambda p, a: jax_seanet_encode(p, jcfg, a[:, None, :], None)[0])(
        jparams, jaudio))
    weights = conv_layout_probe.nlc_weights(params_to_torch(params, torch.device("cpu")))
    with torch.no_grad():
        got = conv_layout_probe.seanet_nlc(weights, cfg, torch.from_numpy(audio)[:, None, None, :])
    assert got.is_contiguous(memory_format=torch.channels_last)
    got = got[:, :, 0, :].numpy()
    assert got.shape == want.shape == (2, cfg.hidden_size, 6)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if kw.get("pad_mode") != "replicate":
        nhc = jax.jit(lambda p, a: load_jax_script("conv_layout_probe").seanet_nhc(
            p, jcfg, a[:, :, None]))(jparams, jaudio)
        np.testing.assert_allclose(got, np.asarray(nhc).transpose(0, 2, 1), rtol=0, atol=ATOL)


def test_seanet_nlc_variants_agree_on_the_port(monkeypatch):
    """``setup``'s three SEANets (kernel stage, plain NCL, NLC) on the CPU,
    where the kernel stage runs its plain version: one shape, within 1e-5
    abs of the plain NCL."""
    cfg, params, audio, audio_s, seanets = conv_layout_probe.setup(
        2, 1.0, torch.device("cpu"), cfg=tiny_port_config())
    assert audio.shape == (2, 24_000 // 1920 * 1920) and audio_s == 2 * 23_040 / 24_000
    with torch.no_grad():
        outs = {n.strip(): f(audio) for n, f in seanets.items()}
    ref = outs["seanet NCL torch"]
    assert ref.shape == (2, cfg.hidden_size, 23_040 // 960)
    for name, out in outs.items():
        assert out.shape == ref.shape, name
        assert float((out - ref).abs().max()) <= ATOL, name


def test_receipt_and_layout_refuse_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (warmup_tails_receipt, conv_layout_probe):
        monkeypatch.setattr(mod, "MimiConfig", lambda: pytest.fail("built a model"))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
