"""PyTorch port, qualification scripts (``tokenize_audio_tpu_torch.scripts``),
part 1: the k-means-codebook oracle and what reads it, and the split-boundary
census, against the JAX package's scripts (``scripts/``, loaded by path) on
the tiny oracle config on the CPU: ``varied_audio`` bit-equal, ``kmeans``
given JAX's initial draw (centroids within rtol 1e-5 / atol 1e-6,
assignments equal), ``pre_rvq_embeddings`` within 1e-5 x max|.|,
``train_codebooks`` given JAX's draws (embeds within 1e-5), the precision
probe's report key for key, and ``census`` equal."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tokenize_audio_tpu.mimi as jax_mimi
from tests.torch_scripts import (
    jax_kmeans_inits,
    load_jax_script,
    no_compile_cache,
    run_jax_main,
    tiny_jax,
    tiny_port_config,
)
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import random_params
from tokenize_audio_tpu_torch.scripts import bf16_qualification as bq
from tokenize_audio_tpu_torch.scripts import device_params
from tokenize_audio_tpu_torch.scripts import precision_probe, split_boundary_census

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_bq():
    return load_jax_script("bf16_qualification")


@pytest.fixture(scope="module")
def tiny():
    """(port config, JAX config, numpy params) of the tiny oracle."""
    cfg = tiny_port_config()
    return cfg, tiny_jax(), random_params(cfg, seed=0)


@pytest.fixture(scope="module")
def embeddings(jax_bq, tiny):
    """Both packages' pre-RVQ embeddings of 16 s of varied audio (four 4 s
    segments), in chunks of 60 frames (a partial last chunk)."""
    cfg, jcfg, params = tiny
    audio = bq.varied_audio(np.random.default_rng(5), 13.0)
    want = jax_bq.pre_rvq_embeddings(params, jcfg, audio, batch_frames=60)
    got = bq.pre_rvq_embeddings(device_params(params, cfg, CPU), cfg, audio, batch_frames=60)
    return got, want


@pytest.mark.parametrize("seconds,seg", [(37.0, 4.0), (9.5, 2.5)])
def test_varied_audio_bit_equal(jax_bq, seconds, seg):
    r1, r2 = np.random.default_rng(1), np.random.default_rng(1)
    got = bq.varied_audio(r1, seconds, seg=seg)
    np.testing.assert_array_equal(got, jax_bq.varied_audio(r2, seconds, seg=seg))
    assert got.dtype == np.float32 and r1.random() == r2.random()  # same draws


def _jax_assign(x, cent):
    d2 = jnp.sum(x * x, 1, keepdims=True) - 2.0 * x @ cent.T + jnp.sum(cent * cent, 1)[None]
    return np.asarray(jnp.argmin(d2, 1))


@pytest.mark.parametrize("n,k,iters", [(400, 16, 6), (96, 64, 3)])
def test_kmeans_matches_jax_given_its_draw(jax_bq, n, k, iters):
    rng = np.random.default_rng(n)
    centers = rng.standard_normal((8, 16)).astype(np.float32) * 3
    x = (centers[rng.integers(0, 8, n)] + rng.standard_normal((n, 16))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    idx = np.asarray(jax.random.choice(key, n, shape=(k,), replace=n < k))
    want = np.asarray(jax_bq.kmeans(jnp.asarray(x), k, iters, key))
    got = bq.kmeans(torch.from_numpy(x), k, iters, init_idx=idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        bq.nearest(torch.from_numpy(x), got).numpy(), _jax_assign(jnp.asarray(x), jnp.asarray(want))
    )


def test_kmeans_draws_from_its_generator():
    """Without ``init_idx`` the port draws its own rows: distinct rows when
    there are enough, the same draw for the same seed, and jittered copies
    when there are fewer rows than centroids."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((50, 4)).astype(np.float32))
    a = bq.kmeans(x, 8, 0, torch.Generator().manual_seed(1))
    b = bq.kmeans(x, 8, 0, torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len({tuple(r) for r in a.tolist()}) == 8
    assert all(any(torch.equal(r, y) for y in x) for r in a)  # rows of x
    few = bq.kmeans(x[:3], 8, 2, torch.Generator().manual_seed(1))
    assert few.shape == (8, 4) and torch.isfinite(few).all()


def test_pre_rvq_embeddings_match_jax(embeddings):
    got, want = embeddings
    assert got.shape == want.shape == (200, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_train_codebooks_matches_jax_with_its_inits(jax_bq, tiny, embeddings):
    cfg, jcfg, params = tiny
    emb = embeddings[1]
    books = 4
    want = jax_bq.train_codebooks(params, jcfg, emb, books, iters=3)
    inits = jax_kmeans_inits(emb.shape[0], cfg.codebook_size, books)
    got = bq.train_codebooks(params, cfg, emb, books, iters=3, device="cpu", inits=inits)
    for head, n in (("semantic", 1), ("acoustic", books - 1)):
        g, w = got["rvq"][head]["embed"], np.asarray(want["rvq"][head]["embed"])
        assert g.shape == w.shape == (n, cfg.codebook_size, cfg.codebook_dim)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got["rvq"][head]["in_proj"], params["rvq"][head]["in_proj"])
    assert got["enc_in"] is params["enc_in"] and got["tfm"] is params["tfm"]
    # the input tree keeps its random codebooks
    assert not np.allclose(params["rvq"]["semantic"]["embed"][0], got["rvq"]["semantic"]["embed"][0])


def test_device_params_pack_the_trained_codebooks(tiny, embeddings):
    """A tree built after training packs the TRAINED codebooks: what the
    RVQ kernel searches is what the plain version searches."""
    cfg, _, params = tiny
    trained = bq.train_codebooks(params, cfg, embeddings[0], 3, iters=2, device="cpu")
    dp = device_params(trained, cfg, CPU)
    for head in ("semantic", "acoustic"):
        embed, (packed, e2) = dp["rvq"][head]["embed"], dp["rvq"][head]["packed"]
        np.testing.assert_array_equal(embed.numpy(), trained["rvq"][head]["embed"])
        torch.testing.assert_close(e2, (embed * embed).sum(-1), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(packed[..., : embed.shape[1]], embed.transpose(1, 2))


PROBE_ARGV = ["--books", "4", "--train-sec", "24", "--eval-sec", "16", "--kmeans-iters", "3",
              "--timing-rounds", "1"]
TIMING = ("_median_s", "_x_realtime")


def test_precision_probe_report_equals_jax(jax_bq, monkeypatch, capsys):
    """Both probes at the tiny config on the CPU. The port's training
    embeddings are held to JAX's (1e-5 x max|.|) and the port trains its
    own codebooks from JAX's draws; the probe then encodes on JAX's
    codebooks, so the codes are comparable bit for bit: every key equal but
    the timings', and on the CPU "high" equals "highest". (The training
    audio repeats its AM segment, so near-equal rows start as centroids and
    the matmuls' summation order decides their ties: the codebooks
    themselves are held by ``test_train_codebooks_matches_jax_with_its_inits``.)"""
    no_compile_cache(monkeypatch)
    monkeypatch.setitem(sys.modules, "bf16_qualification", jax_bq)
    monkeypatch.setattr(jax_mimi, "MimiConfig", tiny_jax)
    jax_probe = load_jax_script("precision_probe")
    jax_run = {}
    jax_train = jax_bq.train_codebooks

    def record(params, cfg, emb, books, iters=12):
        jax_run["emb"], jax_run["params"] = emb, jax_train(params, cfg, emb, books, iters=iters)
        return jax_run["params"]

    monkeypatch.setattr(jax_bq, "train_codebooks", record)
    run_jax_main(jax_probe, PROBE_ARGV, monkeypatch)
    lines = capsys.readouterr().out.splitlines()
    want = json.loads(next(ln for ln in lines if ln.startswith("RESULT "))[7:])

    port_train = bq.train_codebooks
    trained = {h: np.asarray(v["embed"]) for h, v in jax_run["params"]["rvq"].items()}

    def from_jax_draws(params, cfg, emb, books, iters=12, device=None):
        ref = jax_run["emb"]
        assert emb.shape == ref.shape and np.abs(emb - ref).max() <= 1e-5 * np.abs(ref).max()
        inits = jax_kmeans_inits(ref.shape[0], cfg.codebook_size, books)
        own = port_train(params, cfg, ref, books, iters=iters, device=device, inits=inits)
        for head, embed in trained.items():
            assert own["rvq"][head]["embed"].shape == embed.shape
            assert np.isfinite(own["rvq"][head]["embed"]).all()
        return {**own, "rvq": {h: {**own["rvq"][h], "embed": trained[h]} for h in trained}}

    monkeypatch.setattr(bq, "train_codebooks", from_jax_draws)
    monkeypatch.setattr(precision_probe, "MimiConfig", tiny_port_config)
    got = precision_probe.main(PROBE_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert json.loads(out.splitlines()[-1][7:]) == got
    assert "device: cpu" in out and "building activations" in out
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith(TIMING):
            assert got[key] > 0, key
        elif key.startswith("bf16_"):
            assert np.shape(got[key]) == np.shape(want[key]), key
            assert 0 < np.min(got[key]) and np.max(got[key]) <= 1, key
        else:
            assert got[key] == want[key], key
    assert got["eval_frames"] == 200 and len(got["usage"]) == 4
    assert got["high_code_match"] == got["high_frame_match"] == 1.0
    assert 0 < got["bf16_code_match"] < 1


def test_bf16_qualification_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(bq, "MimiConfig", tiny_port_config)
    got = bq.main(["--books", "3", "--train-sec", "24", "--eval-sec", "16",
                   "--kmeans-iters", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "codebook usage (of 64)" in out and "all-3 frame match" in out
    assert len(got["usage"]) == 3 and 0 <= got["code_match"] <= 1


@pytest.mark.parametrize("rate", [16_000, 48_000])
def test_split_boundary_census_equals_jax(tiny, rate):
    """``census`` through both packages' engines with 4 s pieces (10 s of
    audio: two boundaries): the reports equal, key for key."""
    cfg, jcfg, params = tiny
    kw = dict(min_bucket_seconds=2.0, samples_per_batch=192 * 24_000, max_chunk_seconds=4.0)
    jax_mod = load_jax_script("split_boundary_census")
    want = jax_mod.census(JaxEngine(params, jcfg, JaxEngineConfig(**kw)), rate, 10.0, 1)
    got = split_boundary_census.census(
        MimiEncoderEngine(params, cfg, EngineConfig(**kw), device="cpu"), rate, 10.0, 1)
    assert got == want
    assert got["boundaries"] == 2 and got["frames"] == 125


def test_split_boundary_census_main(monkeypatch, capsys):
    monkeypatch.setattr(split_boundary_census, "MimiConfig", tiny_port_config)
    monkeypatch.setattr(split_boundary_census, "EngineConfig",
                        lambda **kw: EngineConfig(**kw, max_chunk_seconds=4.0))
    result, rows = split_boundary_census.main(["--seconds", "9", "--seeds", "0,2", "--rates",
                                               "16000", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and json.loads(lines[-1][7:]) == result
    assert [json.loads(ln) for ln in lines[1:-1]] == rows
    assert result["census_rows"] == 2 and result["total_boundaries"] == 4
