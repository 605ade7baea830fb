"""PyTorch port on the card: each CUDA kernel against its plain version at
small and ragged shapes, and the tiny-config encode, stream, engine and
decode on the card against the same code on the CPU. Each test asks for
the ``cuda`` fixture, which skips it where no CUDA device is present; run
on a GPU machine with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX, which this file does not
use and a GPU machine need not have)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from torch_corpora import audio_cell, tone_pcm
from torch_yodas2_mirror import Entry, noise_pcm, write_mirror
from tokenize_audio_tpu_torch import benchmark
from tokenize_audio_tpu_torch.config import EngineConfig, ieee_fp32
from tokenize_audio_tpu_torch.core.audio import resample, resample_many
from tokenize_audio_tpu_torch.core.codes import chars_to_codes
from tokenize_audio_tpu_torch.datasets import parquet_corpus, yodas2
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import LocalHub
from tokenize_audio_tpu_torch.mimi import (
    MimiConfig,
    decode,
    encode,
    params_to_torch,
    random_params,
    streaming,
)
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


def _rows_with_near_ties(x, e, rel=1e-6):
    """Rows of the plain chain that, at some book, have a runner-up within
    ``rel`` (relative) of the minimal distance: only there may another
    summation order pick another code."""
    residual, near = x, torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for book in e:
        d2 = (residual * residual).sum(-1, keepdim=True) - 2.0 * (residual @ book.T) + (
            book * book).sum(-1)[None, :]
        two = torch.topk(d2, 2, dim=-1, largest=False).values
        near |= (two[:, 1] - two[:, 0]) <= rel * two[:, 0].abs()
        residual = residual - book[torch.argmin(d2, dim=-1)]
    return near


# small and ragged shapes, then the main path's width (D = 256, V = 2048,
# 31 books) at its row counts and just past each of pick()'s thresholds
# (csrc/rvq.cu: 112, 240, 336, 720 and 2048 rows)
RVQ_CASES = [(300, 16, 4, 64), (33, 40, 3, 100), (1000, 256, 2, 2048)] + [
    (n, 256, 31, 2048) for n in (1, 13, 17, 31, 33, 113, 241, 267, 337, 721, 824, 1025, 2049)
]


@pytest.mark.parametrize("n,d,k,v", RVQ_CASES)
def test_rvq_kernel_equals_plain(cuda, n, d, k, v):
    """Codes equal the plain version's on every row whose chain has no
    near-tie, and on at least 99.9 % of entries; a call with the packed
    codebooks and one that packs at the launch give the same codes."""
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(cuda)
    e = torch.from_numpy(rng.standard_normal((k, v, d)).astype(np.float32)).to(cuda)
    before = rvq.rvq_quantize.launches
    got = rvq.rvq_quantize(x, e)
    assert rvq.rvq_quantize.launches == before + 1
    assert torch.equal(rvq.rvq_quantize(x, e, packed=rvq.pack_codebooks(e)), got)
    assert rvq.rvq_quantize.launches == before + 2
    with ieee_fp32():
        want = rvq.rvq_quantize_reference(x, e)
        near = _rows_with_near_ties(x, e)
    assert got.dtype == torch.int32 and got.shape == (n, k)
    assert torch.equal(got[~near], want[~near])
    assert float((got == want).float().mean()) >= 0.999
    _, margins, _ = rvq.first_divergence_margins(x, e, got, want)
    assert max(margins, default=0.0) < 1e-6


def test_rvq_kernel_refuses_a_wrong_packing(cuda):
    e = torch.zeros((2, 10, 16), device=cuda)
    x = torch.zeros((4, 16), device=cuda)
    cb, e2 = rvq.pack_codebooks(e)
    with pytest.raises(ValueError, match="packed"):
        rvq.rvq_quantize(x, e, packed=(e, e2))
    with pytest.raises(ValueError, match="packed"):
        rvq.rvq_quantize(x, e, packed=(cb, e2[:1]))


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


# (B, C, T): the first five are small and odd shapes; then B = 1 and 2 at
# the main path's widths, with T ragged against each width's time tile
# (256 columns at C = 64, 128 at C = 128, 128 or 64 at C = 256, 64 or 32 at
# C = 512, by the launch's column count): T = 1, T < tile, tile * k +- 1, a
# multiple of 4 (16-byte path) and not; the last cases at each width span
# many tiles (and clusters at C >= 256), past the column count where the
# kernel changes its tile.
RESBLOCK_CASES = [
    (3, 8, 9000), (3, 16, 5000), (3, 64, 2500), (3, 96, 777), (3, 512, 301),
    (1, 64, 1), (2, 64, 255), (1, 64, 257), (2, 64, 511), (2, 64, 4096),
    (1, 128, 1), (2, 128, 127), (1, 128, 129), (2, 128, 383), (2, 128, 3840),
    (1, 256, 3), (2, 256, 63), (1, 256, 129), (2, 256, 1023), (2, 256, 2049),
    (2, 256, 2784),
    (1, 512, 1), (2, 512, 31), (1, 512, 33), (2, 512, 63), (1, 512, 65),
    (2, 512, 191), (2, 512, 1537), (1, 512, 2001), (2, 512, 4000),
]


@pytest.mark.parametrize("b,c,t", RESBLOCK_CASES)
def test_resblock_kernel_close_to_plain(cuda, b, c, t):
    rng = np.random.default_rng(c * 7919 + t)
    c2 = c // 2
    # row 1 of a two-row batch has valid = 0; every row is checked for zeros
    # past its valid length
    valid = {1: [t // 2 + 1], 2: [t, 0], 3: [t, t // 2 + 5, 1]}[b]
    arrs = [
        (rng.standard_normal((b, c, t)) * 0.5).astype(np.float32),
        np.array(valid, dtype=np.int32),
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
    for i, vl in enumerate(valid):
        assert bool((got[i, :, vl:] == 0).all())


def test_resblock_kernel_takes_packed_weights(cuda):
    """Weights packed once by the caller give the result of packing at the
    launch; a packed pair of the wrong layout is refused."""
    rng = np.random.default_rng(11)
    c, c2, t = 64, 32, 300
    x = torch.from_numpy((rng.standard_normal((1, c, t)) * 0.5).astype(np.float32)).to(cuda)
    v = torch.tensor([t], dtype=torch.int32, device=cuda)
    w = [torch.from_numpy((rng.standard_normal(s) * 0.2).astype(np.float32)).to(cuda)
         for s in ((c2, c, 3), (c2,), (c, c2, 1), (c,))]
    before = seanet.resblock_elu.launches
    got = seanet.resblock_elu(x, v, *w, packed=seanet.pack_weights(w[0], w[2]))
    assert seanet.resblock_elu.launches == before + 1
    assert torch.equal(got, seanet.resblock_elu(x, v, *w))
    with pytest.raises(ValueError, match="packed"):
        seanet.resblock_elu(x, v, *w, packed=(w[0], w[2]))


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


def test_engine_under_inference_mode_on_card(cuda):
    """An engine built and run under torch.inference_mode() (its weights,
    packed conv weights and codebooks included, are inference tensors)
    gives the codes of one built outside it."""
    params = random_params(TINY, seed=2)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(6)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (3000, 19_200, 7777)]
    want = MimiEncoderEngine(params, TINY, ecfg).encode_batch(audios)
    with torch.inference_mode():
        engine = MimiEncoderEngine(params, TINY, ecfg)
        s0, r0 = seanet.resblock_elu.launches, rvq.rvq_quantize.launches
        got = engine.encode_batch(audios)
    assert seanet.resblock_elu.launches > s0
    # the codebooks were packed once, under inference mode, and searched
    assert all("packed" in h for h in engine.params["rvq"].values())
    assert rvq.rvq_quantize.launches > r0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_resample_and_yodas2_on_card_equal_cpu(cuda, tmp_path, monkeypatch):
    """With TF32 switched on by the caller, a 16 -> 24 kHz resample on the
    card matches the CPU to 1e-6 (the conv runs in IEEE fp32 wherever it is
    called from), and the tiny-config YODAS2 processor on the card, whose
    decode-prefetch threads resample the 16 kHz entries, gives the CPU run's
    codes."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    rng = np.random.default_rng(9)
    audio = (rng.standard_normal(3 * 16_000) * 0.3).astype(np.float32)
    got = resample(audio, 16_000, 24_000)
    assert got.device.type == "cuda"
    want = resample(audio, 16_000, 24_000, device="cpu")
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    rows = [audio, (audio[:7777] * 32767).astype(np.int16)]
    for g, w in zip(resample_many(rows, 16_000, 24_000),
                    resample_many(rows, 16_000, 24_000, device="cpu")):
        assert float(np.abs(g - w).max()) <= 1e-6

    chunks = [(0, 100), (100, 100), (50, 300)]  # a degenerate one, one over the cap
    root = write_mirror(str(tmp_path / "mirror"), "en000", [
        [Entry(f"vid-{s}-{a}", noise_pcm(rng, int(sr * sec)), sr, kind, chunks)
         for a, (kind, sr, sec) in enumerate(
             [("wav", 24_000, 3.0), ("flac", 24_000, 2.5), ("wav", 16_000, 3.5)])]
        for s in range(2)
    ])
    params = random_params(TINY, seed=3)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    codes = {}
    for device in ("cuda", "cpu"):
        engine = MimiEncoderEngine(params, TINY, ecfg, num_codebooks=12, device=device)
        hub = LocalHub(str(tmp_path / device / "hub"))
        r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
        report = yodas2.Yodas2ShardProcessor(
            "en000", yodas2.LocalSource(root), hub, engine, str(tmp_path / device / "work"),
            str(tmp_path / device / "prog"), max_consecutive_missing=2,
        ).process()
        assert report["processed"] == 2 and report["uploaded"] == 2 and report["failed"] == 0
        if device == "cuda":
            assert rvq.rvq_quantize.launches > r0 and seanet.resblock_elu.launches > s0
        codes[device] = {}
        for path in hub.list_files("data/"):
            with open(hub._abs(path)) as f:
                for e in json.load(f):
                    for cid, c in e["codes"].items():
                        codes[device][cid] = np.array(c)
    assert sorted(codes["cuda"]) == sorted(codes["cpu"]) and len(codes["cpu"]) == 12
    same = np.concatenate([(codes["cuda"][k] == codes["cpu"][k]).reshape(-1)
                           for k in codes["cpu"]])
    assert same.mean() >= 0.99, same.mean()


def test_engine_bench_on_card_fused_16k_equals_cpu(cuda, monkeypatch):
    """The tiny-config engine bench on the card (no ``device``: the card),
    both kernels launched; its engine's fused 16 kHz codes of the bench
    workload equal the CPU engine's on >= 0.99 of codes, each of the JAX
    shape (8, ceil(ceil(len * 3 / 2) / 1920))."""
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=4.0)
    engines = []
    real = benchmark.MimiEncoderEngine

    def capture(*args, **kwargs):
        engines.append(real(*args, **kwargs))
        return engines[-1]

    monkeypatch.setattr(benchmark, "MimiEncoderEngine", capture)
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    res = benchmark.run_engine_bench(n_utts=6, passes=2, mimi_cfg=TINY, engine_cfg=ecfg)
    assert rvq.rvq_quantize.launches > r0 and seanet.resblock_elu.launches > s0
    assert res["value"] > 0 and res["detail"]["fused_16khz_x_realtime"] > 0
    assert "vs_baseline" not in res and res["detail"]["device"] != "cpu"
    [card] = engines
    assert card.device.type == "cuda"
    _, audios16 = benchmark.engine_workload(6, 0, ecfg)
    got = card.encode_batch(audios16, sr=16_000)
    want = MimiEncoderEngine(random_params(TINY, seed=0), TINY, ecfg,
                             device="cpu").encode_batch(audios16, sr=16_000)
    for a, g, w in zip(audios16, got, want):
        valid = -(-len(a) * 3 // 2)
        assert g.shape == w.shape == (8, -(-valid // 1920))
    same = np.concatenate([(g == w).reshape(-1) for g, w in zip(got, want)])
    assert same.mean() >= 0.99, same.mean()


def test_stream_step_on_card_equals_cpu(cuda):
    """One stream step on the card (RVQ kernel launched) against the CPU:
    codes, frame counts and the carried state; then a multiplexed
    encode_streams with ragged ends and a horizon cut."""
    params = random_params(TINY, seed=4)
    rng = np.random.default_rng(10)
    cs = 4 * 1920
    chunk = (rng.standard_normal((3, cs)) * 0.3).astype(np.float32)
    valid = np.array([cs, cs, 5000], dtype=np.int32)
    chunk[2, 5000:] = 0.0
    out = {}
    for dev in ("cpu", "cuda"):
        state = streaming.init_state(TINY, 3, max_frames_25hz=64, device=dev)
        r0 = rvq.rvq_quantize.launches
        codes, v12 = streaming.stream_step(
            params_to_torch(params, dev), TINY, state, torch.from_numpy(chunk).to(dev),
            torch.from_numpy(valid).to(dev), num_quantizers=12)
        if dev == "cuda":
            assert rvq.rvq_quantize.launches == r0 + 2  # semantic + acoustic
        out[dev] = codes.cpu(), v12.cpu(), state
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    assert float((out["cuda"][0] == out["cpu"][0]).float().mean()) >= 0.99
    for got, want in zip(out["cuda"][2].conv_caches + [out["cuda"][2].kv],
                         out["cpu"][2].conv_caches + [out["cpu"][2].kv]):
        assert got.shape == want.shape
        if want.numel():  # the k=1 convs keep no context
            scale = float(want.abs().max())
            assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale

    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32)
              for n in (11 * 1920 + 300, 3 * 1920, 7 * 1920)]
    kw = dict(batch=4, chunk_seconds=2 * 1920 / 24_000, max_seconds=5 * 1920 / 24_000,
              num_quantizers=12)
    want = streaming.StreamingMimiEncoder(params, TINY, device="cpu", **kw).encode_streams(audios)
    got = streaming.StreamingMimiEncoder(params, TINY, **kw).encode_streams(audios)
    assert [g.shape for g in got] == [w.shape for w in want]
    same = np.concatenate([(g == w).reshape(-1) for g, w in zip(got, want)])
    assert same.mean() >= 0.99, same.mean()


def test_stream_policy_kernel_backends_equal_torch_backends(cuda):
    """The engine's stream policy on the card: the kernel RVQ backend (the
    default) against the plain "torch" backends, and against the CPU."""
    params = random_params(TINY, seed=5)
    ecfg = EngineConfig(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=1.0,
                        long_audio_policy="stream")
    rng = np.random.default_rng(11)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (30_000, 10_000, 61_000)]
    plain = dataclasses.replace(TINY, rvq_backend="torch", seanet_backend="torch")
    r0 = rvq.rvq_quantize.launches
    got = MimiEncoderEngine(params, TINY, ecfg, num_codebooks=12).encode_batch(audios)
    assert rvq.rvq_quantize.launches > r0
    for other in (MimiEncoderEngine(params, plain, ecfg, num_codebooks=12),
                  MimiEncoderEngine(params, TINY, ecfg, num_codebooks=12, device="cpu")):
        want = other.encode_batch(audios)
        assert [g.shape for g in got] == [w.shape for w in want]
        same = np.concatenate([(g == w).reshape(-1) for g, w in zip(got, want)])
        assert same.mean() >= 0.99, same.mean()


def test_decode_on_card_equals_cpu(cuda, monkeypatch):
    """decode on the card within atol 3e-4 * max|CPU|, rtol 1e-3 of the CPU,
    with TF32 switched on by the caller (the decoder runs in IEEE fp32)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    params = random_params(TINY, seed=6)
    codes = torch.from_numpy(np.random.default_rng(12).integers(0, 64, size=(2, 12, 7)))
    want = decode(params_to_torch(params, "cpu"), TINY, codes)
    got = decode(params_to_torch(params, cuda), TINY, codes.to(cuda)).cpu()
    assert got.shape == want.shape == (2, 7 * 1920)
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=3e-4 * scale, rtol=1e-3)


def test_parquet_corpus_48k_on_card_equals_cpu(cuda):
    """``parquet_corpus.encode_samples`` on Common Voice rows of 48 kHz
    ``{'bytes': WAV}`` cells (int16, resampled inside the encode) on the
    card, both kernels launched, against the CPU engine: no batch skipped
    and the codes equal on at least 99 % of entries."""
    params = random_params(TINY, seed=7)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)
    rng = np.random.default_rng(13)
    rows = [{"id": f"cv{i}", "sentence": f"phrase {i}", "client_id": "c",
             "audio": audio_cell(tone_pcm(rng, 0.5 + 0.3 * i, 48_000), 48_000, "wav")}
            for i in range(6)]
    spec = parquet_corpus.SPECS["common_voice"]
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    got = parquet_corpus.encode_samples(rows, spec, MimiEncoderEngine(params, TINY, ecfg))
    assert rvq.rvq_quantize.launches > r0 and seanet.resblock_elu.launches > s0
    want = parquet_corpus.encode_samples(
        rows, spec, MimiEncoderEngine(params, TINY, ecfg, device="cpu"))
    assert [s["id"] for s in got] == [s["id"] for s in want] == [f"cv{i}" for i in range(6)]
    codes = [[np.asarray(chars_to_codes(s["audio_str"], 8, 2048, return_tensors="np",
                                        unicode_offset=0xE000)) for s in ss]
             for ss in (got, want)]
    same = np.concatenate([(g == w).reshape(-1) for g, w in zip(*codes)])
    assert same.mean() >= 0.99, same.mean()


@pytest.mark.parametrize("mode,resblock", [({}, True), ({"matmul_precision": "high"}, True),
                                           ({"compute_dtype": "bfloat16"}, False)])
def test_modes_launch_their_kernels_on_card(cuda, mode, resblock):
    """Parity and TF32 encodes launch both kernels; a bf16 encode launches
    the RVQ kernel and not the resblock kernel (float32 only, as the JAX
    package's Pallas stage), and still gives codes of the right shape."""
    cfg = dataclasses.replace(TINY, **mode)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(21)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (5000, 19_200, 30_000)]
    engine = MimiEncoderEngine(random_params(TINY, seed=1), cfg, ecfg)
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    got = engine.encode_batch(audios)
    assert rvq.rvq_quantize.launches > r0
    assert (seanet.resblock_elu.launches > s0) == resblock
    assert [g.shape for g in got] == [(8, -(-len(a) // 1920)) for a in audios]


def test_parity_and_tf32_engines_at_once_on_card(cuda):
    """A parity engine and a TF32 engine encode at once in two threads on
    the card: the parity codes equal a parity-only run, and each thread's
    TF32 flags at every conv1d / linear / matmul launch are its mode's at
    that site (the resample, in_proj and the fused stage's down-conv IEEE in
    both). Each engine meets its batch shapes first in its thread: a shape
    seen before would replay its transformer from a CUDA graph, with no
    launch of its own to check."""
    import sys
    import threading

    import torch.nn.functional as F

    ieee = ("_resample_batch", "seanet_stage", "split_rvq_encode")
    tf32 = ("seanet_encode", "transformer_apply", "_encode")

    def site(frame):
        while frame is not None:
            if frame.f_code.co_name in ieee + tf32:
                return frame.f_code.co_name
            frame = frame.f_back
        return None

    params = random_params(TINY, seed=2)
    ecfg = EngineConfig(batch_size=4, min_bucket_seconds=0.5, max_chunk_seconds=2.0)
    rng = np.random.default_rng(22)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (5000, 19_200, 30_000)]
    audios16 = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (9000, 20_000)]
    alone = MimiEncoderEngine(params, TINY, ecfg)
    want = alone.encode_batch(audios) + alone.encode_batch(audios16, sr=16_000)
    parity = MimiEncoderEngine(params, TINY, ecfg)
    fast = MimiEncoderEngine(params, dataclasses.replace(TINY, matmul_precision="high"), ecfg)
    calls, real = [], {}
    for mod, name in ((F, "conv1d"), (F, "linear"), (torch, "matmul")):
        real[name] = fn = getattr(mod, name)

        def spy(*a, _fn=fn, **k):
            calls.append((threading.current_thread().name, site(sys._getframe(1)),
                          torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return _fn(*a, **k)

        setattr(mod, name, spy)
    out = {}
    try:
        threads = [threading.Thread(
            target=lambda n=n, e=e: out.setdefault(n, [e.encode_batch(audios) + e.encode_batch(
                audios16, sr=16_000) for _ in range(3)]), name=n)
            for n, e in (("parity", parity), ("tf32", fast))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
    finally:
        F.conv1d, F.linear, torch.matmul = real["conv1d"], real["linear"], real["matmul"]
    assert not any(t.is_alive() for t in threads) and set(out) == {"parity", "tf32"}
    for run in out["parity"]:
        for g, w in zip(run, want):
            np.testing.assert_array_equal(g, w)
    seen = set()
    for thread, where, cudnn, matmul in calls:
        assert where is not None, thread
        on = thread == "tf32" and where in tf32
        assert cudnn == matmul == on, (thread, where, cudnn, matmul)
        seen.add((thread, where))
    assert seen == {(t, s) for t in ("parity", "tf32") for s in ieee + tf32}, seen
    # the second and third rounds replayed the first's graphs
    assert parity.stats.transformer_graph_replays > 0 and fast.stats.transformer_graph_replays > 0


@pytest.mark.parametrize("policy", ["ready", "threaded"])
def test_drains_on_card_equal_fifo(cuda, policy):
    params = random_params(TINY, seed=4)
    ecfg = EngineConfig(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=2.0)
    rng = np.random.default_rng(23)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16)
              for n in (1000, 5000, 19_200, 26_000, 7777, 600, 60_000, 3333)]
    fifo = MimiEncoderEngine(params, TINY, ecfg, pipeline_depth=3)
    other = MimiEncoderEngine(params, TINY, dataclasses.replace(ecfg, drain_policy=policy),
                              pipeline_depth=3)
    for g, w in zip(other.encode_batch(audios), fifo.encode_batch(audios)):
        np.testing.assert_array_equal(g, w)
    assert other.stats.frames == fifo.stats.frames


def test_chip_check_on_card(cuda):
    """The pod runner's single-GPU contract holds on GPU 0, and a child
    given an index with no GPU behind it sees none."""
    from tokenize_audio_tpu_torch.runner.chip_check import check_chip

    import os

    rep = check_chip(chip=0, timeout=300)
    # GPU 0 of this process's allocation: the first entry of its own
    # CUDA_VISIBLE_DEVICES where that is set
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0].strip()
    assert rep["ok"] and rep["injected_env"] == {"CUDA_VISIBLE_DEVICES": first}, rep
    assert rep["child"]["n_devices"] == 1 and rep["child"]["compute_ok"]
    assert rep["child"]["device0"] == torch.cuda.get_device_name(0)
    bad = check_chip(chip=torch.cuda.device_count(), timeout=300)
    assert not bad["ok"] and bad["child"]["n_devices"] == 0, bad


def _tiny_hf_oracle(seed: int = 0):
    """A seeded random-weight transformers MimiModel at TINY's widths (the
    kit's oracle recipe, as tests/mimi_fixtures.make_oracle)."""
    from transformers import MimiConfig as HFMimiConfig

    from tokenize_audio_tpu_torch import qualify

    fields = ("num_filters", "hidden_size", "num_hidden_layers", "intermediate_size",
              "num_attention_heads", "num_key_value_heads", "head_dim", "codebook_size",
              "codebook_dim", "vector_quantization_hidden_dimension", "num_quantizers",
              "upsample_groups")
    return qualify._random_oracle(seed, HFMimiConfig(**{f: getattr(TINY, f) for f in fields}))


def test_qualify_on_card_equals_cpu(cuda):
    """The kit at the tiny config with the port on the card: the same
    report as with the port on the CPU, the resblock and RVQ kernels
    launched, every check passing."""
    from tokenize_audio_tpu_torch import qualify

    model = _tiny_hf_oracle()
    kw = dict(model=model, audio_seeds=(0, 1), n_utts=4, max_seconds=2.0,
              engine_cfg=EngineConfig(batch_size=4, min_bucket_seconds=0.5,
                                      max_chunk_seconds=4.0))
    want = qualify.run_qualification(device="cpu", **kw)
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    got = qualify.run_qualification(**kw)
    assert rvq.rvq_quantize.launches > r0 and seanet.resblock_elu.launches > s0
    assert got["passed"] and want["passed"]
    assert got["device"] == torch.cuda.get_device_name(0)
    assert got["checks"]["conversion"] == want["checks"]["conversion"]
    for key in ("frames", "flipped_frames", "flips", "per_seed", "non_tie_flips"):
        assert got["checks"]["exact_codes"][key] == want["checks"]["exact_codes"][key], key
    assert got["checks"]["per_layer"]["ok"]


def test_surgery_on_card_equals_cpu(cuda, tmp_path, capsys):
    """bpe.surgery's command line resizes a tiny causal LM on the card (no
    ``--device``) and on the CPU: the same report and tokenizer, the kept
    rows and every other tensor bit-equal, the new rows (noise from the CPU
    generator, the mean reduced on each device) within 1e-6 x max|w|."""
    from safetensors.torch import load_file
    from transformers import LlamaConfig, LlamaForCausalLM

    from tokenize_audio_tpu_torch.bpe import surgery
    from tokenize_audio_tpu_torch.bpe.trainer import CodecBPETrainer

    codes = np.empty(2, dtype=object)
    codes[:] = [np.arange(32, dtype=np.uint16).reshape(2, 16) % 4 for _ in range(2)]
    (tmp_path / "codes").mkdir()
    np.save(str(tmp_path / "codes" / "c.npy"), codes, allow_pickle=True)
    CodecBPETrainer(2, 4, vocab_size=10, eos_token="<|endoftext|>", unk_token="<unk>",
                    max_token_codebook_ngrams=0, unicode_offset=0x4E00).train(
        str(tmp_path / "codes")).save_pretrained(str(tmp_path / "tok"))
    torch.manual_seed(0)
    LlamaForCausalLM(LlamaConfig(vocab_size=16, hidden_size=64, intermediate_size=128,
                                 num_hidden_layers=1, num_attention_heads=4,
                                 num_key_value_heads=4)).save_pretrained(str(tmp_path / "lm"))
    reports = {}
    for tag, device in (("card", []), ("cpu", ["--device", "cpu"])):
        surgery.main(["--tokenizer", str(tmp_path / "tok"), "--out-dir", str(tmp_path / f"t_{tag}"),
                      "--add-audio-alphabet", "--num-codebooks", "2", "--codebook-size", "64",
                      "--unicode-offset", "0xE000", "--pipeline-specials",
                      "--model", str(tmp_path / "lm"), "--model-out", str(tmp_path / f"m_{tag}"),
                      *device])
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        reports[tag] = (rep["vocab_size"], rep["model_vocab_size"])
    assert reports["card"] == reports["cpu"] == (10 + 128 + 4,) * 2
    for name in ("tokenizer.json", "tokenizer_config.json"):
        assert (json.loads((tmp_path / "t_card" / name).read_text())
                == json.loads((tmp_path / "t_cpu" / name).read_text()))
    base = load_file(str(tmp_path / "lm" / "model.safetensors"))
    card = load_file(str(tmp_path / "m_card" / "model.safetensors"))
    cpu = load_file(str(tmp_path / "m_cpu" / "model.safetensors"))
    for name, w in cpu.items():
        if name in ("model.embed_tokens.weight", "lm_head.weight"):
            assert torch.equal(card[name][:16], base[name][:16])
            assert torch.equal(w[:16], base[name][:16])
            assert (card[name][16:] - w[16:]).abs().max() <= 1e-6 * w.abs().max()
        else:
            assert torch.equal(card[name], w), name
