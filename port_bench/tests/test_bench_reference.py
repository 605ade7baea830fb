"""The plain reference against the program's CPU path (bit-equal to HF on
the CPU) and against transformers' ``MimiModel`` and SciPy, at a tiny size.
The test may import all of them; the reference imports none."""

import ast
import math
import os

import numpy as np
import pytest
import torch

from bench_testkit import BENCH, TINY, tiny_inputs
from pbkit import weights
from reference import chunks_ref, mimi_ref, resample_ref

CPU = torch.device("cpu")


def _tiny(books=8):
    _, _, cfg, _, _ = tiny_inputs("engine-web.8cb")
    cfg["run"]["num_codebooks"] = books
    return cfg


def _ref_codes(sd, cfg, audio, books):
    """The reference's own greedy codes: the nearest codeword per book."""
    emb = mimi_ref.embeddings(sd, cfg, audio)
    codes = []
    n_sem = cfg["num_semantic_quantizers"]
    for head, n in (("semantic", min(n_sem, books)), ("acoustic", books - n_sem)):
        if n <= 0:
            continue
        w = sd[f"quantizer.{head}_residual_vector_quantizer.input_proj.weight"]
        r = torch.nn.functional.conv1d(emb[None], w)[0].T.double()
        for e in mimi_ref.codebooks(sd, head, n).double():
            d = (r * r).sum(-1, keepdim=True) - 2 * r @ e.T + (e * e).sum(-1)
            c = d.argmin(dim=1)
            codes.append(c)
            r = r - e[c]
    return torch.stack(codes).numpy(), emb


@pytest.mark.parametrize("seconds", [0.37, 1.0, 2.71])
@pytest.mark.parametrize("books", [1, 8, 12])
def test_reference_matches_the_program_on_the_cpu(seconds, books):
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi.weights import convert_hf_state_dict
    from pbkit import program

    cfg = _tiny(books)
    sd = weights.state_dict(cfg, 1234 + books, CPU)
    mcfg = program.mimi_config(cfg, cfg["run"])
    engine = MimiEncoderEngine(convert_hf_state_dict(sd, mcfg), mcfg, num_codebooks=books, device="cpu")
    rng = np.random.default_rng(books)
    audio = (rng.standard_normal(int(seconds * 24000)) * 8000).astype(np.int16)
    got = engine.encode_batch([audio])[0]
    x = torch.from_numpy(audio).float() / 32768.0
    want, emb = _ref_codes(sd, cfg, x, books)
    assert got.shape == want.shape == (books, math.ceil(len(audio) / 1920))
    assert np.array_equal(got, want)
    assert float(mimi_ref.code_gaps(sd, cfg, emb, torch.from_numpy(got)).max()) == 0.0


def test_reference_matches_transformers_mimi():
    transformers = pytest.importorskip("transformers")
    cfg = _tiny(12)
    hf = transformers.MimiModel(transformers.MimiConfig(**TINY)).eval()
    sd = weights.state_dict(cfg, 77, CPU)
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected
    assert all(not k.startswith(("encoder.", "encoder_transformer.", "quantizer.", "downsample."))
               or k.endswith(("initialized",)) for k in missing)
    audio = torch.from_numpy((np.random.default_rng(3).standard_normal(30_000) * 0.2).astype(np.float32))
    with torch.no_grad():
        want = hf.encode(audio[None, None], num_quantizers=12).audio_codes[0].numpy()
    got, _ = _ref_codes(sd, cfg, audio, 12)
    assert np.array_equal(got, want)


def test_code_gaps_read_a_wrong_code():
    cfg = _tiny(8)
    sd = weights.state_dict(cfg, 5, CPU)
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(24_000) * 0.3).astype(np.float32))
    codes, emb = _ref_codes(sd, cfg, x, 8)
    bad = codes.copy()
    bad[3, 4] = (bad[3, 4] + 1) % cfg["codebook_size"]
    gaps = mimi_ref.code_gaps(sd, cfg, emb, torch.from_numpy(bad))
    assert float(gaps[:3].max()) == 0.0 and float(gaps[3]) > 1e-3


@pytest.mark.parametrize("up,down,n", [(3, 2, 16_000), (3, 2, 1_601), (1, 2, 9_999), (160, 147, 4_410)])
def test_resampler_matches_scipy_and_the_program(up, down, n):
    from tokenize_audio_tpu_torch.core.audio import resample

    x = np.random.default_rng(n).standard_normal(n)
    got = resample_ref.resample_poly(torch.from_numpy(x), up, down).numpy()
    signal = pytest.importorskip("scipy.signal")
    want = signal.resample_poly(x, up, down)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    prog = resample(x.astype(np.float32), down * 8000, up * 8000, device="cpu").numpy()
    np.testing.assert_allclose(prog, got, rtol=0, atol=2e-6)


def test_slicer_matches_the_program():
    from tokenize_audio_tpu_torch.datasets.yodas2 import slice_chunks

    audio = np.arange(10 * 24_000)
    ids = [f"v-{i:05d}-{a:08d}-{b:08d}" for i, (a, b) in enumerate(
        [(0, 150), (150, 151), (151, 151), (333, 977), (977, 1200), (990, 1000)])]
    got_ids, segs = slice_chunks(audio, {c: "" for c in ids}, 24_000)
    mine = [(c, chunks_ref.bounds(c, 24_000, len(audio))) for c in ids]
    mine = [(c, b) for c, b in mine if b is not None]
    assert [c for c, _ in mine] == got_ids
    for (_, (a, b)), s in zip(mine, segs):
        assert np.array_equal(audio[a:b], s)


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                        else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in ("tokenize_audio_tpu_torch", "tokenize_audio_tpu",
                                                   "jax", "jaxlib", "flax", "pbkit"), (name, m)
