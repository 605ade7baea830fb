"""PyTorch port, the corpus processors against the JAX package's on the same
synthetic inputs (tiny config, the same params, the port on the CPU): the
document builders and parquet helpers, the parquet-corpus processor
(LibriTTS-R, Common Voice), LibriSpeech, MLS (both stages) and Emilia
(standard and conversational). Documents, codes, stage-1 JSONs and the rows
read back from the uploaded parquet must be equal. Also the cell dtypes, the
per-batch skip of bad audio and the raise of device errors, resume, and the
worker-thread resample of Emilia members off 24 kHz.

One module-scoped pair of engines serves every test, so that the JAX engine
compiles each batch shape once."""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from torch_corpora import (
    CORRUPT, audio_cell, container_bytes, flac_bytes, mls_rows, tone_pcm, wav_bytes,
    write_emilia_tar, write_librispeech,
)
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.datasets import base as jax_base
from tokenize_audio_tpu.datasets import emilia as jax_emilia
from tokenize_audio_tpu.datasets import librispeech as jax_ls
from tokenize_audio_tpu.datasets import mls as jax_mls
from tokenize_audio_tpu.datasets import parquet_corpus as jax_pc
from tokenize_audio_tpu.datasets import parquet_utils as jax_pu
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu.hub import LocalHub as JaxLocalHub
from tokenize_audio_tpu_torch import cli, datasets
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.datasets import (
    base, emilia, librispeech, mls, parquet_corpus, parquet_utils,
)
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import LocalHub
from tokenize_audio_tpu_torch.io import decode_audio
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

ENGINE_KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=2.0)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return params, jcfg, config_from_hf(model.config)


@pytest.fixture(scope="module")
def engines(oracle):
    """The JAX engine and the port's (on the CPU) on the same params, shared
    by the module's tests so that JAX compiles each batch shape once."""
    params, jcfg, cfg = oracle
    return (JaxEngine(params, jcfg, JaxEngineConfig(**ENGINE_KW)),
            MimiEncoderEngine(params, cfg, EngineConfig(**ENGINE_KW), device="cpu"))


def same_rows(got, want):
    """Rows equal as lists of dicts, with their columns in the same order
    and each value of the same type (numpy values by dtype and content)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert type(g[k]) is type(w[k]), (k, type(g[k]), type(w[k]))
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("seconds, sr", [(0.01, 16_000), (2.0, 24_000), (40.0, 16_000)])
def test_fixture_containers_decode_to_their_pcm(seconds, sr):
    """The fixtures' FLAC writer (VERBATIM frames, numpy; 40 s crosses 128
    frames, so the frame number takes two UTF-8 bytes) and WAV writer give
    back their int16 PCM through the port's decoder."""
    pcm = tone_pcm(np.random.default_rng(3), seconds, sr)
    for payload in (flac_bytes(pcm, sr), wav_bytes(pcm, sr)):
        audio, got_sr = decode_audio(payload, raw_int16=True)
        assert got_sr == sr and audio.dtype == np.int16 and np.array_equal(audio, pcm)


CHUNKS = [("Hello there.", ""), ("second one", ""), ("", "")]


@pytest.mark.parametrize("name, args", [
    ("interleaved_type1", (CHUNKS,)),
    ("interleaved_type1", (CHUNKS, [0, 1, None])),
    ("interleaved_type2", (CHUNKS,)),
    ("interleaved_type2", (CHUNKS, [3, 3, 0])),
    ("tts_document", ("a b c", "")),
    ("tts_document", ("a b c", "", 2)),
    ("asr_document", ("a b c", "")),
    ("speaker_tagged_text", ("some words", 4)),
])
def test_document_builders_equal_jax(name, args):
    got = getattr(base, name)(*args)
    assert got == getattr(jax_base, name)(*args)
    assert getattr(datasets, name) is getattr(base, name)  # re-exported


def test_parquet_helpers_equal_jax(tmp_path):
    for i, n in ((0, 1), (3, 12), (11, 10_000)):
        assert parquet_utils.chunk_name("train", i, n) == jax_pu.chunk_name("train", i, n)
    rows = [{"id": f"u{i}", "text": f"doc {i}", "speaker_id": 100 + i, "ids": [i, i + 1]}
            for i in range(3)]
    path = parquet_utils.write_parquet(rows, str(tmp_path / "sub" / "a.parquet"))
    assert path == str(tmp_path / "sub" / "a.parquet")
    assert sorted(os.listdir(tmp_path / "sub")) == ["a.parquet"]  # no temp file left
    jax_pu.write_parquet(rows, str(tmp_path / "b.parquet"))
    got = parquet_utils.read_parquet(path)
    same_rows(got, jax_pu.read_parquet(str(tmp_path / "b.parquet")))
    assert [r["id"] for r in got] == ["u0", "u1", "u2"] and got[2]["ids"].tolist() == [2, 3]


# (layout, sample rate) of the cells encode_samples is held to JAX on
CELLS = [("array", 16_000), ("array", 24_000), ("wav", 16_000), ("flac", 24_000),
         ("wav", 24_000), ("wav", 48_000), ("path", 24_000)]


@pytest.mark.parametrize("layout, sr", CELLS)
def test_encode_samples_equal_jax(engines, tmp_path, layout, sr):
    """Every row's sample equals JAX's. An ``array`` cell decodes to float32
    and a ``bytes``/``path`` WAV or FLAC cell to int16, in both packages:
    the engine ships 24 kHz int16 to the device raw and normalizes the rest
    on the host, so the dtype must be kept for the codes to match."""
    rng = np.random.default_rng(sr + len(layout))
    rows = [{"id": f"cv{i}", "sentence": f" phrase {i} ", "client_id": f"spk{i % 2}",
             "audio": audio_cell(tone_pcm(rng, 0.3 + 0.1 * i, sr), sr, layout,
                                 str(tmp_path / f"clip{i}.wav"))}
            for i in range(3)]
    for r in rows:
        got, want = (m._decode_embedded_audio(r["audio"]) for m in (parquet_corpus, jax_pc))
        assert got[1] == want[1] == sr
        assert got[0].dtype == want[0].dtype == (np.float32 if layout == "array" else np.int16)
        assert np.array_equal(got[0], want[0])
    jax_engine, engine = engines
    spec = parquet_corpus.SPECS["common_voice"]
    got = parquet_corpus.encode_samples(rows, spec, engine)
    want = jax_pc.encode_samples(rows, jax_pc.SPECS["common_voice"], jax_engine)
    assert len(got) == 3 and got == want
    assert got[0]["transcript"] == "phrase 0" and len(got[2]["audio_str"]) % 8 == 0


def libritts_rows():
    """LibriTTS-R rows: 24 kHz ``array`` cells, 2 speakers x 2 chapters."""
    rng = np.random.default_rng(5)
    return [{"id": f"utt{i}", "text_normalized": f'"Sentence {i}."', "speaker_id": 100 + i // 3,
             "chapter_id": 7 + i % 2,
             "audio": audio_cell(tone_pcm(rng, 0.4, 24_000), 24_000, "array")}
            for i in range(6)]


def libritts_samples(engines):
    """``libritts_rows`` encoded by both packages."""
    rows = libritts_rows()
    jax_engine, engine = engines
    return (parquet_corpus.encode_samples(rows, parquet_corpus.SPECS["libritts_r"], engine),
            jax_pc.encode_samples(rows, jax_pc.SPECS["libritts_r"], jax_engine))


def test_rows_type12_and_tts0_equal_jax(engines):
    got, want = libritts_samples(engines)
    assert got == want
    spec, jspec = parquet_corpus.SPECS["libritts_r"], jax_pc.SPECS["libritts_r"]
    t12 = parquet_corpus.rows_type12(got, spec)
    assert t12 == jax_pc.rows_type12(want, jspec) and len(t12) == 12
    assert t12[0]["id"] == "utt0_type1" and t12[0]["speaker_id"] == 100
    tts0 = parquet_corpus.rows_tts0(got, spec)
    assert tts0 == jax_pc.rows_tts0(want, jspec)
    # groups (100, 7): utt0, utt2; (100, 8): utt1; (101, 8): utt3, utt5; (101, 7): utt4
    assert [r["id"] for r in tts0] == ["utt0#utt2", "utt3#utt5"]
    assert tts0[0]["text"].count("<|text_start|>[0]Sentence") == 2


def cv_shard(tmp_path, store_cls, rng, corrupt_row=None):
    """A Common Voice source hub holding ``en/shard0.parquet``: 5 rows of
    48 kHz ``{'bytes': WAV}`` cells (row ``corrupt_row`` holds bytes no
    decoder accepts)."""
    rows = []
    for i in range(5):
        cell = audio_cell(tone_pcm(rng, 0.3 + 0.05 * i, 48_000), 48_000, "wav")
        if i == corrupt_row:
            cell = {"bytes": CORRUPT, "path": "bad.mp3"}
        rows.append({"id": f"cv{i}", "sentence": f"phrase {i}", "client_id": f"spk{i}",
                     "audio": cell})
    local = parquet_utils.write_parquet(rows, str(tmp_path / "shard0.parquet"))
    src = store_cls(str(tmp_path / "src"))
    src.upload_file(local, "en/shard0.parquet")
    return src


def test_process_shard_equal_jax_then_skip(engines, tmp_path):
    jax_engine, engine = engines
    spec = parquet_corpus.SPECS["common_voice"]
    src = cv_shard(tmp_path / "port", LocalHub, np.random.default_rng(7))
    jsrc = cv_shard(tmp_path / "jax", JaxLocalHub, np.random.default_rng(7))
    rep = parquet_corpus.process_shard(spec, "shard0", "en", src, LocalHub(str(tmp_path / "dst")),
                                       engine, str(tmp_path / "work"), str(tmp_path / "prog"))
    jrep = jax_pc.process_shard(jax_pc.SPECS["common_voice"], "shard0", "en", jsrc,
                                JaxLocalHub(str(tmp_path / "jdst")), jax_engine,
                                str(tmp_path / "jwork"), str(tmp_path / "jprog"))
    assert rep == jrep == {"shard": "shard0", "status": "processed", "rows": 10}
    got = parquet_utils.read_parquet(str(tmp_path / "dst" / "en" / "shard0.parquet"))
    same_rows(got, jax_pu.read_parquet(str(tmp_path / "jdst" / "en" / "shard0.parquet")))
    assert list(got[0]) == ["id", "text", "client_id"]
    rep2 = parquet_corpus.process_shard(spec, "shard0", "en", src, LocalHub(str(tmp_path / "dst")),
                                        engine, str(tmp_path / "work"), str(tmp_path / "prog2"))
    assert rep2 == {"shard": "shard0", "status": "skipped"}


def test_decode_error_skips_only_its_batch(engines, tmp_path):
    """Row 2 cannot be decoded: its batch (rows 2-3 at batch size 2) is
    skipped and the others are kept, as in JAX."""
    jax_engine, engine = engines
    spec, jspec = parquet_corpus.SPECS["common_voice"], jax_pc.SPECS["common_voice"]
    src = cv_shard(tmp_path, LocalHub, np.random.default_rng(8), corrupt_row=2)
    rows = parquet_utils.read_parquet(src.download("en/shard0.parquet",
                                                   str(tmp_path / "in.parquet")))
    got = parquet_corpus.encode_samples(rows, spec, engine)
    assert [s["id"] for s in got] == ["cv0", "cv1", "cv4"]
    assert got == jax_pc.encode_samples(rows, jspec, jax_engine)


@pytest.mark.parametrize("exc", [
    RuntimeError("CUDA kernel build failed\n--- nvcc rvq.cu (exit 1):\nerror"),
    RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin"),
    RuntimeError("rvq kernel launch failed: cudaError 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.AcceleratorError("CUDA error: unspecified launch failure"),
], ids=["build", "no_nvcc", "launch", "runtime", "accelerator"])
def test_device_error_is_raised_not_skipped(oracle, monkeypatch, exc):
    """A failed kernel build or a CUDA runtime error inside the engine is
    raised: skipping it would upload an empty shard as processed."""
    params, _, cfg = oracle
    engine = MimiEncoderEngine(params, cfg, EngineConfig(**ENGINE_KW), device="cpu")

    def failing(items):
        raise exc

    monkeypatch.setattr(engine, "encode_batch_mixed", failing)
    rows = [{"id": "cv0", "sentence": "x", "client_id": "s",
             "audio": audio_cell(tone_pcm(np.random.default_rng(0), 0.3, 16_000), 16_000,
                                 "array")}]
    with pytest.raises(type(exc), match=str(exc).splitlines()[0][:20]):
        parquet_corpus.encode_samples(rows, parquet_corpus.SPECS["common_voice"], engine)


def test_main_cli_on_cpu(oracle, engines, tmp_path, monkeypatch, capsys):
    """``main(argv)`` with ``--device cpu`` on a dir: source hub (the tiny
    config and the oracle's params in place of the full-width random ones),
    tts0 variant; its rows equal the JAX processor's, and a rerun skips."""
    params, _, cfg = oracle
    monkeypatch.setattr(cli, "MimiConfig", lambda **kw: dataclasses.replace(cfg, **kw))
    monkeypatch.setattr(cli, "random_params", lambda c: params)
    jax_engine, _ = engines
    want = jax_pc.rows_tts0(jax_pc.encode_samples(libritts_rows(), jax_pc.SPECS["libritts_r"],
                                                  jax_engine), jax_pc.SPECS["libritts_r"])
    src = LocalHub(str(tmp_path / "src"))
    src.upload_file(parquet_utils.write_parquet(libritts_rows(), str(tmp_path / "s.parquet")),
                    "data/s0.parquet")
    argv = ["--corpus", "libritts_r", "--variant", "tts0", "--shard-id", "s0",
            "--source-hub", f"dir:{tmp_path / 'src'}", "--target-hub", f"dir:{tmp_path / 'dst'}",
            "--work-dir", str(tmp_path / "work"), "--progress-dir", str(tmp_path / "prog"),
            "--device", "cpu", "--batch-size", "2", "--max-chunk-seconds", "2"]
    reports = parquet_corpus.main(argv)
    assert reports == [{"shard": "s0", "status": "processed", "rows": 2}]
    assert capsys.readouterr().out.strip().splitlines()[-1] == (
        '[{"shard": "s0", "status": "processed", "rows": 2}]')
    got = parquet_utils.read_parquet(str(tmp_path / "dst" / "data" / "s0.parquet"))
    assert [{k: (int(v) if isinstance(v, np.integer) else v) for k, v in r.items()}
            for r in got] == want
    assert parquet_corpus.main(argv) == [{"shard": "s0", "status": "skipped"}]


# --- LibriSpeech -------------------------------------------------------------

def librispeech_manifest(root, n=6, corrupt=("ls-3",)):
    """16 kHz FLAC and 24 kHz WAV utterances of 0.35-0.45 s (one bucket per
    rate); each id in ``corrupt`` gets a file no decoder accepts."""
    rng = np.random.default_rng(11)
    utts = []
    for i in range(n):
        sr, container = (16_000, "flac") if i % 2 == 0 else (24_000, "wav")
        utts.append((f"ls-{i}", tone_pcm(rng, 0.35 + 0.02 * i, sr), sr, container,
                     f" transcript {i} "))
    path = write_librispeech(str(root), utts, corrupt=corrupt)
    with open(path) as f:
        return path, json.load(f)


def test_librispeech_build_rows_equal_jax(engines, tmp_path):
    """16 kHz FLAC and 24 kHz WAV entries; the corrupt file is dropped and
    the rest encode in one ``encode_batch_mixed`` call, as in JAX."""
    jax_engine, engine = engines
    _, manifest = librispeech_manifest(tmp_path)
    got = librispeech.build_rows(manifest, engine)
    assert got == jax_ls.build_rows(manifest, jax_engine)
    assert [r["id"] for r in got] == [f"ls-{i}_type{t}" for i in (0, 1, 2, 4, 5) for t in (1, 2)]
    assert got[1]["text"].endswith("<|text_start|>transcript 0<|text_end|><|end_of_text|>")


def hub_rows(root):
    """Repo path -> rows read back, for every parquet file of a hub."""
    root = Path(root)
    return {str(p.relative_to(root)): parquet_utils.read_parquet(str(p))
            for p in sorted(root.rglob("*.parquet"))}


def test_librispeech_process_split_resume_and_devtest(engines, tmp_path):
    """The train layout in 2-utterance chunks through ShardRunner, resumed
    from the progress ledger and from the hub; then the devtest layout. Both
    upload the JAX processor's rows."""
    jax_engine, engine = engines
    _, manifest = librispeech_manifest(tmp_path / "audio", corrupt=())
    manifest = manifest[:4]
    for pkg, eng, store in ((librispeech, engine, LocalHub), (jax_ls, jax_engine, JaxLocalHub)):
        tag = pkg.__name__.split(".")[0]
        hub = store(str(tmp_path / tag / "hub"))
        rep = pkg.process_split(manifest, "dev-clean", eng, hub, str(tmp_path / tag / "prog"),
                                str(tmp_path / tag / "work"), chunk_rows=4)
        assert (rep.processed, rep.skipped, rep.failed) == (2, 0, 0)
        rep = pkg.process_split_devtest(
            manifest, "test-clean", eng, hub, str(tmp_path / tag / "prog_dt"),
            str(tmp_path / tag / "work_dt"))
        assert (rep.processed, rep.failed) == (1, 0)
    got = hub_rows(tmp_path / "tokenize_audio_tpu_torch" / "hub")
    assert list(got) == ["data/dev-clean-00000-of-00002.parquet",
                         "data/dev-clean-00001-of-00002.parquet",
                         "data/test-clean_asr.parquet", "data/test-clean_tts.parquet"]
    assert got == hub_rows(tmp_path / "tokenize_audio_tpu" / "hub")
    assert [r["id"] for r in got["data/test-clean_asr.parquet"]] == [f"ls-{i}" for i in range(4)]
    hub = LocalHub(str(tmp_path / "tokenize_audio_tpu_torch" / "hub"))
    for prog in ("prog", "prog_fresh"):  # the ledger, then the hub's markers
        rep = librispeech.process_split(manifest, "dev-clean", engine, hub,
                                        str(tmp_path / "tokenize_audio_tpu_torch" / prog),
                                        str(tmp_path / "work2"), chunk_rows=4)
        assert (rep.processed, rep.skipped) == (0, 2)
    rep = librispeech.process_split_devtest(manifest, "test-clean", engine, hub,
                                            str(tmp_path / "prog_dt2"), str(tmp_path / "work3"))
    assert (rep.processed, rep.skipped) == (0, 1)


def test_librispeech_main_equal_jax_cli(oracle, engines, tmp_path, monkeypatch, capsys):
    """``main(argv)`` with ``--device cpu`` (the tiny config and the
    oracle's params in place of the full-width random ones) uploads the
    rows of the JAX CLI (its engine the JAX engine on the same params)."""
    import tokenize_audio_tpu.utils

    params, _, cfg = oracle
    monkeypatch.setattr(cli, "MimiConfig", lambda **kw: dataclasses.replace(cfg, **kw))
    monkeypatch.setattr(cli, "random_params", lambda c: params)
    monkeypatch.setattr(jax_ls, "_load_engine", lambda args: engines[0])
    monkeypatch.setattr(tokenize_audio_tpu.utils, "enable_compile_cache", lambda: None)
    path, _ = librispeech_manifest(tmp_path / "audio")
    for mod, tag, extra in ((librispeech, "port", ["--device", "cpu", "--batch-size", "2",
                                                   "--max-chunk-seconds", "2"]),
                            (jax_ls, "jax", [])):
        mod.main(["--manifest", path, "--split", "train-tiny", "--hub", f"dir:{tmp_path / tag}",
                  "--progress-dir", str(tmp_path / f"prog_{tag}"), "--work-dir",
                  str(tmp_path / f"work_{tag}"), "--chunk-rows", "6", *extra])
    out = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert out[0]["report"]["processed"] == 2 and out[0]["report"]["failed"] == 0
    assert out[0]["engine"]["utterances"] == 5  # the corrupt file dropped
    got = hub_rows(tmp_path / "port")
    assert list(got) == ["data/train-tiny-00000-of-00002.parquet",
                         "data/train-tiny-00001-of-00002.parquet"]
    assert got == hub_rows(tmp_path / "jax")


# --- MLS ---------------------------------------------------------------------

def test_mls_ids_segments_and_documents_equal_jax():
    for text in ("Hello world", "  hello   WORLD ", "Ünïcode text ﬁ"):
        assert mls.canonicalize(text) == jax_mls.canonicalize(text)
        assert mls.text_to_id(text) == jax_mls.text_to_id(text)
        assert mls.text_to_id(text, bits=256) == jax_mls.text_to_id(text, bits=256)
    for args in (("spk1", "bookA", 1.5, 3.25, "Hello world"), (12, 345, 0.0, 19.99, "x")):
        assert mls.make_entry_id(*args) == jax_mls.make_entry_id(*args)
    entries = [{"entry_id": f"e{i}", "transcript": f" t{i} ", "audio_str": f"A{i} ",
                "begin_time": b, "end_time": e, "speaker_id": "s", "book_id": "b"}
               for i, (b, e) in enumerate([(0.0, 2.0), (2.1, 4.0), (9.0, 10.0), (10.2, 11.0),
                                           (11.5, 12.0)])]
    segs = mls.split_consecutive_chunks(entries)
    assert segs == jax_mls.split_consecutive_chunks(entries)
    assert [len(s) for s in segs] == [2, 2, 1]
    assert mls.split_consecutive_chunks([]) == []
    grouped = {"a.flac": entries, "b.flac": entries[:1], "c.flac": []}
    docs = mls.create_interleaved_documents(grouped)
    assert docs == jax_mls.create_interleaved_documents(grouped)
    assert [d["id"] for d in docs[:2]] == ["e0_seg0_type1", "e0_seg0_type2"]
    assert docs[-1]["id"] == "e0_type2"  # one segment: no suffix


def stage1_jsons(root):
    """Relative path -> the JSON of every stage-1 output under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): json.loads(p.read_text()) for p in sorted(root.rglob("*.json"))}


def test_mls_stage1_and_stage2_equal_jax(engines, tmp_path, monkeypatch):
    """16 kHz rows, half ``{'bytes': FLAC}`` and half ``{'array'}`` cells,
    read back from parquet; stage 1 with a progress save every 3 entries
    (each after a flush), then a resumed run that encodes nothing; then the
    batch lists and stage 2 to a hub, skipped on rerun."""
    jax_engine, engine = engines
    rows = mls_rows(np.random.default_rng(13), ["spk1", "spk2"], ["bk1", "bk2"], per_book=2,
                    seconds=(0.38, 0.42), gap_every=1)
    rows = parquet_utils.read_parquet(parquet_utils.write_parquet(rows, str(tmp_path / "in.parquet")))
    assert {r["audio"]["bytes"] is None for r in rows} == {True, False}  # both layouts
    for pkg, eng in ((mls, engine), (jax_mls, jax_engine)):
        tag = pkg.__name__.split(".")[0]
        prog = pkg.MLSStage1Processor("sh0", eng, str(tmp_path / tag / "s1"),
                                      str(tmp_path / tag / "prog"), progress_save_interval=3).run(rows)
        assert prog == {"processed_count": 8, "total_count": 8, "last_processed_index": 7}
    got = stage1_jsons(tmp_path / "tokenize_audio_tpu_torch" / "s1")
    assert len(got) == 8 and got == stage1_jsons(tmp_path / "tokenize_audio_tpu" / "s1")
    first = got[sorted(got)[0]]
    assert list(first) == ["entry_id", "original_path", "speaker_id", "book_id", "transcript",
                           "begin_time", "end_time", "audio_duration", "audio_str"]

    # resume: the progress ledger says done, and an entry whose JSON exists is not re-encoded
    def no_encode(items):
        raise AssertionError("re-encoded on resume")

    monkeypatch.setattr(engine, "encode_batch_mixed", no_encode)
    prog = mls.MLSStage1Processor("sh0", engine, str(tmp_path / "tokenize_audio_tpu_torch" / "s1"),
                                  str(tmp_path / "tokenize_audio_tpu_torch" / "prog")).run(rows)
    assert prog["last_processed_index"] == 7
    prog = mls.MLSStage1Processor("sh0", engine, str(tmp_path / "tokenize_audio_tpu_torch" / "s1"),
                                  str(tmp_path / "fresh_prog")).run(rows)
    assert prog["processed_count"] == 8
    monkeypatch.undo()

    for pkg, store in ((mls, LocalHub), (jax_mls, JaxLocalHub)):
        tag = pkg.__name__.split(".")[0]
        batches = pkg.create_batch_lists(str(tmp_path / tag / "s1"), speakers_per_batch=1)
        assert batches == [[("spk1", "bk1"), ("spk1", "bk2")], [("spk2", "bk1"), ("spk2", "bk2")]]
        hub = store(str(tmp_path / tag / "hub"))
        for i, batch in enumerate(batches):
            rep = pkg.merge_batch(str(tmp_path / tag / "s1"), batch, f"batch_{i:03d}", hub,
                                  str(tmp_path / tag / "w2"))
            assert rep == {"batch": f"batch_{i:03d}", "status": "processed", "entries": 4,
                           "docs": 8}
        assert pkg.merge_batch(str(tmp_path / tag / "s1"), batches[0], "batch_000", hub,
                               str(tmp_path / tag / "w2"))["status"] == "skipped"
    got = hub_rows(tmp_path / "tokenize_audio_tpu_torch" / "hub")
    want = hub_rows(tmp_path / "tokenize_audio_tpu" / "hub")
    assert list(got) == ["data/batch_000.parquet", "data/batch_001.parquet"]
    for path in want:
        same_rows(got[path], want[path])


# the tiny config's widths as the port's MimiConfig, for a child process
# that imports nothing of the JAX package
TINY_KW = dict(num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
               num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
               codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
               upsample_groups=32)

_MLS_CHILD = r"""
import dataclasses, json, sys
from tokenize_audio_tpu_torch import cli
from tokenize_audio_tpu_torch.datasets import mls
from tokenize_audio_tpu_torch.mimi.config import MimiConfig
tiny = MimiConfig(**%r)
cli.MimiConfig = lambda **kw: dataclasses.replace(tiny, **kw)
mls.main(sys.argv[1:])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tokenize_audio_tpu"))
print(json.dumps({"bad": bad}))
"""


def test_mls_stage1_cli_imports_no_jax(tmp_path):
    """Stage 1 through ``main`` in a fresh process, with ``--device cpu``:
    it decodes ``{'bytes'}`` cells with the port's own parquet_corpus
    decoder and, after the run, no JAX or JAX-package module is loaded."""
    rows = mls_rows(np.random.default_rng(17), ["spk9"], ["bk9"], per_book=2,
                    seconds=(0.3, 0.35))
    parquet_utils.write_parquet(rows, str(tmp_path / "in.parquet"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _MLS_CHILD % (TINY_KW,), "stage1", "--shard-id", "sh9",
         "--parquet", str(tmp_path / "in.parquet"), "--output-dir", str(tmp_path / "s1"),
         "--progress-dir", str(tmp_path / "prog"), "--device", "cpu", "--batch-size", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    report, tail = (json.loads(ln) for ln in out.stdout.strip().splitlines()[-2:])
    assert report["processed_count"] == 2 and tail == {"bad": []}
    assert len(stage1_jsons(tmp_path / "s1" / "spk9" / "bk9")) == 2


# --- Emilia ------------------------------------------------------------------

def test_emilia_grouping_and_build_rows_equal_jax():
    assert emilia.speaker_document_id("EN_B00000_S00040_W000004") == "EN_B00000_S00040"
    uids = ["EN_B0_S1_W000", "EN_B0_S1_W001", "EN_B0_S2_W000"]
    assert emilia.group_documents(uids) == jax_emilia.group_documents(uids)
    utts = {uid: {"audio_str": f"A{i} ", "transcript": f" t{i} ", "speaker": f"SPEAKER_0{3 - i}"}
            for i, uid in enumerate(uids)}
    for conv in (False, True):
        got = emilia.build_rows(utts, "Emilia", "EN_B0", conversational=conv)
        assert got == jax_emilia.build_rows(utts, "Emilia", "EN_B0", conversational=conv)
    assert got[0]["speaker_ids"] == [0, 1] and got[0]["speaker_count"] == 2
    bad = {"X_W0": {"audio_str": "A", "transcript": "t", "speaker": "bob"}}
    with pytest.raises(ValueError, match="SPEAKER_"):
        emilia.build_rows(bad, "s", "x", conversational=True)


EMILIA_SHARD = "EN_B00000"


def emilia_members(rng):
    """Two speakers x 3 utterances of ~0.4 s: 24 kHz WAV, one 24 kHz FLAC and
    one 16 kHz WAV (resampled by ``prepare_audio`` in a worker thread);
    speaker 1 turns alternate between two diarized labels, and one member of
    speaker 2 is labelled ``bob``. Plus a corrupt member."""
    members = []
    for spk in (1, 2):
        for w in range(3):
            uid = f"{EMILIA_SHARD}_S{spk:05d}_W{w:06d}"
            sr, container = ((16_000, "wav") if (spk, w) == (2, 1) else
                             (24_000, "flac") if (spk, w) == (1, 2) else (24_000, "wav"))
            speaker = "bob" if (spk, w) == (2, 2) else f"SPEAKER_{spk * 10 + w % 2:02d}"
            members.append((f"{uid}.{container}",
                            container_bytes(tone_pcm(rng, 0.4, sr), sr, container),
                            {"text": f" utt {spk}-{w} ", "speaker": speaker}))
    members.append((f"{EMILIA_SHARD}_S00003_W000000.wav", CORRUPT, {"text": "x",
                                                                   "speaker": "SPEAKER_00"}))
    return members


def emilia_run(pkg, store, eng, tmp, conversational=False, cache=None):
    """One shard through ``pkg``'s processor (its own source and target hub
    and work directory under ``tmp``); ``cache`` pre-seeds the audio_str
    cache file. Returns the report, the rows read back and the processor."""
    tmp.mkdir(parents=True, exist_ok=True)
    tar = write_emilia_tar(str(tmp / f"{EMILIA_SHARD}.tar"), EMILIA_SHARD,
                           emilia_members(np.random.default_rng(19)))
    src = store(str(tmp / "src"))
    src.upload_file(tar, f"Emilia/EN/{EMILIA_SHARD}.tar")
    proc = pkg.EmiliaShardProcessor("Emilia", "EN", EMILIA_SHARD, src, store(str(tmp / "dst")),
                                    eng, str(tmp / "work"), conversational=conversational)
    if cache is not None:
        with open(proc.cache_path, "w") as f:
            f.write(cache)
    rep = proc.process()
    rows = parquet_utils.read_parquet(str(tmp / "dst" / "Emilia" / "EN" / f"{EMILIA_SHARD}.parquet"))
    return rep, rows, proc


@pytest.mark.parametrize("conversational", [False, True], ids=["standard", "conversational"])
def test_emilia_shard_equal_jax_then_skip(engines, tmp_path, monkeypatch, conversational):
    """Rows equal JAX's; the corrupt member fails alone (and, in the
    conversational variant, the ``bob`` one); the 16 kHz member is
    resampled in a prefetch worker thread; a rerun skips."""
    jax_engine, engine = engines
    seen = []
    real = engine.prepare_audio

    def spy(audio, sr):
        seen.append((sr, threading.current_thread() is threading.main_thread()))
        return real(audio, sr)

    monkeypatch.setattr(engine, "prepare_audio", spy)
    rep, got, proc = emilia_run(emilia, LocalHub, engine, tmp_path / "port", conversational)
    jrep, want, _ = emilia_run(jax_emilia, JaxLocalHub, jax_engine, tmp_path / "jax",
                               conversational)
    assert rep == jrep
    failed = ([f"{EMILIA_SHARD}_S00002_W000002"] if conversational else []) + [
        f"{EMILIA_SHARD}_S00003_W000000"]
    assert rep["status"] == "processed" and rep["failed_files"] == failed
    same_rows(got, want)
    if conversational:
        assert [r["id"] for r in got] == [f"{EMILIA_SHARD}_S00001", f"{EMILIA_SHARD}_S00002"]
        assert got[0]["speaker_ids"].tolist() == [0, 1, 0] and got[0]["speaker_count"] == 2
        assert "<|text_start|>[1]utt 1-1<|text_end|>" in got[0]["text"]
    else:
        assert [r["id"] for r in got] == [f"{EMILIA_SHARD}_S0000{s}_type{t}"
                                          for s in (1, 2) for t in (1, 2)]
        assert got[2]["text"].count("<|audio_start|>") == 3
    assert sorted(seen) == [(16_000, False)] + [(24_000, False)] * (5 if not conversational else 4)
    assert not os.path.exists(proc.cache_path) and not os.path.exists(
        os.path.join(proc.work_dir, "extracted"))
    assert proc.process() == {"shard": EMILIA_SHARD, "status": "skipped"}


@pytest.mark.parametrize("layout", ["jsonl", "legacy_dict", "unlabelled_conversational"])
def test_emilia_cache_resume_keeps_uid_order(engines, tmp_path, layout):
    """A cache holding a later utterance (appended before an earlier one is
    encoded) is not re-encoded, and the document keeps sorted-uid order, in
    the JSONL format and in the older full-dict one (migrated); in the
    conversational variant a cached entry without a diarized label is
    dropped and reported failed."""
    jax_engine, engine = engines
    uid = f"{EMILIA_SHARD}_S00001_W000001"
    conv = layout == "unlabelled_conversational"
    entry = {"audio_str": "LATER", "transcript": "second", "speaker": "" if conv else "SPEAKER_11"}
    cache = (json.dumps({uid: entry}) if layout == "legacy_dict"
             else json.dumps({"uid": uid, **entry}) + "\n")
    rep, got, _ = emilia_run(emilia, LocalHub, engine, tmp_path / "port", conv, cache)
    jrep, want, _ = emilia_run(jax_emilia, JaxLocalHub, jax_engine, tmp_path / "jax", conv, cache)
    assert rep == jrep
    same_rows(got, want)
    doc = got[0]["text"]
    if conv:
        assert uid in rep["failed_files"] and "second" not in doc
    else:
        assert "LATER" in doc and doc.index("utt 1-0") < doc.index("second") < doc.index("utt 1-2")
