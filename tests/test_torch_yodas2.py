"""PyTorch port, YODAS2: the shard processor and its CLI against the JAX
package's on one synthetic mirror (tiny config, the same params, the port on
the CPU): the uploaded hub JSON must be byte-identical. Also resume from a
``.partial`` file, the failed-entry upload gate, the back-pressure repair,
the sources, and the chunk helpers."""

import dataclasses
import http.server
import json
import os
import shutil
import tarfile
import threading

import numpy as np
import pytest

from tests.mimi_fixtures import make_oracle, tiny_hf_config
from torch_yodas2_mirror import Entry, noise_pcm, write_mirror
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.datasets import yodas2 as jax_yodas2
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu.hub import LocalHub as JaxLocalHub
from tokenize_audio_tpu_torch import cli
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.datasets import yodas2
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import LocalHub
from tokenize_audio_tpu_torch.mimi.weights import config_from_hf

SR = 24_000
SHARD = "en000"
ENGINE_KW = dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)
# (container, sample rate, seconds) of each sub-shard's entries
ENTRIES = [("wav", 24_000, 3.0), ("flac", 24_000, 2.5), ("wav", 16_000, 3.5)]


@pytest.fixture(scope="module")
def oracle():
    model, params, jcfg = make_oracle(tiny_hf_config())
    return params, jcfg, config_from_hf(model.config)


def port_engine(oracle):
    params, _, cfg = oracle
    return MimiEncoderEngine(params, cfg, EngineConfig(**ENGINE_KW), num_codebooks=12,
                             device="cpu")


def build_mirror(root, seed=0, subshards=2):
    """Each sub-shard holds a 24 kHz WAV, a 24 kHz FLAC and a 16 kHz WAV
    entry; each entry a 1 s chunk, a degenerate start == end chunk and a
    2.5 s chunk over the engine's 2 s cap."""
    rng = np.random.default_rng(seed)
    chunks = [(0, 100), (100, 100), (50, 300)]
    return write_mirror(root, SHARD, [
        [Entry(f"vid-{s:08d}-{a}", noise_pcm(rng, int(sr * seconds)), sr, kind, chunks)
         for a, (kind, sr, seconds) in enumerate(ENTRIES)]
        for s in range(subshards)
    ])


def hub_bytes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def jax_run(oracle, tmp_path_factory):
    """The JAX processor's hub output and report on the mirror."""
    params, jcfg, _ = oracle
    tmp = tmp_path_factory.mktemp("jax_yodas2")
    root = build_mirror(str(tmp / "mirror"))
    engine = JaxEngine(params, jcfg, JaxEngineConfig(**ENGINE_KW), num_codebooks=12)
    report = jax_yodas2.Yodas2ShardProcessor(
        SHARD, jax_yodas2.LocalSource(root), JaxLocalHub(str(tmp / "hub")), engine,
        str(tmp / "work"), str(tmp / "prog"), max_consecutive_missing=2,
    ).process()
    return report, hub_bytes(str(tmp / "hub"))


@pytest.fixture
def decoded(monkeypatch):
    """The audio ids the port's processor decodes, in order."""
    ids = []
    real = yodas2.SubShardProcessor._load_entry_audio

    def counting(self, entry, extract_dir):
        ids.append(entry["audio_id"])
        return real(self, entry, extract_dir)

    monkeypatch.setattr(yodas2.SubShardProcessor, "_load_entry_audio", counting)
    return ids


def same_entries(got: bytes, want: bytes) -> bool:
    """A resumed entry keeps ``json.dumps``' spacing (as in the JAX
    package), so an output with resumed entries parses to the JAX bytes
    instead of matching them."""
    return json.loads(got) == json.loads(want)


def port_processor(tmp_path, root, engine, **kw):
    kw.setdefault("max_consecutive_missing", 2)
    return yodas2.Yodas2ShardProcessor(
        SHARD, yodas2.LocalSource(root), LocalHub(str(tmp_path / "hub")), engine,
        str(tmp_path / "work"), str(tmp_path / "prog"), **kw,
    )


def test_hub_json_byte_identical_to_jax(oracle, jax_run, tmp_path):
    want_report, want = jax_run
    assert want_report == {"processed": 2, "skipped": 0, "missing": 2, "failed": 0,
                           "uploaded": 2}
    root = build_mirror(str(tmp_path / "mirror"))
    engine = port_engine(oracle)
    report = port_processor(tmp_path, root, engine).process()
    assert report == want_report
    got = hub_bytes(str(tmp_path / "hub"))
    assert sorted(got) == [f"data/{SHARD}/0000000{i}.json" for i in range(2)]
    for path in got:
        assert got[path] == want[path], path
    entries = json.loads(got[f"data/{SHARD}/00000000.json"])
    assert [len(e["codes"]) for e in entries] == [2, 2, 2]  # degenerate chunk skipped
    long_codes = np.array(entries[2]["codes"]["vid-00000000-2-00002-00000050-00000300"])
    assert long_codes.shape == (12, -(-int(2.5 * SR) // 1920))  # split at 2 s, concatenated
    assert engine.stats.stage_seconds["host_decode"] > 0
    assert engine.stats.stage_seconds["hub_upload"] > 0


def test_resume_from_partial(oracle, jax_run, tmp_path, decoded):
    """A crash after the first saved group leaves a .partial file that is
    never uploaded; the rerun resumes from it and uploads the JAX bytes."""
    root = build_mirror(str(tmp_path / "mirror"), subshards=1)
    engine = port_engine(oracle)
    real, calls = engine.encode_batch, []

    def crashing(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            raise RuntimeError("simulated crash mid-sub-shard")
        return real(*a, **k)

    engine.encode_batch = crashing
    rep = port_processor(tmp_path, root, engine, max_subshards=1, save_every=1).process()
    assert rep["failed"] == 1 and rep["uploaded"] == 0
    work = tmp_path / "work" / SHARD
    partial = work / "00000000.out.json.partial"
    assert len(partial.read_text().splitlines()) == 1
    assert not (work / "00000000.out.json").exists()
    assert LocalHub(str(tmp_path / "hub")).list_files("data/") == []

    decoded.clear()
    rep = port_processor(tmp_path, root, port_engine(oracle), max_subshards=1,
                         save_every=1).process()
    assert rep["processed"] == 1 and rep["uploaded"] == 1
    assert decoded == ["vid-00000000-1", "vid-00000000-2"]  # the first came from the partial
    path = f"data/{SHARD}/00000000.json"
    assert same_entries(hub_bytes(str(tmp_path / "hub"))[path], jax_run[1][path])


def test_failed_entry_blocks_upload_then_retry(oracle, jax_run, tmp_path, decoded):
    """An entry that cannot be decoded keeps its sub-shard off the hub (the
    output stays local as the resume set); once the source is repaired the
    retry decodes only that entry and uploads the JAX bytes."""
    root = build_mirror(str(tmp_path / "mirror"), subshards=1)
    tar_path = os.path.join(root, SHARD, "00000000.tar.gz")
    shutil.move(tar_path, str(tmp_path / "good.tar.gz"))
    bad_dir = tmp_path / "bad" / "audio"
    shutil.copytree(os.path.join(root, "_build_00000000", "audio"), bad_dir)
    (bad_dir / "vid-00000000-1.flac").write_bytes(b"fLaC broken")
    with tarfile.open(tar_path, "w:gz") as tf:
        tf.add(bad_dir, arcname="audio")

    rep = port_processor(tmp_path, root, port_engine(oracle), max_subshards=1).process()
    assert rep["failed"] == 1 and rep["uploaded"] == 0
    assert LocalHub(str(tmp_path / "hub")).list_files("data/") == []
    out = tmp_path / "work" / SHARD / "00000000.out.json"
    assert [("codes" in e) for e in json.loads(out.read_text())] == [True, False, True]

    shutil.copyfile(str(tmp_path / "good.tar.gz"), tar_path)
    decoded.clear()
    rep = port_processor(tmp_path, root, port_engine(oracle), max_subshards=1).process()
    assert rep["processed"] == 1 and rep["uploaded"] == 1 and rep["failed"] == 0
    assert decoded == ["vid-00000000-1"]
    path = f"data/{SHARD}/00000000.json"
    assert same_entries(hub_bytes(str(tmp_path / "hub"))[path], jax_run[1][path])


def test_writer_failure_stays_with_its_subshard(oracle, tmp_path, monkeypatch):
    """A write-behind failure of sub-shard 0 fails sub-shard 0 at its own
    complete(); sub-shard 1, whose first dispatch waits for back-pressure on
    sub-shard 0's three queued groups, is still processed and uploaded."""
    root = build_mirror(str(tmp_path / "mirror"))
    real_append = yodas2.append_jsonl_lines
    real_dispatch = yodas2.SubShardProcessor.process_entries_deferred
    second_dispatched = threading.Event()

    def dispatch(self, batch):
        if any(e["audio_id"].startswith("vid-00000001") for e, _ in batch):
            second_dispatched.set()
        return real_dispatch(self, batch)

    def failing_append(path, lines):
        if "00000000.out.json" in path:
            # hold sub-shard 0's groups in the queue until sub-shard 1 has
            # dispatched (or the back-pressure wait has given up on them)
            second_dispatched.wait(timeout=2.0)
            raise OSError("disk full")
        real_append(path, lines)

    monkeypatch.setattr(yodas2, "append_jsonl_lines", failing_append)
    monkeypatch.setattr(yodas2.SubShardProcessor, "process_entries_deferred", dispatch)
    proc = port_processor(tmp_path, root, port_engine(oracle), save_every=1)
    rep = proc.process()
    assert rep["failed"] == 1 and rep["processed"] == 1 and rep["uploaded"] == 1
    assert proc.progress.failed == ["00000000"]
    assert LocalHub(str(tmp_path / "hub")).list_files("data/") == [
        f"data/{SHARD}/00000001.json"]


def test_main_cli_on_cpu(oracle, jax_run, tmp_path, monkeypatch, capsys):
    """``main(argv)`` with --device cpu and a dir: source and hub (the tiny
    config and the oracle's params in place of the full-width random ones)."""
    params, _, cfg = oracle
    monkeypatch.setattr(cli, "MimiConfig", lambda **kw: dataclasses.replace(cfg, **kw))
    monkeypatch.setattr(cli, "random_params", lambda c: params)
    monkeypatch.setattr(yodas2, "MimiConfig", lambda: cfg)
    root = build_mirror(str(tmp_path / "mirror"))
    report = yodas2.main([
        "--shard-id", SHARD, "--source", f"dir:{root}", "--hub", f"dir:{tmp_path / 'hub'}",
        "--progress-dir", str(tmp_path / "prog"), "--work-dir", str(tmp_path / "work"),
        "--device", "cpu", "--batch-size", "4", "--max-chunk-seconds", "2",
    ])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == report
    assert report["processed"] == 2 and report["uploaded"] == 2 and report["failed"] == 0
    assert hub_bytes(str(tmp_path / "hub")) == jax_run[1]
    progress = json.loads((tmp_path / "prog" / f"{SHARD}_progress.json").read_text())
    assert progress["completed"] == ["00000000", "00000001"] and progress["meta"]["done"]


def test_hub_source_and_scan_of_local_outputs(oracle, jax_run, tmp_path):
    """A mirror served by a hub (HubSource); a finished output that never
    uploaded is queued by the startup scan instead of being re-encoded."""
    root = build_mirror(str(tmp_path / "mirror"))
    src_hub = LocalHub(str(tmp_path / "src"))
    for s in range(2):
        for ext in (".tar.gz", ".json"):
            src_hub.upload_file(os.path.join(root, SHARD, f"0000000{s}{ext}"),
                                f"yodas2/{SHARD}/0000000{s}{ext}")
    source = yodas2.HubSource(src_hub, prefix="yodas2/")
    assert source.available(SHARD, "00000001") and not source.available(SHARD, "00000002")
    work = tmp_path / "work" / SHARD
    work.mkdir(parents=True)
    done = jax_run[1][f"data/{SHARD}/00000000.json"]
    (work / "00000000.out.json").write_bytes(done)
    proc = yodas2.Yodas2ShardProcessor(
        SHARD, source, LocalHub(str(tmp_path / "hub")), port_engine(oracle),
        str(tmp_path / "work"), str(tmp_path / "prog"), max_consecutive_missing=2,
    )
    rep = proc.process()
    assert rep == {"processed": 1, "skipped": 1, "missing": 2, "failed": 0, "uploaded": 2}
    assert hub_bytes(str(tmp_path / "hub")) == jax_run[1]


def test_url_source_head_and_stream(tmp_path):
    """UrlSource HEAD-checks and streams tar + json from a loopback server."""
    www = tmp_path / "www" / SHARD
    www.mkdir(parents=True)
    (www / "00000000.tar.gz").write_bytes(b"TARBYTES")
    (www / "00000000.json").write_bytes(b"[]")
    handler = lambda *a, **k: http.server.SimpleHTTPRequestHandler(  # noqa: E731
        *a, directory=str(tmp_path / "www"), **k)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        src = yodas2.UrlSource(f"http://127.0.0.1:{srv.server_address[1]}",
                               max_retries=2, base_delay=0.01)
        assert src.available(SHARD, "00000000") is True
        assert src.available(SHARD, "00000001") is False
        tar, txt = src.fetch(SHARD, "00000000", str(tmp_path / "dl"))
        assert open(tar, "rb").read() == b"TARBYTES" and open(txt, "rb").read() == b"[]"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


@pytest.mark.parametrize("chunk_id", [
    "vid-ab-00001-00000100-00000250", "v-00000-00000050-00000050", "bad",
    "v-00000-00000200-00000100",
])
def test_parse_chunk_id_equals_jax(chunk_id):
    def run(fn):
        try:
            return fn(chunk_id)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(yodas2.parse_chunk_id) == run(jax_yodas2.parse_chunk_id)


def test_chunk_helpers_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    audio = (rng.standard_normal(SR * 3) * 6000).astype(np.int16)
    text = {"a-00000-00000000-00000100": "x", "a-00001-00000100-00000100": "degenerate",
            "a-00002-00000033-00000299": "y", "a-00003-00027000-00029000": "past the end"}
    ids, segs = yodas2.slice_chunks(audio, text, SR)
    want_ids, want_segs = jax_yodas2.slice_chunks(audio, text, SR)
    assert ids == want_ids == ["a-00000-00000000-00000100", "a-00002-00000033-00000299"]
    for s, w in zip(segs, want_segs):
        np.testing.assert_array_equal(s, w)
    entry = {"audio_id": "a", "text": text, "codes": {
        ids[0]: rng.integers(0, 2048, (12, 13), dtype=np.uint16),
        "empty": np.zeros((12, 0), dtype=np.uint16)}}
    for e in (entry, {"audio_id": "b"}, {"codes": {}}):
        assert yodas2._entry_to_json(e) == jax_yodas2._entry_to_json(e)
    for name, data in (("full", [{"codes": {}}]), ("missing", [{"codes": {}}, {"a": 1}]),
                       ("empty", []), ("dict", {"codes": {}})):
        path = str(tmp_path / f"{name}.json")
        with open(path, "w") as f:
            json.dump(data, f)
        assert yodas2.is_json_complete(path) == jax_yodas2.is_json_complete(path)
    assert yodas2.is_json_complete(str(tmp_path / "absent.json")) is False
