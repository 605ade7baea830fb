"""PyTorch port, hub and runner: LocalHub, open_hub, crash-safe progress
(atomic writes, the torn JSONL tail), ShardRunner resume, HFHub against a
mocked HfApi, and the network retry helpers; progress files and JSONL
written by the port read back the same in the JAX package and the other way
round, so a shard started by one resumes in the other."""

import json
import os
import sys
import types

import pytest

from tokenize_audio_tpu import runner as jax_runner
from tokenize_audio_tpu_torch.hub import LocalHub, open_hub
from tokenize_audio_tpu_torch.hub import hf as hf_mod
from tokenize_audio_tpu_torch.net import retry_with_backoff, stream_to_file
from tokenize_audio_tpu_torch.runner import (
    ShardProgress,
    ShardRunner,
    WorkUnit,
    append_jsonl,
    atomic_write_json,
    atomic_write_text,
    read_json,
    read_jsonl,
)
from tokenize_audio_tpu_torch import runner as port_runner


def _write(tmp_path, name, content="x"):
    p = tmp_path / name
    p.write_text(content)
    return str(p)


def test_local_hub_roundtrip(tmp_path):
    hub = LocalHub(str(tmp_path / "hub"))
    src = _write(tmp_path, "a.txt", "hello")
    assert not hub.exists("data/a.txt")
    hub.upload_batch([(src, "data/a.txt"), (src, "data/sub/b.txt")])
    assert hub.exists("data/a.txt")
    assert hub.list_files("data/") == ["data/a.txt", "data/sub/b.txt"]
    dst = str(tmp_path / "back" / "a.txt")
    hub.download("data/a.txt", dst)
    assert open(dst).read() == "hello"
    assert hub.size("data/a.txt") == 5 and hub.read_range("data/a.txt", 1, 3) == b"ell"
    hub.upload_and_delete(src, "data/c.txt")
    assert hub.exists("data/c.txt") and not os.path.exists(src)
    for bad in ("../outside", "data/../../x"):
        with pytest.raises(ValueError, match="escapes"):
            hub.exists(bad)
    # a sibling directory sharing the root's prefix is outside too
    with pytest.raises(ValueError, match="escapes"):
        hub.exists(f"../{os.path.basename(hub.root)}2/x")


def test_open_hub_spec(tmp_path, monkeypatch):
    assert isinstance(open_hub(str(tmp_path / "h")), LocalHub)
    h2 = open_hub(f"dir:{tmp_path}/h2")
    assert isinstance(h2, LocalHub) and h2.root == str(tmp_path / "h2")
    mod = types.ModuleType("huggingface_hub")
    mod.HfApi = lambda token=None: "api"
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    hf = open_hub("hf:org/repo")
    assert isinstance(hf, hf_mod.HFHub) and hf.repo_id == "org/repo" and hf.api == "api"


def test_atomic_write_and_torn_read(tmp_path):
    p = str(tmp_path / "d" / "x.json")
    atomic_write_json(p, {"a": 1})
    assert read_json(p) == {"a": 1}
    atomic_write_text(p, '{"b": 2}')
    assert read_json(p) == {"b": 2}
    assert [f for f in os.listdir(tmp_path / "d")] == ["x.json"]  # no temp left
    with open(p, "w") as f:
        f.write('{"a": 1')  # torn write
    assert read_json(p, default={}) == {}
    assert read_json(str(tmp_path / "missing.json"), default=5) == 5


def test_append_jsonl_and_torn_tail(tmp_path):
    p = str(tmp_path / "x.jsonl")
    assert read_jsonl(p) is None
    append_jsonl(p, [{"id": 1}, {"id": 2}])
    append_jsonl(p, [])
    append_jsonl(p, [{"id": 3}])
    assert read_jsonl(p) == [{"id": 1}, {"id": 2}, {"id": 3}]
    with open(p, "a") as f:
        f.write('{"id": 4')  # crash mid-append: torn last line
    assert read_jsonl(p) == [{"id": 1}, {"id": 2}, {"id": 3}]
    append_jsonl(p, [{"id": 5}])  # heals the tail into its own dropped line
    assert read_jsonl(p) == [{"id": 1}, {"id": 2}, {"id": 3}, {"id": 5}]


@pytest.mark.parametrize("writer,reader", [(port_runner, jax_runner), (jax_runner, port_runner)])
def test_progress_and_jsonl_cross_package(tmp_path, writer, reader):
    """A progress ledger or partial written by one package resumes in the
    other: same file names, same fields, same torn-tail handling."""
    prog = writer.ShardProgress(str(tmp_path), "en001")
    prog.mark_failed("u1")
    prog.mark_completed("u2")
    prog.meta["done"] = False
    prog.save()
    back = reader.ShardProgress(str(tmp_path), "en001")
    assert back.failed == ["u1"] and back.completed == ["u2"] and back.meta == {"done": False}
    p = str(tmp_path / "x.jsonl")
    writer.append_jsonl(p, [{"id": 1}])
    with open(p, "a") as f:
        f.write('{"id": 2')
    reader.append_jsonl(p, [{"id": 3}])
    assert writer.read_jsonl(p) == reader.read_jsonl(p) == [{"id": 1}, {"id": 3}]


def test_progress_ledger(tmp_path):
    prog = ShardProgress(str(tmp_path), "en001")
    prog.mark_failed("u1")
    prog.mark_completed("u2")
    prog2 = ShardProgress(str(tmp_path), "en001")
    assert prog2.failed == ["u1"] and prog2.is_completed("u2")
    prog2.mark_completed("u1")  # retry succeeded
    prog2.mark_failed("u2")  # a completed unit never turns failed
    prog3 = ShardProgress(str(tmp_path), "en001")
    assert prog3.failed == [] and set(prog3.completed) == {"u1", "u2"}
    with open(prog3.path, "w") as f:
        f.write("{")  # torn ledger: restart from nothing rather than crash
    assert ShardProgress(str(tmp_path), "en001").completed == []


def test_runner_end_to_end_and_idempotent_rerun(tmp_path):
    hub = LocalHub(str(tmp_path / "hub"))
    calls = []

    def process(unit):
        calls.append(unit.unit_id)
        local = _write(tmp_path, f"{unit.unit_id}.json", json.dumps({"id": unit.unit_id}))
        return [(local, f"data/{unit.unit_id}.json")]

    units = [WorkUnit(f"u{i}", done_markers=(f"data/u{i}.json",)) for i in range(5)]
    rep = ShardRunner("s0", hub, str(tmp_path / "prog"), process, upload_batch_size=2).run(units)
    assert (rep.processed, rep.skipped, rep.uploaded_files) == (5, 0, 5)
    assert hub.list_files("data/") == [f"data/u{i}.json" for i in range(5)]
    assert not os.path.exists(str(tmp_path / "u0.json"))  # deleted after upload
    assert read_json(str(tmp_path / "prog" / "s0_progress.json"))["meta"] == {"done": True}
    calls.clear()
    rep2 = ShardRunner("s0", hub, str(tmp_path / "prog"), process).run(units)
    assert rep2.skipped == 5 and rep2.processed == 0 and calls == []


@pytest.mark.parametrize("locally_failed", [False, True])
def test_runner_adopts_hub_state(tmp_path, locally_failed):
    """Artifacts already on the hub make a unit complete, even when the
    local ledger has it failed (a crash between upload and mark)."""
    hub = LocalHub(str(tmp_path / "hub"))
    hub.upload_file(_write(tmp_path, "pre.json"), "data/u0.json")
    prog_dir = str(tmp_path / "prog")
    if locally_failed:
        ShardProgress(prog_dir, "s0").mark_failed("u0")

    def process(unit):
        raise AssertionError("must not process a hub-complete unit")

    runner = ShardRunner("s0", hub, prog_dir, process)
    rep = runner.run([WorkUnit("u0", done_markers=("data/u0.json",))])
    assert rep.skipped == 1 and rep.failed == 0
    assert runner.progress.is_completed("u0")


def test_runner_failure_isolation_and_resume(tmp_path):
    hub = LocalHub(str(tmp_path / "hub"))
    attempts = {"u1": 0}

    def process(unit):
        if unit.unit_id == "u1":
            attempts["u1"] += 1
            if attempts["u1"] == 1:
                raise RuntimeError("boom")
        return [(_write(tmp_path, f"{unit.unit_id}.out", "ok"), f"data/{unit.unit_id}.out")]

    units = [WorkUnit(f"u{i}", done_markers=(f"data/u{i}.out",)) for i in range(3)]
    runner = ShardRunner("s1", hub, str(tmp_path / "prog"), process)
    rep = runner.run(units)
    assert rep.failed == 1 and rep.processed == 2
    assert "done" not in runner.progress.meta
    rep2 = ShardRunner("s1", hub, str(tmp_path / "prog"), process).run(units)
    assert rep2.processed == 1 and rep2.skipped == 2 and hub.exists("data/u1.out")


def test_runner_aborts_on_consecutive_failures(tmp_path):
    def process(unit):
        raise RuntimeError("always")

    runner = ShardRunner("s2", LocalHub(str(tmp_path / "hub")), str(tmp_path / "prog"),
                         process, max_consecutive_failures=3)
    with pytest.raises(RuntimeError, match="consecutive"):
        runner.run([WorkUnit(f"u{i}") for i in range(10)])
    assert runner.progress.failed == ["u0", "u1", "u2"]


# -- HFHub against a mocked HfApi --------------------------------------------


class FakeApi:
    token = None

    def __init__(self):
        self.fail_times = 0
        self.calls = []
        self.files = set()

    def _maybe_fail(self, what):
        self.calls.append(what)
        if self.fail_times > 0:
            self.fail_times -= 1
            raise RuntimeError("409 conflict")

    def file_exists(self, repo_id, path, repo_type=None):
        self._maybe_fail(("exists", path))
        return path in self.files

    def upload_file(self, path_or_fileobj=None, path_in_repo=None, repo_id=None, repo_type=None):
        self._maybe_fail(("upload", path_in_repo))
        self.files.add(path_in_repo)

    def create_commit(self, repo_id=None, repo_type=None, operations=None, commit_message=None):
        self._maybe_fail(("commit", len(operations)))
        for op in operations:
            self.files.add(op.path_in_repo)

    def list_repo_files(self, repo_id, repo_type=None):
        self._maybe_fail(("list",))
        return sorted(self.files)


class FakeResp:
    status_code = 206
    content = b"abcd"

    def raise_for_status(self):
        pass

    def iter_content(self, n):
        yield b"PAY"
        yield b"LOAD"

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.fixture
def hub(monkeypatch):
    fake = FakeApi()
    h = hf_mod.HFHub.__new__(hf_mod.HFHub)
    h.repo_id, h.repo_type, h.api = "me/test", "dataset", fake
    h.max_retries, h.base_delay = 3, 0.0
    h._exists_cache, h._http_session = {}, None
    mod = types.ModuleType("huggingface_hub")

    class Op:
        def __init__(self, path_in_repo=None, path_or_fileobj=None):
            self.path_in_repo = path_in_repo

    mod.CommitOperationAdd = Op
    mod.hf_hub_url = lambda repo, path, repo_type=None: f"https://hub.invalid/{path}"
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    return h, fake, mod


def test_hf_exists_cache_and_upload_invalidation(hub):
    h, fake, _ = hub
    h.upload_file("/x", "data/a.json")
    n = len(fake.calls)
    assert h.exists("data/a.json") is True and h.exists("data/a.json") is True
    assert len(fake.calls) == n + 1  # the first exists after an upload asks the hub
    assert h.exists("data/b.json") is False and h.exists("data/b.json") is False
    assert fake.calls.count(("exists", "data/b.json")) == 1  # negatives cache too
    h.upload_batch([("/1", "data/b.json"), ("/2", "data/c.json")])
    assert ("commit", 2) in fake.calls and h.exists("data/b.json") is True
    h.clear_exists_cache()
    n = len(fake.calls)
    assert h.exists("data/b.json") is True and len(fake.calls) == n + 1
    assert h.list_files("data/") == ["data/a.json", "data/b.json", "data/c.json"]


@pytest.mark.parametrize("fail_times,ok", [(2, True), (99, False)])
def test_hf_retries_transient_failures(hub, fail_times, ok):
    h, fake, _ = hub
    fake.fail_times = fail_times
    if ok:
        h.upload_file("/x", "data/c.json")
        assert fake.calls.count(("upload", "data/c.json")) == 3
    else:
        with pytest.raises(RuntimeError, match="409"):
            h.upload_file("/x", "data/c.json")
        assert fake.calls.count(("upload", "data/c.json")) == 3


def test_hf_download_falls_back_to_resolve_url(hub, tmp_path, monkeypatch):
    h, _, mod = hub
    h.max_retries = 1

    def api_down(**kw):
        raise RuntimeError("api down")

    mod.hf_hub_download = api_down
    fetched = []

    class Session:
        def get(self, url, **kw):
            fetched.append(url)
            return FakeResp()

    monkeypatch.setattr(hf_mod.HFHub, "_session", lambda self: Session())
    out = str(tmp_path / "out.bin")
    assert h.download("data/a.parquet", out) == out
    assert fetched == ["https://hub.invalid/data/a.parquet"]
    assert open(out, "rb").read() == b"PAYLOAD"
    assert os.listdir(tmp_path) == ["out.bin"]  # no temp or download dir left


def test_hf_read_range_and_size(hub, monkeypatch):
    h, _, _ = hub
    seen = {}

    class Full(FakeResp):
        status_code = 200
        content = bytes(range(200))

    class Session:
        def get(self, url, headers=None, **kw):
            seen["range"] = headers["Range"]
            return FakeResp() if seen.get("honour", True) else Full()

        def head(self, url, **kw):
            r = FakeResp()
            r.headers = {"Content-Length": "1234"}
            return r

    monkeypatch.setattr(hf_mod.HFHub, "_session", lambda self: Session())
    assert h.read_range("data/a.parquet", 100, 4) == b"abcd"
    assert seen["range"] == "bytes=100-103"
    seen["honour"] = False  # a server that ignores Range still yields the window
    assert h.read_range("data/a.parquet", 10, 4) == bytes([10, 11, 12, 13])
    assert h.size("data/a.parquet") == 1234


# -- net ----------------------------------------------------------------------


def test_retry_with_backoff():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry_with_backoff(flaky, "flaky", max_retries=4, base_delay=0.0) == "ok"
    assert len(calls) == 3

    class NotFound(Exception):
        pass

    def missing():
        calls.append(1)
        raise NotFound("404")

    calls.clear()
    with pytest.raises(NotFound):
        retry_with_backoff(missing, "missing", max_retries=5, base_delay=0.0, fatal=(NotFound,))
    assert len(calls) == 1  # permanent errors are not retried
    with pytest.raises(ValueError, match="boom"):
        retry_with_backoff(lambda: (_ for _ in ()).throw(ValueError("boom")), "always",
                           max_retries=2, base_delay=0.0)


def test_stream_to_file_is_atomic(tmp_path):
    dest = str(tmp_path / "sub" / "out.bin")
    assert stream_to_file(lambda: FakeResp(), dest) == dest
    assert open(dest, "rb").read() == b"PAYLOAD"
    assert os.listdir(tmp_path / "sub") == ["out.bin"]

    class Bad(FakeResp):
        def raise_for_status(self):
            raise RuntimeError("http 500")

    with pytest.raises(RuntimeError):
        stream_to_file(lambda: Bad(), str(tmp_path / "bad.bin"))
    assert not os.path.exists(tmp_path / "bad.bin")
