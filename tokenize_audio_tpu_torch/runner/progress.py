"""Crash-safe progress bookkeeping.

Mirrors the reference's contracts (SURVEY §5 checkpoint/resume):
  - progress JSON {completed, failed, timestamps} saved after every work
    unit (yodas2-mimi/process_shard.py:917-931);
  - atomic tmp+rename writes with PID-suffixed temp names
    (pretraining-data/prepare_pretraining_data.py:616-635);
  - restart-anywhere: loading tolerates a missing or torn file.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List


def atomic_write_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_json(path: str, default: Any = None) -> Any:
    try:
        with open(path) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return default


def atomic_write_text(path: str, text: str) -> None:
    """Atomic tmp+rename write of pre-serialized text (same contract as
    atomic_write_json, for callers that already hold the serialized form)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def append_jsonl(path: str, records: List[Any]) -> None:
    """Append records as JSON lines, fsync'd. O(new) per save where the
    rewrite-everything pattern is O(total) — the incremental-checkpoint
    primitive for large accumulating outputs. A crash mid-append leaves at
    most one torn LAST line, which read_jsonl drops."""
    append_jsonl_lines(path, [json.dumps(r) for r in records])


def append_jsonl_lines(path: str, lines: List[str]) -> None:
    """append_jsonl for already-serialized single-line JSON strings."""
    if not lines:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "ab") as f:
        if f.tell() > 0:
            # heal a torn tail from a crash mid-append: terminate it so the
            # fragment becomes its own (dropped) line instead of merging
            # with — and corrupting — the first record appended now
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                ends_nl = rf.read(1) == b"\n"
            if not ends_nl:
                f.write(b"\n")
        for line in lines:
            f.write(line.encode())
            f.write(b"\n")
        f.flush()
        os.fsync(f.fileno())


def read_jsonl(path: str, default: Any = None) -> Any:
    """Read a JSONL file written by append_jsonl; malformed lines (a torn
    tail from a crash mid-append) are dropped rather than fatal."""
    try:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn line: that record re-processes on resume
        return out
    except FileNotFoundError:
        return default


class ShardProgress:
    """Per-shard progress ledger: completed / failed work-unit ids."""

    def __init__(self, progress_dir: str, shard_id: str):
        self.path = os.path.join(progress_dir, f"{shard_id}_progress.json")
        self.shard_id = shard_id
        state = read_json(self.path, {}) or {}
        self.completed: List[str] = list(state.get("completed", []))
        self.failed: List[str] = list(state.get("failed", []))
        self.meta: Dict[str, Any] = state.get("meta", {})

    def is_completed(self, unit_id: str) -> bool:
        return unit_id in self.completed

    def mark_completed(self, unit_id: str) -> None:
        if unit_id not in self.completed:
            self.completed.append(unit_id)
        if unit_id in self.failed:
            self.failed.remove(unit_id)
        self.save()

    def mark_failed(self, unit_id: str) -> None:
        if unit_id not in self.failed and unit_id not in self.completed:
            self.failed.append(unit_id)
        self.save()

    def save(self) -> None:
        atomic_write_json(
            self.path,
            {
                "shard_id": self.shard_id,
                "completed": self.completed,
                "failed": self.failed,
                "meta": self.meta,
                "updated_at": time.time(),
            },
        )
