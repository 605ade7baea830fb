"""Generic shard orchestration loop.

Abstracts the control flow every reference processor re-implements
(yodas2-mimi/process_shard.py:1035-1124 is the canonical copy):

    for each work unit in the shard:
        skip if in progress ledger OR already on the hub   (idempotence)
        process -> local artifact files
        queue artifacts; batch-upload every N units in one commit
        mark completed ONLY after its artifacts uploaded   (ordering!)
    retry previously-failed units on restart

Dataset builders plug in a ``process(unit) -> [(local_path, repo_path)]``
callable; placement (one shard per GPU host) is left to the launcher,
keeping the reference's shared-nothing design (SURVEY §2.2).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, List, Sequence, Tuple

from tokenize_audio_tpu_torch.hub.base import ArtifactStore
from tokenize_audio_tpu_torch.runner.progress import ShardProgress

logger = logging.getLogger(__name__)

Artifacts = List[Tuple[str, str]]  # (local_path, repo_path)


@dataclasses.dataclass
class WorkUnit:
    unit_id: str
    payload: object = None
    # repo paths that, if ALL present on the hub, make this unit complete
    done_markers: Tuple[str, ...] = ()


@dataclasses.dataclass
class RunReport:
    processed: int = 0
    skipped: int = 0
    failed: int = 0
    uploaded_files: int = 0
    wall_seconds: float = 0.0


class ShardRunner:
    def __init__(
        self,
        shard_id: str,
        hub: ArtifactStore,
        progress_dir: str,
        process: Callable[[WorkUnit], Artifacts],
        upload_batch_size: int = 10,
        max_consecutive_failures: int = 20,
    ):
        self.shard_id = shard_id
        self.hub = hub
        self.progress = ShardProgress(progress_dir, shard_id)
        self.process = process
        self.upload_batch_size = upload_batch_size
        self.max_consecutive_failures = max_consecutive_failures
        self._pending: List[Tuple[str, Artifacts]] = []  # (unit_id, artifacts)

    # -- completion checks -------------------------------------------------

    def is_unit_done(self, unit: WorkUnit) -> bool:
        if self.progress.is_completed(unit.unit_id):
            return True
        if unit.done_markers and all(self.hub.exists(m) for m in unit.done_markers):
            # hub is the durable ledger; adopt into local progress
            self.progress.mark_completed(unit.unit_id)
            return True
        return False

    # -- upload ------------------------------------------------------------

    def _flush_uploads(self) -> int:
        if not self._pending:
            return 0
        items = [a for _, arts in self._pending for a in arts]
        self.hub.upload_batch(items)
        n = len(items)
        # mark complete only after the batch commit succeeded
        for unit_id, _ in self._pending:
            self.progress.mark_completed(unit_id)
        for lp, _ in items:
            try:
                os.unlink(lp)
            except FileNotFoundError:
                pass
        self._pending.clear()
        return n

    # -- main loop ---------------------------------------------------------

    def run(self, units: Sequence[WorkUnit]) -> RunReport:
        t0 = time.perf_counter()
        report = RunReport()
        consecutive = 0
        for unit in units:
            # hub-exists wins over local failed state (same precedence as
            # the yodas2 plan): a crash between upload and mark-completed
            # leaves the unit failed locally with its artifacts already on
            # the hub — re-encoding it would redo the most expensive stage
            # for nothing. Units in progress.failed without hub markers are
            # not "done" and fall through to reprocessing.
            if self.is_unit_done(unit):
                report.skipped += 1
                continue
            try:
                artifacts = self.process(unit)
                consecutive = 0
            except Exception:  # noqa: BLE001 — per-unit isolation, unit retried on restart
                logger.exception("unit %s failed", unit.unit_id)
                self.progress.mark_failed(unit.unit_id)
                report.failed += 1
                consecutive += 1
                if consecutive >= self.max_consecutive_failures:
                    raise RuntimeError(
                        f"{consecutive} consecutive unit failures — aborting shard "
                        f"{self.shard_id} (cf. max_consecutive_missing, "
                        "yodas2-mimi/process_shard.py:1060-1069)"
                    )
                continue
            report.processed += 1
            if artifacts:
                self._pending.append((unit.unit_id, artifacts))
                if len(self._pending) >= self.upload_batch_size:
                    report.uploaded_files += self._flush_uploads()
            else:
                self.progress.mark_completed(unit.unit_id)
        report.uploaded_files += self._flush_uploads()
        if report.failed == 0 and not self.progress.failed:
            # done flag proves completion to monitors/pod-runner even
            # without expected-unit counts
            self.progress.meta["done"] = True
            self.progress.save()
        report.wall_seconds = time.perf_counter() - t0
        return report
