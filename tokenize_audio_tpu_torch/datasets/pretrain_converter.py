"""Code-JSON -> interleaved pretraining parquet converter (CPU-only stage).

Capability equivalent of ``pretraining-data/prepare_pretraining_data.py``:
consumes the raw code JSONs emitted by the YODAS2 encoder stage (a list of
entries ``{"audio_id", "text": {chunk_id: str}, "codes": {chunk_id:
[[uint16]xK]}}``), slices to the first 8 codebooks, converts to unicode via
the validated codec, builds per-audio type1/type2 interleaved documents
(:273-311), accumulates rows across sub-shards into ~parquet_rows-row files
(:737-788), checkpoints the accumulator atomically (:558-653), and marks
sub-shards complete only after upload (:790-835). A persisted parquet
counter survives local deletion (:497-537).

The port's copy of the JAX package's module of the same path, with the same
names, flags, file names and resume behaviour. Host code: it reads the code
JSONs a YODAS2 run (on the card) uploaded and does no device work.

    python -m tokenize_audio_tpu_torch.datasets.pretrain_converter \
        --shard-id en000 --subshard-ids @subshards.txt \
        --source-hub dir:/data/hub/data --target-hub dir:/data/pretrain \
        --progress-dir /data/progress [--parquet-rows 10000]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, NUM_CODEBOOKS, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import codes_to_chars
from tokenize_audio_tpu_torch.datasets.base import interleaved_type1, interleaved_type2
from tokenize_audio_tpu_torch.datasets.parquet_utils import write_parquet
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.runner import ShardProgress, atomic_write_json, read_json

logger = logging.getLogger(__name__)


def document_to_rows(
    document: Dict,
    split_name: str,
    num_codebooks: int = NUM_CODEBOOKS,
    unicode_offset: int = UNICODE_OFFSET_LARGE,
) -> Tuple[Optional[Dict], Optional[Dict]]:
    """One raw entry -> (_type1, _type2) rows, or (None, None) if unusable
    (prepare_pretraining_data.py:313-379)."""
    if "codes" not in document or "text" not in document:
        return None, None
    audio_id = document["audio_id"]
    text_dict, codes_dict = document["text"], document["codes"]
    chunks = []
    for chunk_id, text in text_dict.items():
        codes = codes_dict.get(chunk_id)
        if not codes:
            continue
        arr = np.asarray(codes, dtype=np.int32)[:num_codebooks, :]
        chunks.append(
            (text, codes_to_chars(arr, CODEBOOK_SIZE, unicode_offset=unicode_offset))
        )
    if not chunks:
        return None, None
    return (
        {"id": f"{audio_id}_type1", "split": split_name, "text": interleaved_type1(chunks)},
        {"id": f"{audio_id}_type2", "split": split_name, "text": interleaved_type2(chunks)},
    )


class PretrainShardConverter:
    """Accumulating converter for one shard's sub-shard code JSONs.

    Durability contract: ``work_dir`` must be durable storage (the
    reference keeps its accumulation checkpoint on the cluster's shared
    filesystem, prepare_pretraining_data.py:558-653) — residual rows of
    completed sub-shards live in the checkpoint until the next parquet
    rollover, and orphaned parquets are requeued from ``work_dir`` on
    restart.
    """

    def __init__(
        self,
        shard_id: str,
        source_hub,
        target_hub,
        work_dir: str,
        progress_dir: str,
        parquet_rows: int = 10_000,
        upload_batch_size: int = 4,
        checkpoint_interval: int = 5,
    ):
        self.shard_id = shard_id
        self.source_hub = source_hub
        self.target_hub = target_hub
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.progress = ShardProgress(progress_dir, f"pretrain_{shard_id}")
        self.parquet_rows = parquet_rows
        self.upload_batch_size = upload_batch_size
        self.checkpoint_interval = checkpoint_interval

        self.counter_path = os.path.join(work_dir, f"{shard_id}.parquet_counter.json")
        self.ckpt_path = os.path.join(work_dir, f"{shard_id}.accum.json")
        state = read_json(self.ckpt_path, {}) or {}
        self.rows: List[Dict] = state.get("rows", [])
        self.checkpointed_subshards: List[str] = state.get("subshards", [])
        self.parquet_index: int = (read_json(self.counter_path, {}) or {}).get("next", 0)
        self._pending_uploads: List[Tuple[str, str, List[str]]] = []
        self._since_checkpoint = 0
        self._scan_orphan_parquets(state.get("counter", 0))

    def _scan_orphan_parquets(self, ckpt_counter: int) -> None:
        """Requeue parquets emitted before a crash but never uploaded —
        without this, rows trimmed from the accumulator checkpoint would be
        lost. Mirrors yodas2's startup scan-and-queue (process_shard.py:
        851-915). Orphans with index >= the checkpoint's recorded counter
        were written after the last rows snapshot — their rows are still in
        the accumulator, so requeueing them would publish duplicates; they
        are deleted and re-emitted instead."""
        prefix = f"{self.shard_id}-"
        for f in sorted(os.listdir(self.work_dir)):
            if not (f.startswith(prefix) and f.endswith(".parquet")) or ".tmp." in f:
                continue
            local = os.path.join(self.work_dir, f)
            repo = f"data/{f}"
            if self.target_hub.exists(repo):
                os.unlink(local)
                continue
            try:
                idx = int(f[len(prefix) : -len(".parquet")])
            except ValueError:
                continue
            if idx >= ckpt_counter:
                logger.info("discarding post-checkpoint orphan %s (rows still accumulated)", f)
                os.unlink(local)
                continue
            logger.info("requeueing orphaned parquet %s", f)
            self._pending_uploads.append((local, repo, list(self.checkpointed_subshards)))

    # -- persistence -------------------------------------------------------

    def _save_checkpoint(self) -> None:
        atomic_write_json(
            self.ckpt_path,
            {
                "rows": self.rows,
                "subshards": self.checkpointed_subshards,
                # parquet counter at checkpoint time: orphans with an index
                # >= this were emitted AFTER the rows snapshot (their rows
                # are still in `rows`) and must be discarded, not requeued
                "counter": self.parquet_index,
            },
        )
        self._since_checkpoint = 0

    def _next_parquet_name(self) -> str:
        name = f"{self.shard_id}-{self.parquet_index:05d}.parquet"
        self.parquet_index += 1
        atomic_write_json(self.counter_path, {"next": self.parquet_index})
        return name

    # -- core --------------------------------------------------------------

    def is_subshard_done(self, subshard_id: str) -> bool:
        return (
            self.progress.is_completed(subshard_id)
            or subshard_id in self.checkpointed_subshards
        )

    def add_subshard(self, subshard_id: str, entries: List[Dict]) -> None:
        split = f"{self.shard_id}/{subshard_id}"
        for doc in entries:
            r1, r2 = document_to_rows(doc, split)
            if r1:
                self.rows.append(r1)
                self.rows.append(r2)
        self.checkpointed_subshards.append(subshard_id)
        self._since_checkpoint += 1
        if self._since_checkpoint >= self.checkpoint_interval:
            self._save_checkpoint()
        while len(self.rows) >= self.parquet_rows:
            self._emit_parquet(self.rows[: self.parquet_rows])
            self.rows = self.rows[self.parquet_rows :]
            self._save_checkpoint()
        self._maybe_upload()

    def _emit_parquet(self, rows: List[Dict]) -> None:
        name = self._next_parquet_name()
        local = write_parquet(rows, os.path.join(self.work_dir, name))
        covered = list(self.checkpointed_subshards)
        self._pending_uploads.append((local, f"data/{name}", covered))

    def _maybe_upload(self, force: bool = False) -> None:
        if not self._pending_uploads:
            return
        if not force and len(self._pending_uploads) < self.upload_batch_size:
            return
        items = [(lp, rp) for lp, rp, _ in self._pending_uploads]
        self.target_hub.upload_batch(items)
        # mark covered sub-shards complete ONLY now (upload-before-complete)
        done: List[str] = []
        for _, _, covered in self._pending_uploads:
            done = covered  # latest batch covers all earlier ones too
        for s in done:
            if not self.progress.is_completed(s):
                self.progress.mark_completed(s)
        self.checkpointed_subshards = [
            s for s in self.checkpointed_subshards if s not in set(done)
        ]
        for lp, _ in items:
            try:
                os.unlink(lp)
            except FileNotFoundError:
                pass
        self._pending_uploads.clear()
        self._save_checkpoint()

    def finalize(self) -> None:
        """Flush remaining rows into a final parquet and upload everything."""
        if self.rows:
            self._emit_parquet(self.rows)
            self.rows = []
            self._save_checkpoint()
        self._maybe_upload(force=True)
        # subshards that produced zero rows still count as completed
        for s in list(self.checkpointed_subshards):
            self.progress.mark_completed(s)
        self.checkpointed_subshards = []
        self._save_checkpoint()

    # -- entry point -------------------------------------------------------

    def run(self, subshard_ids: List[str], source_prefix: str = "") -> Dict:
        processed = skipped = failed = 0
        for sid in subshard_ids:
            if self.is_subshard_done(sid):
                skipped += 1
                continue
            repo_path = f"{source_prefix}{self.shard_id}/{sid}.json"
            local = os.path.join(self.work_dir, f"{sid}.json")
            try:
                self.source_hub.download(repo_path, local)
                with open(local) as f:
                    entries = json.load(f)
                os.unlink(local)
                self.add_subshard(sid, entries)
                processed += 1
            except Exception:  # noqa: BLE001 — per-subshard isolation
                logger.exception("subshard %s failed", sid)
                self.progress.mark_failed(sid)
                failed += 1
        self.finalize()
        return {"processed": processed, "skipped": skipped, "failed": failed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--subshard-ids", required=True, help="comma list or @file")
    ap.add_argument("--source-hub", required=True)
    ap.add_argument("--target-hub", required=True)
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_pretrain"))
    ap.add_argument("--progress-dir", required=True)
    ap.add_argument("--parquet-rows", type=int, default=10_000)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.subshard_ids.startswith("@"):
        with open(args.subshard_ids[1:]) as f:
            sids = [line.strip() for line in f if line.strip()]
    else:
        sids = args.subshard_ids.split(",")
    conv = PretrainShardConverter(
        args.shard_id,
        open_hub(args.source_hub),
        open_hub(args.target_hub),
        args.work_dir,
        args.progress_dir,
        parquet_rows=args.parquet_rows,
    )
    print(json.dumps(conv.run(sids)))


if __name__ == "__main__":
    main()
