"""Emilia shard processor (standard + conversational variants).

Capability equivalent of ``emilia-mimi/process_shard.py`` (686 lines) and
``process_shard_conversational.py``: fetch ``{split}/{lang}/{shard}.tar``,
extract audio+JSON metadata pairs with a completion marker (:351-405),
accumulate-to-batch encode with an ``audio_str`` cache for mid-shard
resume (the reference rewrites a full cache JSON every ``cache_interval``
files, :231-268, :516-519; here it is an append-only JSONL), group
utterances ``{LANG}_{Bshard}_{Sspeaker}_{Wutt}`` into per-speaker documents
(:543-580), emit `_type1`+`_type2` rows (conversational: `[n]` speaker-turn
tags by first appearance with ``speaker_ids``/``speaker_count`` columns and
type1 only, conversational:556-596), and upload
``{split}/{lang}/{shard}.parquet`` with post-upload verification (:606-633).

Real Emilia archives hold mp3, decoded natively by
``tokenize_audio_tpu_torch.io.decode_audio`` (libmpg123-backed, io/mp3.py,
where that library is installed); wav/flac members work too.

Run a shard on the CUDA device (``--device cpu`` for the CPU)::

    python -m tokenize_audio_tpu_torch.datasets.emilia --lang EN \
        --shard-id EN_B00000 --source-hub dir:/corpus --target-hub dir:/out
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import tarfile
import tempfile
from typing import Dict, List, Tuple

import numpy as np

from tokenize_audio_tpu_torch.cli import add_engine_args, engine_from_args
from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import codes_to_chars
from tokenize_audio_tpu_torch.datasets.base import interleaved_type1, interleaved_type2
from tokenize_audio_tpu_torch.datasets.parquet_utils import write_parquet
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.io import decode_audio
from tokenize_audio_tpu_torch.io.prefetch import prefetch_map
from tokenize_audio_tpu_torch.runner import append_jsonl, read_json, read_jsonl

logger = logging.getLogger(__name__)


def speaker_document_id(utterance_id: str) -> str:
    """EN_B00000_S00040_W000004 -> EN_B00000_S00040 (process_shard.py:543-554)."""
    return "_".join(utterance_id.split("_")[:-1])


def group_documents(utterance_ids: List[str]) -> Dict[str, List[str]]:
    docs: Dict[str, List[str]] = {}
    for uid in utterance_ids:
        docs.setdefault(speaker_document_id(uid), []).append(uid)
    return docs


def build_rows(
    utterances: Dict[str, Dict],
    split: str,
    shard_id: str,
    conversational: bool = False,
) -> List[Dict]:
    """utterances: {utt_id: {"audio_str", "transcript", "speaker"?}} ->
    document rows."""
    rows: List[Dict] = []
    split_name = f"{split}-{shard_id}"
    for doc_id, uids in group_documents(list(utterances)).items():
        if conversational:
            mapping: Dict[str, int] = {}
            tags: List[int] = []
            chunks: List[Tuple[str, str]] = []
            for uid in uids:
                u = utterances[uid]
                speaker = u["speaker"]
                if not speaker.startswith("SPEAKER_"):
                    raise ValueError(f"Speaker ID {speaker} does not start with 'SPEAKER_'")
                mapping.setdefault(speaker, len(mapping))
                tags.append(mapping[speaker])
                chunks.append((u["transcript"].strip(), u["audio_str"].strip()))
            rows.append(
                {
                    "id": doc_id,
                    "split": split_name,
                    "text": interleaved_type1(chunks, speaker_tags=tags),
                    "speaker_ids": tags,
                    "speaker_count": len(set(tags)),
                }
            )
        else:
            chunks = [
                (utterances[uid]["transcript"], utterances[uid]["audio_str"]) for uid in uids
            ]
            rows.append(
                {"id": f"{doc_id}_type1", "split": split_name, "text": interleaved_type1(chunks)}
            )
            rows.append(
                {"id": f"{doc_id}_type2", "split": split_name, "text": interleaved_type2(chunks)}
            )
    return rows


class EmiliaShardProcessor:
    def __init__(
        self,
        split: str,
        lang: str,
        shard_id: str,
        source_hub,
        target_hub,
        engine: MimiEncoderEngine,
        work_dir: str,
        conversational: bool = False,
        # mp3 decode threads: one core decodes ~2400x real time, about the
        # chip's encode rate, so serial decode would halve shard throughput
        num_workers: int = 2,
    ):
        self.split, self.lang, self.shard_id = split, lang, shard_id
        self.source_hub, self.target_hub = source_hub, target_hub
        self.engine = engine
        self.work_dir = os.path.join(work_dir, shard_id)
        os.makedirs(self.work_dir, exist_ok=True)
        self.conversational = conversational
        self.num_workers = num_workers
        self.cache_path = os.path.join(self.work_dir, "audio_str_cache.json")

    @property
    def target_path(self) -> str:
        return f"{self.split}/{self.lang}/{self.shard_id}.parquet"

    @property
    def source_path(self) -> str:
        return f"{self.split}/{self.lang}/{self.shard_id}.tar"

    def is_already_processed(self) -> bool:
        return self.target_hub.exists(self.target_path)

    def _extract(self) -> str:
        extract_dir = os.path.join(self.work_dir, "extracted")
        marker = os.path.join(extract_dir, ".extraction_complete")
        if os.path.exists(marker):
            return extract_dir
        if os.path.exists(extract_dir):
            shutil.rmtree(extract_dir)
        local_tar = os.path.join(self.work_dir, f"{self.shard_id}.tar")
        self.source_hub.download(self.source_path, local_tar)
        os.makedirs(extract_dir)
        with tarfile.open(local_tar, "r:*") as tf:
            tf.extractall(extract_dir, filter="data")
        open(marker, "w").close()
        os.unlink(local_tar)  # delete tar after extraction (:442)
        return extract_dir

    def _collect_pairs(self, extract_dir: str) -> List[Tuple[str, str, str]]:
        """(utterance_id, audio_path, json_path), sorted by utterance id."""
        pairs = []
        for dirpath, _, files in os.walk(extract_dir):
            for f in files:
                base, ext = os.path.splitext(f)
                if ext == ".json":
                    for aext in (".mp3", ".wav", ".flac"):
                        apath = os.path.join(dirpath, base + aext)
                        if os.path.exists(apath):
                            pairs.append((base, apath, os.path.join(dirpath, f)))
                            break
        return sorted(pairs)

    def _load_cache(self) -> Dict[str, Dict]:
        """Load the audio_str resume cache. Current format is JSONL (one
        {"uid", ...} record per line, last occurrence wins); a cache
        written by an older full-JSON-dict version is migrated in place."""
        rows = read_jsonl(self.cache_path, []) or []
        cache = {
            r["uid"]: {k: v for k, v in r.items() if k != "uid"}
            for r in rows
            if isinstance(r, dict) and "uid" in r
        }
        if cache:
            return cache
        legacy = read_json(self.cache_path, {}) or {}
        if isinstance(legacy, dict) and legacy:
            append_jsonl(
                f"{self.cache_path}.migrated", [{"uid": u, **v} for u, v in legacy.items()]
            )
            os.replace(f"{self.cache_path}.migrated", self.cache_path)
            return legacy
        return {}

    def process(self) -> Dict:
        if self.is_already_processed():
            return {"shard": self.shard_id, "status": "skipped"}
        extract_dir = self._extract()
        pairs = self._collect_pairs(extract_dir)
        cache: Dict[str, Dict] = self._load_cache()

        todo = [p for p in pairs if p[0] not in cache]
        batch: List[Tuple[str, np.ndarray, Dict]] = []

        def flush_batch():
            # the audio_str cache is APPEND-ONLY JSONL: every encoded batch
            # persists immediately at O(new) cost, where the reference's
            # periodic full-cache rewrite (process_shard.py:231-268) is
            # O(total) per save — and loses everything since the last
            # periodic save on a crash; here at most one batch re-encodes
            if not batch:
                return
            codes = self.engine.encode_batch([a for _, a, _ in batch])
            records = []
            for (uid, _, meta), c in zip(batch, codes):
                entry = {
                    "audio_str": codes_to_chars(
                        c[:8], CODEBOOK_SIZE, unicode_offset=UNICODE_OFFSET_LARGE
                    ),
                    "transcript": meta.get("text", ""),
                    "speaker": meta.get("speaker", ""),
                }
                cache[uid] = entry
                records.append({"uid": uid, **entry})
            append_jsonl(self.cache_path, records)
            batch.clear()

        def load_one(item):
            """Worker-thread decode+prepare (overlaps the engine's encode on
            the main thread — the decode-prefetch role of the reference's
            ThreadPoolExecutor, yodas2 pattern). A member off 24 kHz
            resamples here, on the engine's device, from this worker
            thread: ``prepare_audio``'s conv runs under ``ieee_fp32()``,
            which counts its holders across threads."""
            uid, apath, jpath = item
            try:
                with open(jpath) as f:
                    meta = json.load(f)
                if self.conversational and not str(meta.get("speaker", "")).startswith(
                    "SPEAKER_"
                ):
                    # conversational docs need diarized SPEAKER_xx labels;
                    # validate BEFORE encoding — a bad value written into
                    # the persisted cache would make build_rows crash the
                    # shard on every retry
                    raise ValueError(
                        f"missing/invalid speaker label {meta.get('speaker')!r}"
                    )
                # raw_int16 matters for the .wav/.flac members
                # _collect_pairs also accepts; mp3 ignores it by design
                audio, sr = decode_audio(apath, raw_int16=True)
                return uid, self.engine.prepare_audio(audio, sr), meta, None
            except (ValueError, OSError, json.JSONDecodeError) as e:
                return uid, None, None, e

        failed: List[str] = []
        for uid, prepared, meta, err in prefetch_map(
            load_one, iter(todo), workers=self.num_workers
        ):
            if err is not None:
                # corrupt/malformed member: skip the utterance, keep the
                # shard — the reference's per-item isolation (its
                # librosa.load failures drop the file, not the shard)
                logger.warning("skipping %s: %s", uid, err)
                failed.append(uid)
                continue
            batch.append((uid, prepared, meta))
            if len(batch) >= self.engine.engine_cfg.batch_size:
                flush_batch()
        flush_batch()

        # deterministic utterance order regardless of encode/resume history:
        # the append-only cache holds entries in completion order, which a
        # resumed run permutes (retried files append last) — documents must
        # keep the sorted-uid order the reference gets from its sorted file
        # list ({LANG}_{B}_{S}_{W} ids sort chronologically per speaker)
        usable = dict(sorted(cache.items()))
        if self.conversational:
            # a cache written by an earlier run (or standard-mode pass) may
            # hold entries without diarized labels; drop them instead of
            # letting build_rows' strict check crash the shard forever
            usable = {
                uid: v
                for uid, v in usable.items()
                if str(v.get("speaker", "")).startswith("SPEAKER_")
            }
            for uid in cache.keys() - usable.keys():
                logger.warning("dropping %s: invalid cached speaker label", uid)
                failed.append(uid)
        rows = build_rows(
            usable, self.split, self.shard_id, conversational=self.conversational
        )
        local_out = os.path.join(self.work_dir, f"{self.shard_id}.parquet")
        write_parquet(rows, local_out)
        self.target_hub.upload_file(local_out, self.target_path)
        if not self.target_hub.exists(self.target_path):
            raise RuntimeError(f"upload verification failed: {self.target_path}")
        os.unlink(local_out)
        shutil.rmtree(extract_dir, ignore_errors=True)
        try:
            os.unlink(self.cache_path)
        except FileNotFoundError:
            pass  # zero encoded utterances: no cache file was ever created
        return {
            "shard": self.shard_id,
            "status": "processed",
            "rows": len(rows),
            "failed_files": failed,
        }


def main(argv=None) -> Dict:
    """Process one shard; prints the report as one JSON line and returns it."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--split", default="Emilia")
    ap.add_argument("--lang", required=True)
    ap.add_argument("--shard-id", required=True)
    ap.add_argument("--source-hub", required=True)
    ap.add_argument("--target-hub", required=True)
    ap.add_argument(
        "--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_emilia")
    )
    ap.add_argument("--conversational", action="store_true")
    add_engine_args(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine = engine_from_args(args)
    proc = EmiliaShardProcessor(
        args.split,
        args.lang,
        args.shard_id,
        open_hub(args.source_hub),
        open_hub(args.target_hub),
        engine,
        args.work_dir,
        conversational=args.conversational,
    )
    report = proc.process()
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
