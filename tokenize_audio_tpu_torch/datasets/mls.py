"""MLS-English two-stage pipeline.

Stage 1 (capability equivalent of ``mls-en-mimi-pretrain/process_shard.py``):
parquet shard rows (16 kHz audio + transcript + begin/end times) -> resample
to 24 kHz -> Mimi encode -> one JSON per utterance at
``{out}/{speaker}/{book}/{entry_id}.json`` with a content-addressed
``entry_id = {spk}-{book}-{begin_cs:08d}-{end_cs:08d}-{sha256_b64(transcript)}``
(:150-171, :271-274) plus timing metadata; index-based progress saved every
``progress_save_interval`` entries (:211-230).

Stage 2 (equivalent of ``stage2/merge_and_upload.py`` +
``create_batch_lists.py``): read stage-1 JSONs for a batch of speaker/book
pairs, group by original_path, sort by begin_time, split into consecutive
segments with 0.2 s tolerance (:122-164), emit text-first/audio-first
interleaved docs with ``_seg{n}`` suffixes (:167-248), upload
``data/{batch}.parquet`` skip-if-exists (:384-397).

CLI, stage 1 on the CUDA device (``--device cpu`` for the CPU)::

    python -m tokenize_audio_tpu_torch.datasets.mls stage1 --shard-id 0000 \
        --parquet shard.parquet --output-dir /stage1 --progress-dir /progress
    python -m tokenize_audio_tpu_torch.datasets.mls stage2 --stage1-dir /stage1 \
        --batch-name batch_000 --pairs pairs.txt --hub dir:/out
"""

from __future__ import annotations

import argparse
import base64
import hashlib
import json
import logging
import os
import re
import tempfile
import unicodedata
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from tokenize_audio_tpu_torch.cli import add_engine_args, engine_from_args
from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import codes_to_chars
from tokenize_audio_tpu_torch.datasets.base import interleaved_type1, interleaved_type2
from tokenize_audio_tpu_torch.datasets.parquet_corpus import _decode_embedded_audio
from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.runner import atomic_write_json, read_json

logger = logging.getLogger(__name__)

TIME_TOLERANCE = 0.2


def canonicalize(text: str) -> str:
    t = unicodedata.normalize("NFKC", text)
    t = t.strip().lower()
    return re.sub(r"\s+", " ", t)


def text_to_id(text: str, bits: int = 128) -> str:
    h = hashlib.sha256(canonicalize(text).encode("utf-8")).digest()
    if bits == 128:
        h = h[:16]
    return base64.urlsafe_b64encode(h).decode("ascii").rstrip("=")


def make_entry_id(speaker_id, book_id, begin_time: float, end_time: float, transcript: str) -> str:
    return (
        f"{speaker_id}-{book_id}-{int(begin_time * 100):08d}-"
        f"{int(end_time * 100):08d}-{text_to_id(transcript)}"
    )


# ---------------------------------------------------------------------------
# Stage 1
# ---------------------------------------------------------------------------

class MLSStage1Processor:
    def __init__(
        self,
        shard_id: str,
        engine: MimiEncoderEngine,
        output_dir: str,
        progress_dir: str,
        progress_save_interval: int = 500,
    ):
        self.shard_id = shard_id
        self.engine = engine
        self.output_dir = output_dir
        self.progress_path = os.path.join(progress_dir, f"mls_{shard_id}_progress.json")
        self.progress_save_interval = progress_save_interval

    def _write_entry(self, entry: Dict, entry_id: str, out_path: str, codes) -> None:
        audio_str = codes_to_chars(
            codes[:8], CODEBOOK_SIZE, unicode_offset=UNICODE_OFFSET_LARGE
        )
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        atomic_write_json(
            out_path,
            {
                "entry_id": entry_id,
                "original_path": entry.get("original_path", ""),
                "speaker_id": entry["speaker_id"],
                "book_id": entry["book_id"],
                "transcript": entry["transcript"],
                "begin_time": entry["begin_time"],
                "end_time": entry["end_time"],
                "audio_duration": entry.get(
                    "audio_duration", entry["end_time"] - entry["begin_time"]
                ),
                "audio_str": audio_str,
            },
        )

    def run(self, rows: Sequence[Dict]) -> Dict:
        progress = read_json(self.progress_path, None) or {
            "processed_count": 0,
            "total_count": len(rows),
            "last_processed_index": -1,
        }
        start = progress["last_processed_index"] + 1
        since_save = 0
        # device batches of engine batch_size (an upgrade over the
        # reference's per-entry unbatched encode, process_shard.py:305)
        bs = self.engine.engine_cfg.batch_size
        batch: List[Tuple[Dict, str, str]] = []  # (entry, entry_id, out_path)

        def flush():
            if not batch:
                return
            # shared cell decoder: handles {'array','sampling_rate'} AND the
            # common HF {'bytes','path'} embedded layouts (parquet_corpus)
            items = [_decode_embedded_audio(e["audio"]) for e, _, _ in batch]
            for (e, eid, op), c in zip(batch, self.engine.encode_batch_mixed(items)):
                self._write_entry(e, eid, op, c)
            batch.clear()

        for idx in range(start, len(rows)):
            entry = rows[idx]
            entry_id = make_entry_id(
                entry["speaker_id"],
                entry["book_id"],
                entry["begin_time"],
                entry["end_time"],
                entry["transcript"],
            )
            out_path = os.path.join(
                self.output_dir, str(entry["speaker_id"]), str(entry["book_id"]), f"{entry_id}.json"
            )
            if not os.path.exists(out_path):
                batch.append((entry, entry_id, out_path))
                if len(batch) >= bs:
                    flush()
            progress["processed_count"] += 1
            progress["last_processed_index"] = idx
            since_save += 1
            if since_save >= self.progress_save_interval:
                flush()  # progress must not outrun written outputs
                atomic_write_json(self.progress_path, progress)
                since_save = 0
        flush()
        atomic_write_json(self.progress_path, progress)
        return progress


# ---------------------------------------------------------------------------
# Stage 2
# ---------------------------------------------------------------------------

def split_consecutive_chunks(
    entries: List[Dict], tolerance: float = TIME_TOLERANCE
) -> List[List[Dict]]:
    """Split time-sorted entries where begin/end continuity breaks
    (merge_and_upload.py:122-164)."""
    if not entries:
        return []
    segments, current = [], [entries[0]]
    for prev, curr in zip(entries, entries[1:]):
        gap = abs(float(curr.get("begin_time", 0)) - float(prev.get("end_time", 0)))
        if gap <= tolerance:
            current.append(curr)
        else:
            segments.append(current)
            current = [curr]
    segments.append(current)
    return segments


def create_interleaved_documents(grouped: Dict[str, List[Dict]]) -> List[Dict]:
    """Per original_path: consecutive segments -> `_type1`/`_type2` docs with
    `_seg{n}` suffixes when split (merge_and_upload.py:167-248)."""
    documents: List[Dict] = []
    for original_path, entries in grouped.items():
        if not entries:
            continue
        segments = split_consecutive_chunks(entries)
        for seg_idx, seg in enumerate(segments):
            chunks: List[Tuple[str, str]] = [
                (e["transcript"].strip(), e["audio_str"].strip()) for e in seg
            ]
            first = seg[0]
            suffix = f"_seg{seg_idx}" if len(segments) > 1 else ""
            meta = {
                "original_path": original_path,
                "segment_index": seg_idx,
                "num_segments": len(seg),
                "speaker_id": first.get("speaker_id", ""),
                "book_id": first.get("book_id", ""),
            }
            documents.append(
                {
                    "id": f"{first['entry_id']}{suffix}_type1",
                    "text": interleaved_type1(chunks),
                    **meta,
                }
            )
            documents.append(
                {
                    "id": f"{first['entry_id']}{suffix}_type2",
                    "text": interleaved_type2(chunks),
                    **meta,
                }
            )
    return documents


def merge_batch(
    stage1_dir: str,
    speaker_book_pairs: Sequence[Tuple[str, str]],
    batch_name: str,
    hub,
    work_dir: str,
) -> Dict:
    """Process one stage-2 batch: read JSONs, group, document, upload."""
    target = f"data/{batch_name}.parquet"
    if hub.exists(target):
        return {"batch": batch_name, "status": "skipped"}
    grouped: Dict[str, List[Dict]] = defaultdict(list)
    n_entries = 0
    for speaker, book in speaker_book_pairs:
        d = os.path.join(stage1_dir, str(speaker), str(book))
        if not os.path.isdir(d):
            logger.warning("missing stage-1 dir %s", d)
            continue
        for f in sorted(os.listdir(d)):
            if f.endswith(".json"):
                e = read_json(os.path.join(d, f))
                if e:
                    grouped[e.get("original_path", "")].append(e)
                    n_entries += 1
    for path in grouped:
        grouped[path].sort(key=lambda e: float(e.get("begin_time", 0)))
    docs = create_interleaved_documents(grouped)
    os.makedirs(work_dir, exist_ok=True)
    local = write_parquet(docs, os.path.join(work_dir, f"{batch_name}.parquet"))
    hub.upload_file(local, target)
    os.unlink(local)
    return {"batch": batch_name, "status": "processed", "entries": n_entries, "docs": len(docs)}


def create_batch_lists(
    stage1_dir: str, speakers_per_batch: int = 50
) -> List[List[Tuple[str, str]]]:
    """Scan the speaker/book tree into batches of N speakers
    (create_batch_lists.py:62-109)."""
    pairs: List[Tuple[str, str]] = []
    for speaker in sorted(os.listdir(stage1_dir)):
        sdir = os.path.join(stage1_dir, speaker)
        if not os.path.isdir(sdir):
            continue
        for book in sorted(os.listdir(sdir)):
            if os.path.isdir(os.path.join(sdir, book)):
                pairs.append((speaker, book))
    by_speaker: Dict[str, List[Tuple[str, str]]] = defaultdict(list)
    for s, b in pairs:
        by_speaker[s].append((s, b))
    speakers = sorted(by_speaker)
    batches = []
    for i in range(0, len(speakers), speakers_per_batch):
        batch = []
        for s in speakers[i : i + speakers_per_batch]:
            batch.extend(by_speaker[s])
        batches.append(batch)
    return batches


def main(argv=None) -> Dict:
    """Run one stage; prints its report as one JSON line and returns it."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    sub = ap.add_subparsers(dest="stage", required=True)

    s1 = sub.add_parser("stage1")
    s1.add_argument("--shard-id", required=True)
    s1.add_argument("--parquet", required=True, help="local parquet of MLS rows")
    s1.add_argument("--output-dir", required=True)
    s1.add_argument("--progress-dir", required=True)
    add_engine_args(s1)

    s2 = sub.add_parser("stage2")
    s2.add_argument("--stage1-dir", required=True)
    s2.add_argument("--batch-name", required=True)
    s2.add_argument("--pairs", required=True, help="file of 'speaker book' lines")
    s2.add_argument("--hub", required=True)
    s2.add_argument(
        "--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_mls2")
    )

    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.stage == "stage1":
        engine = engine_from_args(args)
        proc = MLSStage1Processor(args.shard_id, engine, args.output_dir, args.progress_dir)
        report = proc.run(read_parquet(args.parquet))
    else:
        with open(args.pairs) as f:
            pairs = [tuple(line.split()) for line in f if line.strip()]
        report = merge_batch(
            args.stage1_dir, pairs, args.batch_name, open_hub(args.hub), args.work_dir
        )
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
