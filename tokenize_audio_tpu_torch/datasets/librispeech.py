"""LibriSpeech -> Mimi-code ASR/TTS parquet builder (the MVP vertical slice).

Capability equivalent of ``librispeech-mimi/process_librispeech_train.py``
and ``process_librispeech_dev-test.py``: local audio manifest -> decode ->
resample -> batched Mimi encode (first 8 codebooks) -> unicode code strings
-> `_type1` (TTS) / `_type2` (ASR) document rows -> chunked parquet ->
artifact hub, with chunk-level resume.

Manifest: JSON list of {"id": str, "audio": path, "text": str}
(the reference reads an equivalent local JSON of flac paths + transcripts).

CLI, on the CUDA device (``--device cpu`` for the CPU):
    python -m tokenize_audio_tpu_torch.datasets.librispeech \
        --manifest dev-clean.json --split dev-clean \
        --hub dir:/data/hub --progress-dir /data/progress \
        --params /path/model.safetensors [--chunk-rows 10000]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Dict, List, Sequence

from tokenize_audio_tpu_torch.cli import add_engine_args, engine_from_args
from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import codes_to_chars
from tokenize_audio_tpu_torch.datasets.base import asr_document, tts_document
from tokenize_audio_tpu_torch.datasets.parquet_utils import chunk_name, write_parquet
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.io import decode_audio
from tokenize_audio_tpu_torch.runner import ShardRunner, WorkUnit

logger = logging.getLogger(__name__)


def build_rows(entries: Sequence[Dict], engine: MimiEncoderEngine) -> List[Dict]:
    """Encode a list of manifest entries into _type1/_type2 rows.

    Row schema matches process_librispeech_train.py:196-208: per utterance a
    TTS row (`{id}_type1`) and an ASR row (`{id}_type2`). Corrupt audio
    files are dropped per item (logged) — one bad flac must not fail the
    whole chunk on every restart. The whole chunk is decoded before one
    ``encode_batch_mixed`` call, as in the JAX package."""
    good: List[Dict] = []
    items = []
    for e in entries:
        try:
            items.append(decode_audio(e["audio"], raw_int16=True))
        except (ValueError, OSError) as err:
            logger.warning("skipping %s (%s): %s", e.get("id"), e.get("audio"), err)
            continue
        good.append(e)
    entries = good
    codes_list = engine.encode_batch_mixed(items)
    rows: List[Dict] = []
    for e, c in zip(entries, codes_list):
        audio_str = codes_to_chars(c, CODEBOOK_SIZE, unicode_offset=UNICODE_OFFSET_LARGE)
        text = e["text"].strip()
        rows.append({"id": f"{e['id']}_type1", "text": tts_document(text, audio_str)})
        rows.append({"id": f"{e['id']}_type2", "text": asr_document(text, audio_str)})
    return rows


def process_split_devtest(
    manifest: List[Dict],
    split: str,
    engine: MimiEncoderEngine,
    hub,
    progress_dir: str,
    work_dir: str,
):
    """dev/test layout: two artifacts per split, `{split}_asr` and
    `{split}_tts` (process_librispeech_dev-test.py:121-171 pushes separate
    ASR and TTS dataset configs)."""
    markers = (f"data/{split}_asr.parquet", f"data/{split}_tts.parquet")

    def process(unit: WorkUnit) -> list:
        rows = build_rows(manifest, engine)
        tts = [
            {"id": r["id"][: -len("_type1")], "text": r["text"]}
            for r in rows
            if r["id"].endswith("_type1")
        ]
        asr = [
            {"id": r["id"][: -len("_type2")], "text": r["text"]}
            for r in rows
            if r["id"].endswith("_type2")
        ]
        out = []
        for name, data in ((f"{split}_tts", tts), (f"{split}_asr", asr)):
            local = write_parquet(data, f"{work_dir}/{name}.parquet")
            out.append((local, f"data/{name}.parquet"))
        return out

    runner = ShardRunner(split, hub, progress_dir, process, upload_batch_size=1)
    return runner.run([WorkUnit(split, done_markers=markers)])


def process_split(
    manifest: List[Dict],
    split: str,
    engine: MimiEncoderEngine,
    hub,
    progress_dir: str,
    work_dir: str,
    chunk_rows: int = 10_000,
    upload_batch_size: int = 4,
):
    """Chunk the manifest into parquet files of <=chunk_rows rows (2 rows per
    utterance), run through the resumable shard loop."""
    per_chunk = max(1, chunk_rows // 2)
    chunks = [manifest[i : i + per_chunk] for i in range(0, len(manifest), per_chunk)]
    total = len(chunks)

    def process(unit: WorkUnit) -> list:
        idx, entries = unit.payload
        rows = build_rows(entries, engine)
        name = chunk_name(split, idx, total)
        local = write_parquet(rows, f"{work_dir}/{name}")
        return [(local, f"data/{name}")]

    units = [
        WorkUnit(
            unit_id=chunk_name(split, i, total),
            payload=(i, entries),
            done_markers=(f"data/{chunk_name(split, i, total)}",),
        )
        for i, entries in enumerate(chunks)
    ]
    runner = ShardRunner(
        split, hub, progress_dir, process, upload_batch_size=upload_batch_size
    )
    return runner.run(units)


def _load_engine(args) -> MimiEncoderEngine:
    return engine_from_args(args)


def main(argv=None) -> Dict:
    """Process one split; prints ``{"report", "engine"}`` as one JSON line
    and returns it."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--manifest", required=True)
    ap.add_argument("--split", required=True)
    ap.add_argument("--hub", required=True, help="dir:/path or hf:org/repo")
    ap.add_argument("--progress-dir", required=True)
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_work"))
    ap.add_argument("--layout", default="train", choices=["train", "devtest"])
    ap.add_argument("--chunk-rows", type=int, default=10_000)
    ap.add_argument("--upload-batch-size", type=int, default=4)
    add_engine_args(ap)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    with open(args.manifest) as f:
        manifest = json.load(f)
    engine = _load_engine(args)
    hub = open_hub(args.hub)
    if args.layout == "devtest":
        report = process_split_devtest(
            manifest, args.split, engine, hub, args.progress_dir, args.work_dir
        )
    else:
        report = process_split(
            manifest,
            args.split,
            engine,
            hub,
            args.progress_dir,
            args.work_dir,
            chunk_rows=args.chunk_rows,
            upload_batch_size=args.upload_batch_size,
        )
    stats = engine.stats.as_dict()
    logger.info("report: %s", report)
    logger.info("engine: %s", stats)
    out = {"report": report.__dict__, "engine": stats}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
