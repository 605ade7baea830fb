"""Generic parquet-corpus shard processors: LibriTTS-R, Common Voice,
People's Speech (and any HF-style parquet corpus with embedded audio).

One engine-driven template replaces three near-identical reference scripts
(libritts-r-mimi/process_libritts_r.py, common-voice-mimi/
process_common_voice.py, peoples-speech-mimi/process_peoples_speech.py):
download parquet shard -> decode embedded audio -> resample -> batched Mimi
encode -> `_type1`/`_type2` rows with per-corpus metadata columns -> upload
`{target}` parquet, skip-if-on-hub idempotence.

The ``tts0`` variant reproduces process_libritts_r_tts0.py:215-259: group by
(speaker_id, chapter_id), pair consecutive utterances into 2-turn zero-shot
TTS documents with `[0]` speaker tags and ids `"{id_i}#{id_j}"`.

Run a shard on the CUDA device (``--device cpu`` for the CPU)::

    python -m tokenize_audio_tpu_torch.datasets.parquet_corpus \
        --corpus common_voice --split en --shard-id train-00000 \
        --source-hub dir:/corpus --target-hub dir:/out --progress-dir /progress
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tokenize_audio_tpu_torch.cli import add_engine_args, engine_from_args
from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import codes_to_chars
from tokenize_audio_tpu_torch.datasets.base import asr_document, interleaved_type1, tts_document
from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.io import decode_audio
from tokenize_audio_tpu_torch.io.prefetch import prefetch_map
from tokenize_audio_tpu_torch.runner import ShardProgress

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CorpusSpec:
    name: str
    text_field: str
    id_field: str = "id"
    audio_field: str = "audio"
    meta_fields: Tuple[str, ...] = ()
    # source/target repo path templates, formatted with {split} and {shard}
    source_template: str = "data/{shard}.parquet"
    target_template: str = "data/{shard}.parquet"
    group_fields: Tuple[str, ...] = ()  # tts0 grouping key


SPECS: Dict[str, CorpusSpec] = {
    # parler-tts/libritts_r_filtered schema (process_libritts_r.py:210-234)
    "libritts_r": CorpusSpec(
        name="libritts_r",
        text_field="text_normalized",
        meta_fields=("speaker_id", "chapter_id"),
        group_fields=("speaker_id", "chapter_id"),
    ),
    # fixie-ai/common_voice_17_0 per-language splits (process_common_voice.py)
    "common_voice": CorpusSpec(
        name="common_voice",
        text_field="sentence",
        meta_fields=("client_id",),
        source_template="{split}/{shard}.parquet",
        target_template="{split}/{shard}.parquet",
    ),
    # MLCommons/peoples_speech splits clean/clean_sa/dirty
    "peoples_speech": CorpusSpec(
        name="peoples_speech",
        text_field="text",
        source_template="{split}/{shard}.parquet",
        target_template="{split}/{shard}.parquet",
    ),
}


def _decode_embedded_audio(cell) -> Tuple[np.ndarray, int]:
    """HF parquet audio cells are either {'array','sampling_rate'} or
    {'bytes','path'} containers."""
    if isinstance(cell, dict):
        if cell.get("array") is not None:
            return np.asarray(cell["array"], dtype=np.float32), int(cell["sampling_rate"])
        if cell.get("bytes") is not None:
            return decode_audio(cell["bytes"], raw_int16=True)
        if cell.get("path"):
            return decode_audio(cell["path"], raw_int16=True)
    raise ValueError(f"unsupported audio cell: {type(cell)}")


def _is_device_error(exc: BaseException) -> bool:
    """A CUDA runtime error or a failed kernel build (``ops/cuda/_build``
    raises ``RuntimeError`` naming CUDA or nvcc), as opposed to bad audio.

    Skipping such a batch would hide the card: a kernel that does not build
    fails every batch, and a sticky CUDA error fails every later one, so the
    shard would upload with no rows and report ``processed``. These are
    raised; decode and data errors are still skipped per batch."""
    # torch.AcceleratorError (a RuntimeError) is absent from older torch
    if isinstance(exc, getattr(torch, "AcceleratorError", ())):
        return True
    msg = str(exc).lower()
    return isinstance(exc, RuntimeError) and ("cuda" in msg or "nvcc" in msg)


def encode_samples(
    rows: Sequence[Dict], spec: CorpusSpec, engine: MimiEncoderEngine
) -> List[Dict]:
    """Decode+encode every row -> samples with ``audio_str`` + metadata.
    Per-batch failures skip the batch, like the reference's per-batch
    exception skip (process_common_voice.py:217-221), except a CUDA runtime
    error or a failed kernel build, which is raised (``_is_device_error``).
    Each cell keeps its decoded dtype: float32 for ``{'array'}`` cells,
    int16 for 16-bit ``{'bytes'}`` / ``{'path'}`` WAV and FLAC, which the
    engine ships to the device raw at 24 kHz. The next batch's
    decode runs in a worker thread while the current one encodes (mp3
    decode is ~chip-encode speed per core — serial would halve throughput)."""
    samples: List[Dict] = []
    bs = engine.engine_cfg.batch_size
    chunks = [rows[s : s + bs] for s in range(0, len(rows), bs)]

    def load_chunk(chunk):
        try:
            # decode only; resampling is deferred to the engine, which
            # batches it on device (encode_batch_mixed groups by rate)
            return chunk, [_decode_embedded_audio(r[spec.audio_field]) for r in chunk], None
        except Exception as e:  # noqa: BLE001 — surfaced to the main loop
            return chunk, None, e

    for ci, (chunk, items, err) in enumerate(
        prefetch_map(load_chunk, iter(chunks), workers=1, depth=2)
    ):
        start = ci * bs
        try:
            if err is not None:
                raise err
            codes = engine.encode_batch_mixed(items)
        except Exception as e:  # noqa: BLE001 — skip bad batch, keep the shard alive
            if _is_device_error(e):
                raise
            logger.exception("skipping batch %d-%d", start, start + len(chunk))
            continue
        for r, c in zip(chunk, codes):
            audio_str = codes_to_chars(
                c[:8], CODEBOOK_SIZE, unicode_offset=UNICODE_OFFSET_LARGE
            )
            samples.append(
                {
                    "id": r[spec.id_field],
                    "transcript": str(r[spec.text_field]).strip(),
                    "audio_str": audio_str,
                    **{m: r.get(m) for m in spec.meta_fields},
                }
            )
    return samples


def rows_type12(samples: Sequence[Dict], spec: CorpusSpec) -> List[Dict]:
    out = []
    for s in samples:
        meta = {m: s.get(m) for m in spec.meta_fields}
        out.append(
            {"id": f"{s['id']}_type1", "text": tts_document(s["transcript"], s["audio_str"]), **meta}
        )
        out.append(
            {"id": f"{s['id']}_type2", "text": asr_document(s["transcript"], s["audio_str"]), **meta}
        )
    return out


def rows_tts0(samples: Sequence[Dict], spec: CorpusSpec) -> List[Dict]:
    """Consecutive-pair zero-shot TTS docs (process_libritts_r_tts0.py:215-259)."""
    groups: Dict[tuple, List[Dict]] = defaultdict(list)
    for s in samples:
        groups[tuple(s.get(g) for g in spec.group_fields)].append(s)
    out = []
    for key, group in groups.items():
        meta = dict(zip(spec.group_fields, key))
        for a, b in zip(group, group[1:]):
            ta = a["transcript"].strip().strip('"').strip("'")
            tb = b["transcript"].strip().strip('"').strip("'")
            doc = interleaved_type1(
                [(ta, a["audio_str"]), (tb, b["audio_str"])], speaker_tags=[0, 0]
            )
            out.append({"id": f"{a['id']}#{b['id']}", "text": doc, **meta})
    return out


def process_shard(
    spec: CorpusSpec,
    shard: str,
    split: str,
    source_hub,
    target_hub,
    engine: MimiEncoderEngine,
    work_dir: str,
    progress_dir: str,
    variant: str = "standard",
) -> Dict:
    target_path = spec.target_template.format(split=split, shard=shard)
    progress = ShardProgress(progress_dir, f"{spec.name}_{split or 'all'}")
    if progress.is_completed(shard) or target_hub.exists(target_path):
        progress.mark_completed(shard)
        return {"shard": shard, "status": "skipped"}
    os.makedirs(work_dir, exist_ok=True)
    source_path = spec.source_template.format(split=split, shard=shard)
    local_in = os.path.join(work_dir, f"in_{os.path.basename(source_path)}")
    source_hub.download(source_path, local_in)
    rows = read_parquet(local_in)
    os.unlink(local_in)
    samples = encode_samples(rows, spec, engine)
    if variant == "tts0":
        out_rows = rows_tts0(samples, spec)
    else:
        out_rows = rows_type12(samples, spec)
    local_out = os.path.join(work_dir, f"out_{os.path.basename(target_path)}")
    write_parquet(out_rows, local_out)
    target_hub.upload_file(local_out, target_path)
    if not target_hub.exists(target_path):
        raise RuntimeError(f"upload verification failed: {target_path}")
    os.unlink(local_out)
    progress.mark_completed(shard)
    return {"shard": shard, "status": "processed", "rows": len(out_rows)}


def main(argv=None) -> List[Dict]:
    """Process the named shards; prints the reports as one JSON line and
    returns them."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    ap.add_argument("--corpus", required=True, choices=sorted(SPECS))
    ap.add_argument("--variant", default="standard", choices=["standard", "tts0"])
    ap.add_argument("--shard-id", default=None)
    ap.add_argument("--shard-id-list", default=None, help="file of shard ids")
    ap.add_argument("--split", default="")
    ap.add_argument("--source-hub", required=True)
    ap.add_argument("--target-hub", required=True)
    ap.add_argument(
        "--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_corpus")
    )
    ap.add_argument("--progress-dir", required=True)
    add_engine_args(ap, batch_size=24)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    engine = engine_from_args(args)
    shards = [args.shard_id] if args.shard_id else []
    if args.shard_id_list:
        with open(args.shard_id_list) as f:
            shards += [line.strip() for line in f if line.strip()]
    spec = SPECS[args.corpus]
    src, dst = open_hub(args.source_hub), open_hub(args.target_hub)
    reports = [
        process_shard(
            spec, s, args.split, src, dst, engine, args.work_dir, args.progress_dir, args.variant
        )
        for s in shards
    ]
    print(json.dumps(reports))
    return reports


if __name__ == "__main__":
    main()
