"""Derivative datasets: pure string transforms over emitted token
datasets.

Capability equivalents of:
  - ``yodas2-mimi/build_yodas2_mm_asr.py``      -> mode "asr"
  - ``yodas2-mimi/build_yodas2_mm_acoustic.py`` -> mode "acoustic"
  - ``yodas2-mimi/build_yodas2_mm_semantic.py`` -> mode "semantic"
  - ``mls-en-mimi-pretrain/build_mls_en_mm_tts0.py`` -> mode "tts0"
  - ``emilia-mimi/process_shard_fix.py``        -> mode "fix"

Each mode maps parquet shards on a source hub to transformed parquet shards
on a target hub through the resumable ShardRunner. The port's copy of the
JAX package's module of the same path; host code, no device work.

    python -m tokenize_audio_tpu_torch.datasets.derivatives --mode semantic \
        --source-hub dir:/data/pretrain --target-hub dir:/data/semantic \
        --progress-dir /data/progress
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import tempfile
from typing import Dict, List

from tokenize_audio_tpu_torch.config import NUM_CODEBOOKS, SPECIAL_TOKENS as T
from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.runner import ShardRunner, WorkUnit

logger = logging.getLogger(__name__)

_TEXT_SPAN = re.compile(r"<\|text_start\|>.*?<\|text_end\|>", re.DOTALL)
_AUDIO_SPAN = re.compile(r"(<\|audio_start\|>)(.*?)(<\|audio_end\|>)", re.DOTALL)


def filter_type2(rows: List[Dict]) -> List[Dict]:
    """Keep `_type2` rows, stripping the suffix from ids
    (build_yodas2_mm_asr.py:149-166)."""
    out = []
    for r in rows:
        if str(r["id"]).endswith("_type2"):
            r = dict(r)
            r["id"] = r["id"][: -len("_type2")]
            out.append(r)
    return out


def filter_type1(rows: List[Dict]) -> List[Dict]:
    """Keep `_type1` rows, stripping the suffix (build_mls_en_mm_tts0.py)."""
    out = []
    for r in rows:
        if str(r["id"]).endswith("_type1"):
            r = dict(r)
            r["id"] = r["id"][: -len("_type1")]
            out.append(r)
    return out


def remove_text_content(text: str) -> str:
    """Drop every <|text_start|>...<|text_end|> span including tags
    (build_yodas2_mm_acoustic.py:150-165)."""
    return _TEXT_SPAN.sub("", text)


def extract_semantic_tokens(
    text: str, example_id: str = "", num_codebooks: int = NUM_CODEBOOKS
) -> str:
    """Keep the codebook-0 char of every frame inside audio spans — the
    semantic token stream (build_yodas2_mm_semantic.py:169-227). Asserts
    each span length is divisible by num_codebooks."""

    def repl(m: re.Match) -> str:
        content = m.group(2)
        if len(content) % num_codebooks != 0:
            raise ValueError(
                f"Example {example_id}: Audio content length {len(content)} is "
                f"not divisible by {num_codebooks}. First 50 chars: {content[:50]!r}"
            )
        return f"{m.group(1)}{content[::num_codebooks]}{m.group(3)}"

    return _AUDIO_SPAN.sub(repl, text)


def inject_speaker_tag(text: str, tag: int = 0) -> str:
    """Insert '[n]' after every <|text_start|> (build_mls_en_mm_tts0.py:104-116)."""
    return text.replace(T["text_start"], f"{T['text_start']}[{tag}]")


def fix_text_whitespace(text: str) -> str:
    """Strip the stray space after <|text_start|> / before <|text_end|>
    (emilia-mimi/process_shard_fix.py:29-35)."""
    text = text.replace(f"{T['text_start']} ", T["text_start"])
    return text.replace(f" {T['text_end']}", T["text_end"])


def transform_rows(rows: List[Dict], mode: str) -> List[Dict]:
    if mode == "asr":
        return filter_type2(rows)
    if mode == "acoustic":
        rows = filter_type2(rows)
        return [{**r, "text": remove_text_content(r["text"])} for r in rows]
    if mode == "semantic":
        rows = filter_type2(rows)
        return [
            {
                **r,
                "text": extract_semantic_tokens(remove_text_content(r["text"]), r["id"]),
            }
            for r in rows
        ]
    if mode == "tts0":
        rows = filter_type1(rows)
        return [{**r, "text": inject_speaker_tag(r["text"])} for r in rows]
    if mode == "fix":
        return [{**r, "text": fix_text_whitespace(r["text"])} for r in rows]
    raise ValueError(f"unknown mode {mode!r}")


def process_shards(
    mode: str,
    source_hub,
    target_hub,
    progress_dir: str,
    work_dir: str,
    prefix: str = "data/",
    upload_batch_size: int = 4,
):
    """Transform every source parquet under ``prefix`` into the target hub."""
    shards = [f for f in source_hub.list_files(prefix) if f.endswith(".parquet")]

    def process(unit: WorkUnit) -> list:
        repo_path = unit.payload
        local_in = os.path.join(work_dir, "in", os.path.basename(repo_path))
        source_hub.download(repo_path, local_in)
        rows = transform_rows(read_parquet(local_in), mode)
        os.unlink(local_in)
        local_out = os.path.join(work_dir, "out", os.path.basename(repo_path))
        write_parquet(rows, local_out)
        return [(local_out, repo_path)]

    units = [WorkUnit(s, payload=s, done_markers=(s,)) for s in shards]
    runner = ShardRunner(
        f"derive-{mode}", target_hub, progress_dir, process, upload_batch_size=upload_batch_size
    )
    return runner.run(units)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--mode", required=True, choices=["asr", "acoustic", "semantic", "tts0", "fix"])
    ap.add_argument("--source-hub", required=True)
    ap.add_argument("--target-hub", required=True)
    ap.add_argument("--progress-dir", required=True)
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_derive"))
    ap.add_argument("--prefix", default="data/")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = process_shards(
        args.mode,
        open_hub(args.source_hub),
        open_hub(args.target_hub),
        args.progress_dir,
        args.work_dir,
        prefix=args.prefix,
    )
    logger.info("report: %s", report)
    return report


if __name__ == "__main__":
    main()
