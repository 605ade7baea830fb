"""Emitted-dataset validator: structural QA over token parquet datasets.

Consolidates the reference's scattered output-validity checks into one CLI
(SURVEY §4: is_json_complete, yodas2-mimi/process_shard.py:792-824; the
len%8 invariant, build_yodas2_mm_semantic.py:186-193; converter-side
sanitation, pretraining-data/converter.py:89-140):

  - document grammar: starts <|begin_of_text|>, ends <|end_of_text|>,
    audio/text spans properly paired and non-nested;
  - every audio span decodes through the validating converter with ZERO
    dropped codes and length % num_codebooks == 0;
  - ids unique within a file; required columns present.

    python -m tokenize_audio_tpu_torch.analytics.validate --hub dir:/data/hub \
        --prefix data/ [--num-codebooks 8] [--sample-rows 500]

The port's copy of the JAX package's module of the same path; host code, no
device work.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import re
import tempfile
from typing import Dict, List

from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, NUM_CODEBOOKS, SPECIAL_TOKENS as T, UNICODE_OFFSET_LARGE
from tokenize_audio_tpu_torch.core.codes import chars_to_codes
from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

_AUDIO_SPAN = re.compile(r"<\|audio_start\|>(.*?)<\|audio_end\|>", re.DOTALL)
_ANY_TAG = re.compile(r"<\|(begin_of_text|end_of_text|text_start|text_end|audio_start|audio_end)\|>")


def validate_document(
    text: str,
    num_codebooks: int = NUM_CODEBOOKS,
    codebook_size: int = CODEBOOK_SIZE,
    unicode_offset: int = UNICODE_OFFSET_LARGE,
) -> List[str]:
    """Return a list of problems (empty = valid)."""
    problems: List[str] = []
    if not text.startswith(T["bos"]):
        problems.append("missing bos")
    if not text.endswith(T["eos"]):
        problems.append("missing eos")
    # tag pairing: audio/text spans open+close in order, non-nested. Scan
    # the WHOLE document, collecting every violation (a forensics report on
    # a badly corrupted row must count all the damage, not stop at the
    # first problem); recover by resetting the span state after each one.
    stack: List[str] = []
    for m in _ANY_TAG.finditer(text):
        tag = m.group(1)
        if tag in ("audio_start", "text_start"):
            if stack:
                problems.append(f"nested span at {tag} (offset {m.start()})")
                stack.clear()
            stack.append(tag)
        elif tag in ("audio_end", "text_end"):
            want = tag.replace("_end", "_start")
            if not stack or stack[-1] != want:
                # report the stray close but KEEP the open span: clearing
                # would also orphan the span's legitimate close and count
                # one corruption twice
                problems.append(f"unmatched {tag} (offset {m.start()})")
            else:
                stack.pop()
    if stack:
        problems.append(f"unclosed {stack[-1]}")

    for span in _AUDIO_SPAN.findall(text):
        if len(span) % num_codebooks != 0:
            problems.append(f"audio span length {len(span)} % {num_codebooks} != 0")
            continue
        codes, begin_h, end_h = chars_to_codes(
            span,
            num_codebooks,
            codebook_size,
            return_tensors="np",
            return_hanging_codes_chars=True,
            unicode_offset=unicode_offset,
        )
        if begin_h or end_h or codes.size != len(span):
            problems.append(
                f"audio span has invalid codes ({len(span) - codes.size} dropped)"
            )
    return problems


def validate_rows(rows: List[Dict], num_codebooks: int = NUM_CODEBOOKS) -> Dict:
    report = {"rows": len(rows), "bad_rows": 0, "problems": {}}
    seen = set()
    for r in rows:
        probs = []
        if "id" not in r or "text" not in r:
            probs.append("missing id/text column")
        else:
            # every per-row check runs independently: a null-text row must
            # still be counted for duplicate ids (and vice versa) — elif
            # chaining here undercounted compound damage
            if r["id"] in seen:
                probs.append("duplicate id")
            seen.add(r["id"])
            if not isinstance(r["text"], str):
                # a null/NaN cell (pandas to_dict yields None or float nan)
                # is a bad row to COUNT, not a crash — a QA tool must survive
                # exactly the malformed outputs it exists to report
                probs.append(f"non-string text value ({type(r['text']).__name__})")
            else:
                probs += validate_document(r["text"], num_codebooks)
        if probs:
            report["bad_rows"] += 1
            report["problems"].setdefault(str(r.get("id", "?")), probs)
    return report


def main(argv=None):
    from tokenize_audio_tpu_torch.hub import open_hub

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--prefix", default="")
    ap.add_argument("--num-codebooks", type=int, default=NUM_CODEBOOKS)
    ap.add_argument("--sample-rows", type=int, default=None, help="check a sample per file")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    hub = open_hub(args.hub)
    rng = random.Random(args.seed)
    out = {}
    bad_files = 0
    for f in hub.list_files(args.prefix):
        if not f.endswith(".parquet"):
            continue
        with tempfile.TemporaryDirectory() as td:
            local = os.path.join(td, "x.parquet")
            hub.download(f, local)
            rows = read_parquet(local)
        if args.sample_rows and len(rows) > args.sample_rows:
            rows = rng.sample(rows, args.sample_rows)
        rep = validate_rows(rows, args.num_codebooks)
        out[f] = rep
        if rep["bad_rows"]:
            bad_files += 1
    print(json.dumps(out, indent=1))
    return 1 if bad_files else 0


if __name__ == "__main__":
    raise SystemExit(main())
