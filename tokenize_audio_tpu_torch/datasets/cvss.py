"""CVSS speech-to-speech-translation combiner.

Capability equivalent of ``cvss-mimi/combine_cvss_mimi.py``: for each of the
21 CVSS-C languages x splits, combine the pre-tokenized S2ST rows
(``id, original_text, original_audio_str, translated_text,
translated_audio_str``) into 4-segment documents

    <|begin_of_text|>
    <|audio_start|>{src audio}<|audio_end|>
    <|text_start|><language>{lang}</language>{src text}<|text_end|>
    <|text_start|><language>en</language>{en text}<|text_end|>
    <|audio_start|>{en audio}<|audio_end|>
    <|end_of_text|>

(combine_cvss_mimi.py:57-78) and write one parquet per split to the hub.
The port's copy of the JAX package's module of the same path; host code,
no device work.

    python -m tokenize_audio_tpu_torch.datasets.cvss --source-hub dir:/data/s2st \
        --target-hub dir:/data/cvss [--languages fr de] [--splits test]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Dict, List, Sequence

from tokenize_audio_tpu_torch.config import SPECIAL_TOKENS
from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
from tokenize_audio_tpu_torch.hub import open_hub

logger = logging.getLogger(__name__)

LANGUAGES = [
    "ar", "ca", "cy", "de", "es", "et", "fa", "fr", "id", "it", "ja",
    "lv", "mn", "nl", "pt", "ru", "sl", "sv-SE", "ta", "tr", "zh-CN",
]
SPLITS = ["train", "validation", "test"]


def combine_row(row: Dict, lang: str) -> str:
    t = SPECIAL_TOKENS
    return (
        f"{t['bos']}"
        f"{t['audio_start']}{row['original_audio_str']}{t['audio_end']}"
        f"{t['text_start']}<language>{lang}</language>{row['original_text']}{t['text_end']}"
        f"{t['text_start']}<language>en</language>{row['translated_text']}{t['text_end']}"
        f"{t['audio_start']}{row['translated_audio_str']}{t['audio_end']}"
        f"{t['eos']}"
    )


def combine_split(
    split: str,
    languages: Sequence[str],
    source_hub,
    target_hub,
    work_dir: str,
    source_template: str = "{lang}/{split}.parquet",
) -> Dict:
    target = f"data/{split}.parquet"
    if target_hub.exists(target):
        return {"split": split, "status": "skipped"}
    os.makedirs(work_dir, exist_ok=True)
    out_rows: List[Dict] = []
    for lang in languages:
        src_path = source_template.format(lang=lang, split=split)
        if not source_hub.exists(src_path):
            logger.warning("missing %s; skipping language", src_path)
            continue
        local = os.path.join(work_dir, f"{lang}_{split}.parquet")
        source_hub.download(src_path, local)
        for row in read_parquet(local):
            out_rows.append({"id": row["id"], "lang": lang, "text": combine_row(row, lang)})
        os.unlink(local)
    local_out = write_parquet(out_rows, os.path.join(work_dir, f"{split}.parquet"))
    target_hub.upload_file(local_out, target)
    os.unlink(local_out)
    return {"split": split, "status": "processed", "rows": len(out_rows)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--source-hub", required=True)
    ap.add_argument("--target-hub", required=True)
    ap.add_argument("--work-dir", default=os.path.join(tempfile.gettempdir(), "ta_cvss"))
    ap.add_argument("--languages", nargs="+", default=LANGUAGES)
    ap.add_argument("--splits", nargs="+", default=SPLITS)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    src, dst = open_hub(args.source_hub), open_hub(args.target_hub)
    reports = [
        combine_split(s, args.languages, src, dst, args.work_dir) for s in args.splits
    ]
    print(json.dumps(reports))


if __name__ == "__main__":
    main()
