"""Parquet writing helpers shared by dataset builders."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence


def write_parquet(rows: Sequence[Dict], path: str) -> str:
    """Write rows to parquet atomically (tmp+rename, the reference's pattern
    at pretraining-data/prepare_pretraining_data.py:760-770)."""
    import pandas as pd

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    pd.DataFrame(list(rows)).to_parquet(tmp, index=False)
    os.replace(tmp, path)
    return path


def read_parquet(path: str) -> List[Dict]:
    import pandas as pd

    return pd.read_parquet(path).to_dict("records")


def chunk_name(split: str, index: int, total: int) -> str:
    """`{split}-{i:05d}-of-{n:05d}.parquet`
    (librispeech-mimi/process_librispeech_train.py:159-176)."""
    return f"{split}-{index:05d}-of-{total:05d}.parquet"
