"""Dataset row counting from parquet metadata only.

Capability equivalent of ``pretraining-data/count_dataset_rows.py``: read
each parquet file's footer metadata (num_rows) without materializing data
(:66-88), aggregate per prefix, and emit a markdown stats table
(:147-208). The port's copy of the JAX package's module of the same path;
host code, no device work.

    python -m tokenize_audio_tpu_torch.analytics.count_rows --hub dir:/data/pretrain \
        [--prefix data/] [--group-depth 1] [--markdown] [--tokens-json est.json]
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict


def count_parquet_rows(path: str) -> int:
    import pyarrow.parquet as pq

    return pq.ParquetFile(path).metadata.num_rows


class RangeReader:
    """Seekable read-only file over ``ArtifactStore.read_range``.

    Gives pyarrow random access to remote parquet without a download: a
    ParquetFile open touches only the footer (two ranged reads), and a
    row-group read touches only that group's byte span. ``bytes_read``
    counts actual transfer so callers/tests can assert the savings.
    """

    def __init__(self, hub, repo_path: str):
        self.hub = hub
        self.repo_path = repo_path
        self._size = hub.size(repo_path)
        self._pos = 0
        self.bytes_read = 0
        self.closed = False

    def size(self) -> int:
        return self._size

    def tell(self) -> int:
        return self._pos

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return False

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        return self._pos

    def read(self, nbytes: int = -1) -> bytes:
        if nbytes is None or nbytes < 0:
            nbytes = self._size - self._pos
        nbytes = max(0, min(nbytes, self._size - self._pos))
        if nbytes == 0:
            return b""
        data = self.hub.read_range(self.repo_path, self._pos, nbytes)
        self._pos += len(data)
        self.bytes_read += len(data)
        return data

    def close(self) -> None:
        self.closed = True


def count_parquet_rows_remote(hub, repo_path: str) -> int:
    """num_rows from the parquet footer alone — ranged reads, no download
    (the reference's count_dataset_rows.py:66-88 contract)."""
    import pyarrow.parquet as pq

    return pq.ParquetFile(RangeReader(hub, repo_path)).metadata.num_rows


def count_hub_dataset(hub, prefix: str = "", group_depth: int = 1) -> Dict[str, Dict]:
    """Count rows of every parquet under prefix, grouped by the first
    ``group_depth`` path components. Metadata-only: transfers ~KBs per file
    regardless of file size."""
    groups: Dict[str, Dict] = defaultdict(lambda: {"files": 0, "rows": 0})
    for f in hub.list_files(prefix):
        if not f.endswith(".parquet"):
            continue
        parts = f.split("/")
        key = "/".join(parts[:group_depth]) if group_depth else "all"
        rows = count_parquet_rows_remote(hub, f)
        groups[key]["files"] += 1
        groups[key]["rows"] += rows
    return dict(groups)


def stats_markdown(groups: Dict[str, Dict], tokens: Dict[str, int] | None = None) -> str:
    """Stats table; with ``tokens`` (group -> token count, or
    estimate_tokens output) adds a Num Tokens column — groups without an
    estimate show "XXX" and only existing counts sum into the total
    (update_stats_with_tokens.py:77-118 semantics)."""
    if tokens is not None:
        tokens = {
            k: (v.get("estimated_total_tokens") if isinstance(v, dict) else int(v))
            for k, v in tokens.items()
            if not k.startswith("_")
        }
        lines = ["| group | files | rows | num tokens |", "|---|---:|---:|---:|"]
    else:
        lines = ["| group | files | rows |", "|---|---:|---:|"]
    total_f = total_r = total_t = 0
    for key in sorted(groups):
        g = groups[key]
        if tokens is not None:
            t = tokens.get(key)
            cell = f"{t:,}" if t is not None else "XXX"
            lines.append(f"| {key} | {g['files']} | {g['rows']:,} | {cell} |")
            total_t += t or 0
        else:
            lines.append(f"| {key} | {g['files']} | {g['rows']:,} |")
        total_f += g["files"]
        total_r += g["rows"]
    if tokens is not None:
        lines.append(f"| **total** | {total_f} | {total_r:,} | {total_t:,} |")
    else:
        lines.append(f"| **total** | {total_f} | {total_r:,} |")
    return "\n".join(lines)


def main(argv=None):
    from tokenize_audio_tpu_torch.hub import open_hub

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--prefix", default="")
    ap.add_argument("--group-depth", type=int, default=1)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument(
        "--tokens-json",
        help="estimate_tokens output JSON: adds a Num Tokens column to the "
        "markdown table (XXX for groups lacking an estimate)",
    )
    args = ap.parse_args(argv)
    groups = count_hub_dataset(open_hub(args.hub), args.prefix, args.group_depth)
    tokens = None
    if args.tokens_json:
        with open(args.tokens_json) as f:
            tokens = json.load(f)
    if args.markdown or tokens is not None:
        print(stats_markdown(groups, tokens))
    else:
        print(json.dumps(groups, indent=1))


if __name__ == "__main__":
    main()
