"""Plain YODAS2 chunk slicer: a chunk id ``{audio}-{idx:05d}-{start_cs:08d}-
{end_cs:08d}`` names centiseconds of its audio, cut at
``int(cs * rate / 100)`` samples (yodas2-mimi/process_shard.py:400-435).
Degenerate (start == end) and empty chunks are skipped. It imports nothing
of the program.
"""

from __future__ import annotations

from typing import Optional, Tuple


def bounds(chunk_id: str, rate: int, n: int) -> Optional[Tuple[int, int]]:
    """Sample bounds of ``chunk_id`` in audio of ``n`` samples at ``rate``,
    or None where the chunk holds no sample."""
    start_cs, end_cs = (int(p) for p in chunk_id.rsplit("-", 3)[2:])
    if start_cs >= end_cs:
        return None
    a, b = int(start_cs * rate / 100), min(int(end_cs * rate / 100), n)
    return (a, b) if b > a else None
