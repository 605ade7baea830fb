"""Bounded, order-preserving background prefetch.

Plays the host-concurrency role of the reference's ThreadPoolExecutor over
audio files (yodas2-mimi/process_shard.py:690-717): decode/IO for upcoming
items proceeds on worker threads while the GPU encodes the current one.
Results arrive in input order with at most ``depth`` items in flight, so
memory stays bounded on huge shards.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")


def prefetch_map(
    fn: Callable[[T], R],
    items: Iterable[T],
    workers: int = 2,
    depth: int = 4,
) -> Iterator[R]:
    if workers <= 0:
        for item in items:
            yield fn(item)
        return
    with ThreadPoolExecutor(max_workers=workers) as ex:
        futures: deque = deque()
        it = iter(items)
        exhausted = False
        while True:
            while not exhausted and len(futures) < depth:
                try:
                    item = next(it)
                except StopIteration:
                    # only the ITEM iterator ends the stream; a StopIteration
                    # escaping fn via result() must propagate as a failure,
                    # not silently truncate results
                    exhausted = True
                    break
                futures.append(ex.submit(fn, item))
            if not futures:
                return
            yield futures.popleft().result()
