"""Shared network plumbing: backoff retry and streaming download.

One implementation of the reference's retry/backoff contract
(common-voice-mimi/process_common_voice.py:40-79 exponential backoff with
jitter; yodas2-mimi/process_shard.py:313-341 streaming download with 2^k
backoff), used by both the HF hub store and the raw-URL YODAS2 source.
"""

from __future__ import annotations

import logging
import os
import random
import time
from typing import Callable, Optional, Tuple, Type

logger = logging.getLogger(__name__)


def retry_with_backoff(
    fn: Callable,
    what: str,
    max_retries: int = 5,
    base_delay: float = 2.0,
    log: Optional[logging.Logger] = None,
    fatal: Tuple[Type[BaseException], ...] = (),
):
    """Run ``fn`` with exponential backoff + jitter; ``fatal`` exception
    types are re-raised immediately (permanent errors like not-found must
    not burn a minute of retries)."""
    log = log or logger
    for attempt in range(max_retries):
        try:
            return fn()
        except fatal:
            raise
        except Exception as e:  # noqa: BLE001 — network stacks raise many types
            if attempt == max_retries - 1:
                raise
            delay = base_delay * (2**attempt) + random.uniform(0, 1)
            log.warning(
                "%s failed (%s: %s); retry %d/%d in %.1fs",
                what,
                type(e).__name__,
                e,
                attempt + 1,
                max_retries,
                delay,
            )
            time.sleep(delay)


def stream_to_file(get_response: Callable, dest: str) -> str:
    """Stream an open requests response (factory returns a context manager)
    to ``dest`` atomically (tmp + os.replace)."""
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    with get_response() as r:
        r.raise_for_status()
        tmp = f"{dest}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            for chunk in r.iter_content(1 << 20):
                f.write(chunk)
        os.replace(tmp, dest)
    return dest
