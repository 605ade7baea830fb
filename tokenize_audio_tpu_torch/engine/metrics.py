"""Throughput accounting for the encode engine.

The reference has no metrics beyond tqdm (SURVEY §5); here every stage is
counted so ``audio-hours tokenized per wall hour per chip`` — the BASELINE
north-star — falls out directly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


@dataclasses.dataclass
class EngineStats:
    audio_seconds: float = 0.0
    utterances: int = 0
    frames: int = 0
    padded_frames: int = 0  # bucket waste accounting
    transient_retries: int = 0  # device batches re-dispatched after a fault
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    started_at: float = dataclasses.field(default_factory=time.perf_counter)
    # decode-prefetch worker threads update stages concurrently with the
    # main loop; guard the read-modify-write
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.stage_seconds[name] += dt

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self.started_at

    @property
    def realtime_factor(self) -> float:
        """Audio seconds tokenized per wall second (== audio-hours/hour)."""
        w = self.wall_seconds
        return self.audio_seconds / w if w > 0 else 0.0

    @property
    def bucket_efficiency(self) -> float:
        """Valid frames / padded frames actually encoded."""
        return self.frames / self.padded_frames if self.padded_frames else 1.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "audio_seconds": round(self.audio_seconds, 3),
            "utterances": self.utterances,
            "frames": self.frames,
            "wall_seconds": round(self.wall_seconds, 3),
            "realtime_factor": round(self.realtime_factor, 2),
            "bucket_efficiency": round(self.bucket_efficiency, 4),
            "transient_retries": self.transient_retries,
            **{f"stage_{k}": round(v, 3) for k, v in self.stage_seconds.items()},
        }
