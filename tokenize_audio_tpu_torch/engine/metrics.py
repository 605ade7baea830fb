"""Throughput accounting for the encode engine.

The reference has no metrics beyond tqdm (SURVEY §5); here every stage is
counted so ``audio-hours tokenized per wall hour per chip`` — the BASELINE
north-star — falls out directly.

Every stage is also the program's profiler range (``ranges.span``): while
a ``torch.profiler`` records, ``stage(name)`` opens
``tokenize_audio::<name>`` around the timed block.

The engine's stream counters come from its ``StreamTimeline``: marks put
on the engine's stream where an interval of its device work opens and
closes (a batch from before its upload to after its codes' device-to-host
copy; a resample; a streaming group), read once the stream has passed
them, so they add no wait. ``stream_seconds`` sums the time some interval
was open (device work, and any wait of the device for the host's launches
inside it); ``stream_idle_seconds`` the time none was, when the stream had
nothing of the engine's queued. On the CPU each op runs on the calling
thread, and the marks are readings of the host's clock.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from tokenize_audio_tpu_torch.ranges import span


@dataclasses.dataclass
class EngineStats:
    audio_seconds: float = 0.0
    utterances: int = 0
    frames: int = 0
    padded_frames: int = 0  # bucket waste accounting
    transient_retries: int = 0  # device batches re-dispatched after a fault
    batches: int = 0  # device batches launched, a retry's re-dispatch too
    stream_seconds: float = 0.0  # time the stream held some interval's work
    stream_idle_seconds: float = 0.0  # time it held none (StreamTimeline)
    # batches whose transformer stack (Mimi) was captured as a CUDA graph,
    # and replayed from one (graphs.py); both 0 where no graph runs
    transformer_graph_captures: int = 0
    transformer_graph_replays: int = 0
    # sequential steps of a recurrence over the frames (EnCodec's LSTM):
    # per batch dispatched, its padded frames a row times the layers; 0
    # for a model without one
    lstm_steps: int = 0
    stage_seconds: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float)
    )
    # perf_counter at the first encode call's start (start_clock), so the
    # engine's construction, warm-up and autotune probes stay out of
    # wall_seconds and realtime_factor
    started_at: Optional[float] = None
    # decode-prefetch worker threads update stages concurrently with the
    # main loop; guard the read-modify-write
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock, repr=False)

    @contextmanager
    def stage(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                with self._lock:
                    self.stage_seconds[name] += dt

    def start_clock(self) -> None:
        """Open the wall-clock window, once: the engine calls it at the
        start of each encode call, before it counts the call's audio."""
        if self.started_at is None:
            self.started_at = time.perf_counter()

    @property
    def wall_seconds(self) -> float:
        if self.started_at is None:
            return 0.0
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
            "batches": self.batches,
            "stream_seconds": round(self.stream_seconds, 3),
            "stream_idle_seconds": round(self.stream_idle_seconds, 3),
            "transformer_graph_captures": self.transformer_graph_captures,
            "transformer_graph_replays": self.transformer_graph_replays,
            "lstm_steps": self.lstm_steps,
            **{f"stage_{k}": round(v, 3) for k, v in self.stage_seconds.items()},
        }


class _HostMark:
    """A reading of the host's clock in place of a CUDA event, where each
    op runs on the thread that calls it: done once it exists."""

    __slots__ = ("t",)

    def __init__(self):
        self.t = time.perf_counter()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostMark") -> float:
        return (end.t - self.t) * 1e3


class StreamTimeline:
    """The engine's stream cut at the marks its intervals of device work
    open and close at. Between two consecutive marks the stream was busy if
    some interval was open and idle if none was, so intervals that overlap
    (a ``finish()`` worker's streaming group beside the main thread's next
    batches, or a retry's re-dispatch from a fetch thread) count once, and
    the busy and idle seconds add up to the time from the first mark to the
    last. Every mark is put under one lock, so their order on the stream is
    the order here. A segment is read once the stream has passed its end
    mark (``query``), so reading never waits."""

    def __init__(self, device: torch.device):
        self._device = device
        self._lock = threading.Lock()
        self._last = None  # the latest mark
        self._open = 0  # intervals open at it
        self._pending: deque = deque()  # (from mark, to mark, busy), unread

    def _mark(self):
        if self._device.type != "cuda":
            return _HostMark()
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def _step(self, delta: int):
        with self._lock:
            mark = self._mark()
            if self._last is not None:
                self._pending.append((self._last, mark, self._open > 0))
            self._last = mark
            self._open += delta
        return mark

    def open(self) -> None:
        """Mark the start of an interval of the engine's device work."""
        self._step(1)

    def close(self):
        """Mark its end, after its last queued op; returns the mark (on
        CUDA, the event the host waits on for the interval's results)."""
        return self._step(-1)

    def read(self, stats: EngineStats) -> None:
        """Add every segment the stream has passed to ``stats``."""
        busy = idle = 0.0
        with self._lock:
            while self._pending and self._pending[0][1].query():
                a, b, on = self._pending.popleft()
                dt = a.elapsed_time(b) / 1e3
                if on:
                    busy += dt
                else:
                    idle += dt
        with stats._lock:
            stats.stream_seconds += busy
            stats.stream_idle_seconds += idle
