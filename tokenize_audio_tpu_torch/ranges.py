"""The program's own profiler ranges, named ``tokenize_audio::<name>``.

A range is entered only while a ``torch.profiler`` records (a check that
costs a fraction of a microsecond); otherwise ``span`` hands back a
shared no-op context, so the instruments cost nothing measurable on the
untraced path. Inside a recording the ranges sit on the same clock as the
CUDA kernels they launch, so each device gap can be put down to what the
host was doing.

``EngineStats.stage`` (engine/metrics.py) opens one around every timed
stage; ``mimi/model.py`` and the engine open the untimed ones. The module
imports nothing of the package, so the model can use it without importing
the engine.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

PREFIX = "tokenize_audio::"
_NO_RANGE = contextlib.nullcontext()


def recording() -> bool:
    """Whether a profiler records: the process-wide flag that
    ``torch.profiler`` sets at its start. Worker threads see it too, where
    the thread-local ``torch._C._autograd._profiler_enabled()`` reads
    False, and a profiler started with ``profile_all_threads`` records
    their ranges."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, batch: Optional[int] = None):
    """A ``tokenize_audio::<name>`` range while a profiler records, else a
    no-op context. With ``batch``, a second range,
    ``tokenize_audio::batch.<id>``, holds it and carries the engine's batch
    id: a batch's dispatch and collect ranges sit in the same one, while
    their own names stay fixed and aggregate by name, and the named range
    stays the innermost one around the host's work."""
    if not recording():
        return _NO_RANGE
    if batch is None:
        return record_function(PREFIX + name)
    return _tagged(PREFIX + name, f"{PREFIX}batch.{batch}")


@contextlib.contextmanager
def _tagged(name: str, tag: str):
    with record_function(tag), record_function(name):
        yield
