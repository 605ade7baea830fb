"""stream_ms_per_batch.encode: the engine's ``stream_seconds`` in the
window per device batch launched in the window (``EngineStats.batches``),
in milliseconds.

The program cuts its CUDA stream at marks (timing events) where an
interval of its device work opens and closes: a batch from before its
upload to after its codes' device-to-host copy, and the resample and
streaming work it runs outside batches. ``stream_seconds`` is the time
some interval was open, read from the events once the stream has passed
them. It holds the device's work and any wait of the device for the
host's launches inside a batch, so it is not busy time. On the CPU the
marks are the host's clock. None where the program records no stream
timeline (a program without the counters). The program's instruments are
listed in README.md ("Profiling the port")."""


def read(run):
    s = run.stats
    if s is None or not getattr(s, "batches", 0) or not getattr(s, "stream_seconds", 0.0):
        return None
    return 1000.0 * s.stream_seconds / s.batches
