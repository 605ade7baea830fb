"""stream_idle.encode: the share of the window in which the engine's CUDA
stream had nothing of the engine's queued, in percent: the engine's
``stream_idle_seconds`` over the window's wall seconds.

The program sums the time between the marks on its stream at which no
interval of its device work was open (batches, and the resample and
streaming work it runs outside them), read once the stream has passed
them. It is the idle between batches: padding, upload staging and the
host's work between calls. ``device_idle.encode`` less this share is the
idle inside the batches, where the device waits on the host's launches.
None where the program records no stream timeline. The program's
instruments are listed in README.md ("Profiling the port")."""


def read(run):
    s = run.stats
    if s is None or not run.window_s or not getattr(s, "stream_seconds", 0.0):
        return None
    return 100.0 * s.stream_idle_seconds / run.window_s
