"""fetch_wait_ms_per_batch.encode: the engine's ``fetch.wait`` stage
seconds in the window per device batch launched in the window
(``EngineStats.batches``), in milliseconds.

The stage is the host's wait on a batch's done event, recorded after its
codes' device-to-host copy, before it trims the codes: the time the host
had nothing to do but wait for the device. None where the program counts
no batches."""


def read(run):
    s = run.stats
    if s is None or not getattr(s, "batches", 0) or "fetch.wait" not in s.stage_seconds:
        return None
    return 1000.0 * s.stage_seconds["fetch.wait"] / s.batches
