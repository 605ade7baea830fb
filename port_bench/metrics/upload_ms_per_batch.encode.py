"""upload_ms_per_batch.encode: the engine's ``dispatch.upload`` stage
seconds in the window per device batch launched in the window
(``EngineStats.batches``), in milliseconds.

The stage is the host's two pageable host-to-device copies of a batch (the
padded audio and its lengths), inside ``dispatch``. A pageable copy is
staged through a pinned bounce buffer and ordered behind the work queued on
the stream, so the stage reads the copy's wait for the device as well as
the host's copying. None where the program counts no batches (a program
without the counter)."""


def read(run):
    s = run.stats
    if s is None or not getattr(s, "batches", 0) or "dispatch.upload" not in s.stage_seconds:
        return None
    return 1000.0 * s.stage_seconds["dispatch.upload"] / s.batches
