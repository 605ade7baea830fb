"""launch_ms_per_batch.encode: the engine's ``dispatch.launch`` stage
seconds in the window per device batch launched in the window
(``EngineStats.batches``), in milliseconds.

The stage is the host's call of the model's encode on an uploaded batch:
the Python and launch work of every kernel of the SEANet, transformer,
downsample, RVQ and transfer packing, which returns before the device
runs them. Where it comes near ``stream_ms_per_batch.encode`` the host's
launches set the device's pace. None where the program counts no
batches."""


def read(run):
    s = run.stats
    if s is None or not getattr(s, "batches", 0) or "dispatch.launch" not in s.stage_seconds:
        return None
    return 1000.0 * s.stage_seconds["dispatch.launch"] / s.batches
