"""dispatch_ms_per_batch.encode: the engine's ``dispatch`` stage seconds in
the window per device batch launched in the window, in milliseconds.

The stage is host time from the batch's upload to its encode's last
launch, and the upload is a pageable copy ordered behind the work already
queued on the device: where the device is the bottleneck, the stage waits
for it, and this reads the device's pace per batch (backpressure) more
than the host's cost. It falls with less host work per batch only where
the device keeps up.

A call launches the same batches in every unit of a cell (each unit
holds the same lengths), so the window's batches are its units times the
traced segment's ``seanet_encode`` calls per traced unit."""


def read(run):
    if run.stats is None or not run.units or not run.traced_units or not run.traced_rows:
        return None
    batches = len(run.units) * len(run.traced_rows) / len(run.traced_units)
    return 1000.0 * run.stats.stage_seconds.get("dispatch", 0.0) / batches
