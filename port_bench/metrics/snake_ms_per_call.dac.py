"""snake_ms_per_call.dac: the device time launched inside the traced
segment's ``port_bench::dac.snake`` ranges (every Snake of the encoder,
29 a batch at the published widths), in milliseconds, per traced call of
``encode_batch``."""

from pbkit import trace


def read(run):
    if run.trace is None or not run.traced_units:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], "port_bench::dac.snake")
    if not device_s:
        return None
    return 1e3 * device_s / len(run.traced_units)
