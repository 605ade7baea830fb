"""lstm_us_per_step.encodec: the device time launched inside the traced
segment's ``port_bench::encodec.lstm`` ranges, in microseconds, over the
sequential steps the program counted in that segment
(``EngineStats.lstm_steps``: each batch's padded frames times its LSTM
layers, a step advancing every row of the batch by one frame in one
layer; ``drivers/encodec_engine.py`` keeps the segment's count as
``run.traced_lstm_steps``)."""

from pbkit import trace


def read(run):
    steps = getattr(run, "traced_lstm_steps", None)
    if run.trace is None or not steps:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], "port_bench::encodec.lstm")
    if not device_s:
        return None
    return 1e6 * device_s / steps
