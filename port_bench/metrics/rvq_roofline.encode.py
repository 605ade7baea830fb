"""rvq_roofline.encode: the least time the card could take for the traced
segment's ``split_rvq_encode`` calls (input projections and the chained
distance search of every book, per call the larger of operations over the
float32 peak and bytes over the HBM bandwidth; ``pbkit/flops.rvq_call``),
over the device time launched inside those calls' ranges, in percent.
Each call quantizes the frames of one ``seanet_encode`` call, whose rows'
valid lengths give its frames; where the two ranges' call counts differ,
nothing is read."""

from pbkit import flops, peaks, trace

RANGE = "port_bench::split_rvq_encode"


def read(run):
    if run.trace is None or run.peak is None or not run.traced_rows:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], RANGE)
    if not device_s or trace.lookup(run.trace["range_calls"], RANGE) != len(run.traced_rows):
        return None
    least = sum(peaks.bound_seconds(*flops.rvq_call(run.cfg, rows, run.books), run.peak)
                for rows in run.traced_rows)
    return 100.0 * least / device_s
