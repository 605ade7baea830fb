"""seanet_roofline.encode: the least time the card could take for the
traced segment's ``seanet_encode`` calls on their valid columns (per call,
the larger of operations over the float32 peak and bytes over the HBM
bandwidth; ``pbkit/flops.seanet_call`` of the rows' valid lengths the
call was handed), over the device time launched inside those calls'
ranges, in percent."""

from pbkit import flops, peaks, trace

RANGE = "port_bench::seanet_encode"


def read(run):
    if run.trace is None or run.peak is None or not run.traced_rows:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], RANGE)
    if not device_s:
        return None
    least = sum(peaks.bound_seconds(*flops.seanet_call(run.cfg, rows), run.peak)
                for rows in run.traced_rows)
    return 100.0 * least / device_s
