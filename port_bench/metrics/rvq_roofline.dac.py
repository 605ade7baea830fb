"""rvq_roofline.dac: the least time the card could take for the traced
segment's ``rvq_encode`` calls (the run's books, each a projection to 8,
the scores against 1024 codewords and a projection back, on the valid
frames; ``pbkit/dac_flops.rvq_call``), over the device time launched
inside their ``port_bench::dac.rvq`` ranges, in percent."""

from pbkit import dac_flops


def read(run):
    return dac_flops.share_of_least_time(
        run, "port_bench::dac.rvq", lambda rows: dac_flops.rvq_call(run.cfg, rows, run.books))
