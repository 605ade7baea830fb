"""rvq_roofline.encodec: the least time the card could take for the traced
segment's ``rvq_encode`` calls (the chained distance search of the run's
books, D 128 and V 1024, on the valid frames; ``pbkit/encodec_flops.
rvq_call``), over the device time launched inside their
``port_bench::encodec.rvq`` ranges (the shared RVQ kernel and the
reshapes around it), in percent."""

from pbkit import encodec_flops


def read(run):
    return encodec_flops.share_of_least_time(
        run, "port_bench::encodec.rvq", lambda rows: encodec_flops.rvq_call(run.cfg, rows, run.books))
