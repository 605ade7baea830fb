"""lstm_roofline.encodec: the least time the card could take for the
traced segment's ``lstm_apply`` calls (both layers' input and recurrent
products on the valid frames, per call the larger of operations over the
float32 peak and bytes over the HBM bandwidth; ``pbkit/encodec_flops.
lstm_call``), over the device time launched inside their
``port_bench::encodec.lstm`` ranges, in percent. A call's valid frames
are those of the ``seanet_encode`` call before it."""

from pbkit import encodec_flops


def read(run):
    return encodec_flops.share_of_least_time(
        run, "port_bench::encodec.lstm", lambda rows: encodec_flops.lstm_call(run.cfg, rows))
