"""conv_roofline.encodec: the least time the card could take for the
traced segment's ``seanet_encode`` calls (the input conv and the four
stages' convs on the valid samples the call was handed; ``pbkit/
encodec_flops.seanet_call``), over the device time launched inside their
``port_bench::encodec.seanet_encode`` ranges, in percent."""

from pbkit import encodec_flops


def read(run):
    return encodec_flops.share_of_least_time(
        run, "port_bench::encodec.seanet_encode",
        lambda rows: encodec_flops.seanet_call(run.cfg, rows))
