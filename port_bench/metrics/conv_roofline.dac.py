"""conv_roofline.dac: the least time the card could take for the traced
segment's ``encoder`` calls (the input conv, the four blocks' convs and the
final conv on the whole-frame valid samples each call was handed;
``pbkit/dac_flops.encoder_call``), over the device time launched inside
their ``port_bench::dac.encoder`` ranges (Snakes and masks included), in
percent."""

from pbkit import dac_flops


def read(run):
    return dac_flops.share_of_least_time(
        run, "port_bench::dac.encoder", lambda rows: dac_flops.encoder_call(run.cfg, rows))
