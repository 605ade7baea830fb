"""mfu.dac: the model operations of the valid audio the engine encoded in
the window (``pbkit/dac_flops.model_flops`` of every utterance of every
call: the encoder and the quantizer), over the window's wall seconds, as a
share of the card's float32 peak, in percent."""

from pbkit import dac_flops


def read(run):
    if run.peak is None or not run.units:
        return None
    op = sum(dac_flops.model_flops(run.cfg, n, run.books) for u in run.units for n in u["rows"])
    return 100.0 * op / run.window_s / run.peak["fp32_flops"]
