"""Operations and bytes of the DAC encode, from the configuration's shapes
and each row's valid length. Frozen, as ``flops.py`` is for Mimi: later
changes to the program do not change what a row of audio costs.

A row of ``n`` samples is encoded as DAC pads it, at ``ceil(n / hop) *
hop`` samples, so every stage's length is exact. Operations count a
multiply and an add as two. A conv of kernel ``k`` from ``cin`` to
``cout`` channels costs ``2 * cout * cin * k`` per output column: the input
k7 conv; per block of C channels three residual units (a dilated k7 and a
k1 conv, C to C) and the strided conv of kernel 2s to 2C at a stride's
worth of fewer columns; the final k3 conv. Per frame and book the
quantizer costs its k1 projections in and out and the scores against the
codebook, ``2 * hidden * dim`` each and ``2 * dim * V``. Biases, Snake,
the normalizations and the masks are not counted. Bytes count each input
byte read once, each output byte written once and the weights once per
call.

At the published widths one sample costs 1,389,440 operations in the
encoder (61.3 GFLOP an audio second at 44.1 kHz) and 864 in the
quantizer at 9 books.
"""

from __future__ import annotations

from typing import Dict, Iterable

UNITS = 3  # residual units a block
K_UNIT = 7  # their dilated conv's kernel


def hop(cfg: Dict) -> int:
    out = 1
    for s in cfg["downsampling_ratios"]:
        out *= s
    return out


def frames(cfg: Dict, n: int) -> int:
    """Code frames of a row of ``n`` samples."""
    return -(-n // hop(cfg))


def encoder_flops(cfg: Dict, n: int) -> float:
    """One row of ``n`` valid samples through ``dac.model.encoder``."""
    length = frames(cfg, n) * hop(cfg)
    c = cfg["encoder_hidden_size"]
    total = 2.0 * c * 1 * 7 * length
    for s in cfg["downsampling_ratios"]:
        total += 2.0 * UNITS * (c * c * K_UNIT + c * c) * length
        length //= s
        total += 2.0 * (2 * c) * c * (2 * s) * length
        c *= 2
    return total + 2.0 * cfg["hidden_size"] * c * 3 * length


def rvq_flops(cfg: Dict, t: int, books: int) -> float:
    """``t`` frames through ``books`` books of the quantizer."""
    h, d, v = cfg["hidden_size"], cfg["codebook_dim"], cfg["codebook_size"]
    return 2.0 * t * books * (h * d + d * v + d * h)


def model_flops(cfg: Dict, n: int, books: int) -> float:
    """One row of ``n`` valid samples through the whole encode."""
    return encoder_flops(cfg, n) + rvq_flops(cfg, frames(cfg, n), books)


def _encoder_weights(cfg: Dict) -> int:
    c = cfg["encoder_hidden_size"]
    w = 7 * c + c
    for s in cfg["downsampling_ratios"]:
        w += UNITS * (c * c * K_UNIT + c + c * c + c + 2 * c) + c
        w += 2 * c * c * 2 * s + 2 * c
        c *= 2
    return w + c + cfg["hidden_size"] * c * 3 + cfg["hidden_size"]


def encoder_call(cfg: Dict, rows: Iterable[int]) -> tuple:
    """(operations, bytes) of one ``encoder`` call on the valid samples of
    ``rows``."""
    rows = list(rows)
    flop = sum(encoder_flops(cfg, n) for n in rows)
    out = sum(frames(cfg, n) for n in rows) * cfg["hidden_size"]
    return flop, 4.0 * (sum(rows) + out + _encoder_weights(cfg))


def rvq_call(cfg: Dict, rows: Iterable[int], books: int) -> tuple:
    """(operations, bytes) of one ``rvq_encode`` call on the valid frames of
    ``rows`` (valid samples per row): the latent read once, each book's
    projections and codebook, the codes written."""
    t = sum(frames(cfg, n) for n in rows)
    h, d, v = cfg["hidden_size"], cfg["codebook_dim"], cfg["codebook_size"]
    weights = books * (2 * h * d + h + d + v * d)
    return rvq_flops(cfg, t, books), 4.0 * (t * h + weights + t * books)


def per_audio_second(cfg: Dict, books: int, seconds: float = 1.0) -> float:
    """Operations per second of audio for one row of ``seconds``."""
    return model_flops(cfg, int(round(seconds * cfg["sampling_rate"])), books) / seconds


def traced_rows(run):
    """Valid samples per row of each ``encoder`` call of the traced segment
    (the driver's notes, read after it), or None without one."""
    notes = getattr(run, "dac_notes", None)
    if run.trace is None or not notes or not notes["encoder"]:
        return None
    if "rows" not in notes:
        notes["rows"] = [
            [t] * b if valid is None else [int(n) for n in valid.tolist()]
            for b, t, valid in notes["encoder"]
        ]
    return notes["rows"]


def share_of_least_time(run, span: str, cost) -> float:
    """The least time the card could take for the traced calls in ``span``
    (``cost(rows)`` -> (operations, bytes) per call, rows of the matching
    ``encoder`` call), over the device time launched inside the span, in
    percent; None without a trace, a peak, or one call in the span for
    each ``encoder`` call."""
    from pbkit import peaks, trace

    rows = traced_rows(run)
    if rows is None or run.peak is None:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], span)
    if not device_s or trace.lookup(run.trace["range_calls"], span) != len(rows):
        return None
    least = sum(peaks.bound_seconds(*cost(r), run.peak) for r in rows)
    return 100.0 * least / device_s
