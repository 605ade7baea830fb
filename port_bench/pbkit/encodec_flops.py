"""Operations and bytes of the EnCodec encode, from the configuration's
shapes and each row's valid length. Frozen, as ``flops.py`` is for Mimi:
later changes to the program do not change what a row of audio costs.

Operations count a multiply and an add as two, on the valid samples only.
A causal conv of kernel ``k`` from ``cin`` to ``cout`` channels costs
``2 * cout * cin * k`` per output sample; a strided conv has
``ceil(n / stride)`` outputs for ``n`` inputs. A resblock is its k3 and k1
convs and its k1 shortcut. The LSTM costs ``2 * 4H * (I + H)`` per frame
and layer (the input and the recurrent products of its four gates). The
RVQ counts ``2 * D * V`` per frame and book for the distances. Biases,
activations and the gates' elementwise work are not counted. Bytes count
each input byte read once, each output byte written once and the weights
once per call.

At the published widths one second of 24 kHz audio (75 frames) costs
2.28 GFLOP in the SEANet, 0.63 in the LSTM, 0.069 in the final conv and
0.157 in the RVQ at 8 books: 3.14 in all.
"""

from __future__ import annotations

from typing import Dict, Iterable, List


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def strides(cfg: Dict) -> List[int]:
    return list(reversed(cfg["upsampling_ratios"]))


def lstm_size(cfg: Dict) -> int:
    return cfg["num_filters"] * 2 ** len(cfg["upsampling_ratios"])


def frames(cfg: Dict, n: int) -> int:
    """75 Hz frames of a row of ``n`` samples."""
    for s in strides(cfg):
        n = _ceil(n, s)
    return n


def seanet_flops(cfg: Dict, n: int) -> float:
    """One row of ``n`` valid samples through the input conv and the four
    stages (``encodec.model.seanet_encode``)."""
    nf = cfg["num_filters"]
    total = 2.0 * nf * cfg["audio_channels"] * cfg["kernel_size"] * n
    c, length = nf, n
    for s in strides(cfg):
        hidden = c // cfg["compress"]
        per = hidden * c * cfg["residual_kernel_size"] + c * hidden
        if cfg["use_conv_shortcut"]:
            per += c * c
        total += 2.0 * cfg["num_residual_layers"] * per * length
        length = _ceil(length, s)
        total += 2.0 * (2 * c) * c * (2 * s) * length
        c *= 2
    return total


def lstm_flops(cfg: Dict, t: int) -> float:
    """``t`` frames through every LSTM layer."""
    h = lstm_size(cfg)
    return 2.0 * 4 * h * (h + h) * t * cfg["num_lstm_layers"]


def project_flops(cfg: Dict, t: int) -> float:
    return 2.0 * cfg["hidden_size"] * lstm_size(cfg) * cfg["last_kernel_size"] * t


def rvq_flops(cfg: Dict, t: int, books: int) -> float:
    d = cfg.get("codebook_dim") or cfg["hidden_size"]
    return 2.0 * t * d * cfg["codebook_size"] * books


def model_flops(cfg: Dict, n: int, books: int) -> float:
    """One row of ``n`` valid 24 kHz samples through the whole encode."""
    t = frames(cfg, n)
    return seanet_flops(cfg, n) + lstm_flops(cfg, t) + project_flops(cfg, t) + rvq_flops(cfg, t, books)


def _seanet_weights(cfg: Dict) -> int:
    nf = cfg["num_filters"]
    w = nf * cfg["audio_channels"] * cfg["kernel_size"] + nf
    c = nf
    for s in strides(cfg):
        h = c // cfg["compress"]
        per = h * c * cfg["residual_kernel_size"] + h + c * h + c
        if cfg["use_conv_shortcut"]:
            per += c * c + c
        w += cfg["num_residual_layers"] * per + 2 * c * c * 2 * s + 2 * c
        c *= 2
    return w


def seanet_call(cfg: Dict, rows: Iterable[int]) -> tuple:
    """(operations, bytes) of one ``seanet_encode`` call on the valid
    samples of ``rows``."""
    rows = list(rows)
    flop = sum(seanet_flops(cfg, n) for n in rows)
    out = sum(frames(cfg, n) for n in rows) * lstm_size(cfg)
    return flop, 4.0 * (sum(rows) + out + _seanet_weights(cfg))


def lstm_call(cfg: Dict, rows: Iterable[int]) -> tuple:
    """(operations, bytes) of one ``lstm_apply`` call on the valid frames
    of ``rows`` (valid samples per row)."""
    t = sum(frames(cfg, n) for n in rows)
    h = lstm_size(cfg)
    weights = cfg["num_lstm_layers"] * (2 * 4 * h * h + 2 * 4 * h)
    return lstm_flops(cfg, t), 4.0 * (2 * t * h + weights)


def rvq_call(cfg: Dict, rows: Iterable[int], books: int) -> tuple:
    """(operations, bytes) of one ``rvq_encode`` call: the chained distance
    search of ``books`` books on the valid frames of ``rows``."""
    t = sum(frames(cfg, n) for n in rows)
    d, v = cfg.get("codebook_dim") or cfg["hidden_size"], cfg["codebook_size"]
    return rvq_flops(cfg, t, books), 4.0 * (t * d + books * v * (d + 1) + t * books)


def per_audio_second(cfg: Dict, books: int, seconds: float = 1.0, rate: int = 24_000) -> float:
    """Operations per second of audio for one row of ``seconds``."""
    return model_flops(cfg, int(round(seconds * rate)), books) / seconds


def traced_rows(run):
    """Valid samples per row of each ``seanet_encode`` call of the traced
    segment (the driver's notes, read after it), or None without one."""
    notes = getattr(run, "encodec_notes", None)
    if run.trace is None or not notes or not notes["seanet_encode"]:
        return None
    if "rows" not in notes:
        notes["rows"] = [
            [t] * b if valid is None else [int(n) for n in valid.tolist()]
            for b, t, valid in notes["seanet_encode"]
        ]
    return notes["rows"]


def share_of_least_time(run, span: str, cost) -> float:
    """The least time the card could take for the traced calls in ``span``
    (``cost(rows)`` -> (operations, bytes) per call, rows of the matching
    ``seanet_encode`` call), over the device time launched inside the
    span, in percent; None without a trace, a peak, or one call in the
    span for each ``seanet_encode`` call."""
    from pbkit import peaks, trace

    rows = traced_rows(run)
    if rows is None or run.peak is None:
        return None
    device_s = trace.lookup(run.trace["range_device_s"], span)
    if not device_s or trace.lookup(run.trace["range_calls"], span) != len(rows):
        return None
    least = sum(peaks.bound_seconds(*cost(r), run.peak) for r in rows)
    return 100.0 * least / device_s
