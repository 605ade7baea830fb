"""Driver of the EnCodec engine cells: ``MimiEncoderEngine.encode_batch`` on
an ``EncodecConfig``, alone, in a closed loop. A unit of work is one call
on one set of the mix's utterances; the sets are taken in turn.

The engine is built on the program's ``EncodecConfig`` from the
configuration file's shape keys, with weights from
``reference/encodec_weights.py`` loaded through the program's own
checkpoint converter. The traced segment puts ``port_bench::encodec.*``
ranges around the model's ``seanet_encode``, ``lstm_apply`` and
``rvq_encode`` (looked up in their module at every call) and notes the
rows, valid lengths and padded frames of each ``seanet_encode`` and
``rvq_encode`` call in ``run.encodec_notes``; ``release`` keeps the
sequential LSTM steps the program counted in the traced segment
(``EngineStats.lstm_steps``) as ``run.traced_lstm_steps``.

The check compares, for a sample of the window's utterances drawn from
the seed (the longest utterance among them), the codes the calls returned
with the plain reference's quantizer input for the same audio
(``reference/encodec_ref.py``), and checks the shape and range of every
code the window and the traced segment returned, under the names and
limits of ``pbkit/checks.py``.

A run whose mode asks for TF32 (``matmul_precision`` other than
"highest", the control of ``control.py``) builds the engine at IEEE
precision, which is all EnCodec's engine accepts, and switches the
model's precision hold to TF32 for the whole run: the program's own path
one precision below the configuration's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from pbkit import checks, traffic
from reference import encodec_ref, encodec_weights


def encodec_config(cfg: dict, mode: dict):
    """The program's ``EncodecConfig`` for a configuration file: its shape
    keys and the run modes it has, at IEEE float32."""
    from tokenize_audio_tpu_torch.encodec.config import EncodecConfig

    keys = {f.name for f in dataclasses.fields(EncodecConfig)}
    kw = {k: v for k, v in {**cfg, **mode}.items() if k in keys}
    kw["matmul_precision"] = "highest"
    return EncodecConfig(**kw)


def _hold_tf32(run) -> None:
    """Switch the model's IEEE hold to TF32 until ``release``."""
    from tokenize_audio_tpu_torch.encodec import model

    run.saved_hold = model.fp32_precision
    model.fp32_precision = lambda mode: run.saved_hold("tf32")


def setup(run) -> None:
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.encodec.weights import convert_hf_state_dict
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

    run.rate = run.mix["sample_rate"]
    ecfg = encodec_config(run.cfg, run.mode)
    if ecfg.books_for_bandwidth(run.mode["bandwidth_kbps"]) != run.books:
        raise ValueError("num_codebooks is not the bandwidth's")
    if run.mode.get("matmul_precision", "highest") != "highest":
        _hold_tf32(run)
    sd = encodec_weights.state_dict(run.cfg, run.seed, run.device)
    run.engine = MimiEncoderEngine(
        convert_hf_state_dict(sd, ecfg), ecfg, EngineConfig(**run.params["engine"]),
        num_codebooks=run.books, device=run.device,
    )
    run.sets = traffic.engine_sets(run.mix, run.seed, run.device)
    run.set_rows = [[-(-len(a) * 24_000 // run.rate) for a in s] for s in run.sets]
    # warm-up: one call of the cell's own traffic; every set has the same
    # lengths, so it launches every batch shape the window will
    run.engine.encode_batch(run.sets[0], sr=run.rate)


def reset_stats(run) -> None:
    from tokenize_audio_tpu_torch.engine import EngineStats

    run.engine.stats = EngineStats()


def stats(run):
    return run.engine.stats


def _seanet_note(params, cfg, x, valid=None, *args, **kwargs) -> tuple:
    return x.shape[0], x.shape[-1], valid


def _rvq_note(params, x, num_quantizers, *args, **kwargs) -> tuple:
    return x.shape[0], x.shape[-1], num_quantizers


def span_targets(run) -> list:
    from tokenize_audio_tpu_torch.encodec import model

    run.encodec_notes = {"seanet_encode": [], "rvq_encode": []}
    notes = run.encodec_notes
    return [
        (run.engine, "encode_batch", "engine.encode_batch"),
        (run.engine, "_dispatch", "engine.dispatch"),
        (run.engine, "_collect", "engine.collect"),
        (model, "seanet_encode", "encodec.seanet_encode", _seanet_note, notes["seanet_encode"]),
        (model, "lstm_apply", "encodec.lstm"),
        (model, "rvq_encode", "encodec.rvq", _rvq_note, notes["rvq_encode"]),
    ]


def unit(run, i: int) -> dict:
    s = i % len(run.sets)
    codes = run.engine.encode_batch(run.sets[s], sr=run.rate)
    return {
        "set": s,
        "audio_s": sum(len(a) for a in run.sets[s]) / run.rate,
        "items": len(run.sets[s]),
        "rows": run.set_rows[s],
        "codes": codes,
    }


def release(run) -> None:
    if run.trace is not None:
        # the window's counters were copied at its close; the traced
        # segment went on counting into the engine's own
        run.traced_lstm_steps = run.engine.stats.lstm_steps - run.stats.lstm_steps
    saved = getattr(run, "saved_hold", None)
    if saved is not None:
        from tokenize_audio_tpu_torch.encodec import model

        model.fp32_precision = saved
        run.saved_hold = None
    run.engine = None


class _Reference(checks.Reference):
    """``checks.Reference``'s shape test and result on EnCodec's plain
    reference and weights."""

    def __init__(self, run):
        self.run = run
        self.cfg = run.cfg
        self.sd = encodec_weights.state_dict(run.cfg, run.seed, run.device)
        self.spf = math.prod(run.cfg["upsampling_ratios"])

    def gap(self, audio: torch.Tensor, codes) -> float:
        emb = encodec_ref.embeddings(self.sd, self.cfg, audio)
        c = torch.from_numpy(np.asarray(codes, dtype=np.int64)).to(emb.device)
        return float(encodec_ref.code_gaps(self.sd, self.cfg, emb, c).max())


def check(run) -> dict:
    """The compared numbers, and the items attempted and failed."""
    ref = _Reference(run)
    bad = 0
    for u in run.units + run.traced_units:
        got = u["codes"]
        if len(got) != u["items"]:
            bad += u["items"]
            continue
        bad += sum(not ref.well_formed(c, len(a)) for a, c in zip(run.sets[u["set"]], got))
    pool = [(k, j) for k, u in enumerate(run.units) for j in range(u["items"])]
    lens = [len(run.sets[run.units[k]["set"]][j]) for k, j in pool]
    gaps = []
    for k, j in checks.sample(run, pool, lens):
        u = run.units[k]
        a, c = run.sets[u["set"]][j], u["codes"][j]
        if ref.well_formed(c, len(a)):
            audio = torch.from_numpy(a).to(run.device).float() / 32768.0
            gaps.append(ref.gap(audio, c))
    return ref.result(gaps, bad, sum(u["items"] for u in run.units), run.missing)
