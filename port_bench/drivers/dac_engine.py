"""Driver of the DAC engine cells: ``MimiEncoderEngine.encode_batch`` on a
``DacConfig``, alone, in a closed loop. A unit of work is one call on one
set of the mix's utterances; the sets are taken in turn.

The engine is built on the program's ``DacConfig`` from the configuration
file's shape keys, at the mix's sample rate, with weights from
``reference/dac_weights.py`` loaded through the program's own checkpoint
converter. The traced segment puts ``port_bench::dac.*`` ranges around the
model's ``encoder``, ``snake`` and ``rvq_encode`` (looked up in their
module at every call) and notes the rows, padded length and valid
lengths of each ``encoder`` call in ``run.dac_notes``; ``release`` keeps
the Snake calls the program counted in the traced segment
(``dac.model.launches``) as ``run.traced_snakes``.

The check compares, for a sample of the window's utterances drawn from
the seed (the longest utterance among them), the codes the calls returned
with the plain reference's quantizer input for the same audio
(``reference/dac_ref.py``), and checks the shape and range of every code
the window and the traced segment returned, under the names and limits of
``pbkit/checks.py``. It also prints, on standard error, how many distinct
codes each book used over the sample.

A run whose mode asks for TF32 (``matmul_precision`` other than
"highest", the control of ``control.py``) builds the engine at IEEE
precision, which is all DAC's engine accepts, and switches the model's
precision hold to TF32 for the whole run: the program's own path one
precision below the configuration's.
"""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from pbkit import checks, traffic
from reference import dac_ref, dac_weights


def dac_config(cfg: dict, mode: dict):
    """The program's ``DacConfig`` for a configuration file: its shape keys
    and the run modes it has, at IEEE float32."""
    from tokenize_audio_tpu_torch.dac.config import DacConfig

    keys = {f.name for f in dataclasses.fields(DacConfig)}
    kw = {k: v for k, v in {**cfg, **mode}.items() if k in keys}
    kw["matmul_precision"] = "highest"
    return DacConfig(**kw)


def _hold_tf32(run) -> None:
    """Switch the model's IEEE hold to TF32 until ``release``."""
    from tokenize_audio_tpu_torch.dac import model

    run.saved_hold = model.fp32_precision
    model.fp32_precision = lambda mode: run.saved_hold("tf32")


def setup(run) -> None:
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.dac.weights import convert_hf_state_dict
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

    run.rate = run.mix["sample_rate"]
    dcfg = dac_config(run.cfg, run.mode)
    if run.mode.get("matmul_precision", "highest") != "highest":
        _hold_tf32(run)
    sd = dac_weights.state_dict(run.cfg, run.seed, run.device)
    run.engine = MimiEncoderEngine(
        convert_hf_state_dict(sd, dcfg), dcfg,
        EngineConfig(**{"sample_rate": run.rate, **run.params["engine"]}),
        num_codebooks=run.books, device=run.device,
    )
    run.sets = traffic.engine_sets(run.mix, run.seed, run.device)
    # the model runs at the mix's own rate: a row's samples are its length
    run.set_rows = [[len(a) for a in s] for s in run.sets]
    # warm-up: one call of the cell's own traffic; every set has the same
    # lengths, so it launches every batch shape the window will
    run.engine.encode_batch(run.sets[0], sr=run.rate)


def reset_stats(run) -> None:
    from tokenize_audio_tpu_torch.engine import EngineStats

    run.engine.stats = EngineStats()


def stats(run):
    return run.engine.stats


def _encoder_note(params, cfg, x, valid=None, *args, **kwargs) -> tuple:
    return x.shape[0], x.shape[-1], valid


def span_targets(run) -> list:
    from tokenize_audio_tpu_torch.dac import model

    run.dac_notes = {"encoder": []}
    run.snakes_before = model.launches
    return [
        (run.engine, "encode_batch", "engine.encode_batch"),
        (run.engine, "_dispatch", "engine.dispatch"),
        (run.engine, "_collect", "engine.collect"),
        (model, "encoder", "dac.encoder", _encoder_note, run.dac_notes["encoder"]),
        (model, "snake", "dac.snake"),
        (model, "rvq_encode", "dac.rvq"),
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
    from tokenize_audio_tpu_torch.dac import model

    if run.trace is not None:
        run.traced_snakes = model.launches - run.snakes_before
    saved = getattr(run, "saved_hold", None)
    if saved is not None:
        model.fp32_precision = saved
        run.saved_hold = None
    run.engine = None


class _Reference(checks.Reference):
    """``checks.Reference``'s shape test and result on DAC's plain
    reference and weights."""

    def __init__(self, run):
        self.run = run
        self.cfg = run.cfg
        self.sd = dac_weights.state_dict(run.cfg, run.seed, run.device)
        self.spf = math.prod(run.cfg["downsampling_ratios"])

    def gap(self, audio: torch.Tensor, codes) -> float:
        emb = dac_ref.embeddings(self.sd, self.cfg, audio)
        c = torch.from_numpy(np.asarray(codes, dtype=np.int64)).to(emb.device)
        return float(dac_ref.code_gaps(self.sd, self.cfg, emb, c).max())


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
    gaps, used = [], [set() for _ in range(run.books)]
    for k, j in checks.sample(run, pool, lens):
        u = run.units[k]
        a, c = run.sets[u["set"]][j], u["codes"][j]
        if ref.well_formed(c, len(a)):
            audio = torch.from_numpy(a).to(run.device).float() / 32768.0
            gaps.append(ref.gap(audio, c))
            for book, codes in zip(used, np.asarray(c)):
                book.update(codes.tolist())
    print("dac: distinct codes per book over the sample " + " ".join(str(len(b)) for b in used),
          file=sys.stderr)
    return ref.result(gaps, bad, sum(u["items"] for u in run.units), run.missing)
