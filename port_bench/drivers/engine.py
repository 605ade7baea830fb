"""Driver of the engine cells: ``MimiEncoderEngine.encode_batch`` alone, in
a closed loop. A unit of work is one call on one set of the mix's
utterances; the sets are taken in turn.

The check compares, for a sample of the window's utterances drawn from
the seed (the longest utterance among them), the codes the calls returned
with the plain reference's quantizer input for the same audio, and checks
the shape and range of every code the window and the traced segment
returned.
"""

from __future__ import annotations

import torch

from pbkit import checks, program, traffic


def setup(run) -> None:
    run.rate = run.mix["sample_rate"]
    run.engine = program.build_engine(run, run.params["engine"])
    run.sets = traffic.engine_sets(run.mix, run.seed, run.device)
    # valid 24 kHz samples of each set's rows, as the model counts them
    run.set_rows = [[-(-len(a) * 24_000 // run.rate) for a in s] for s in run.sets]
    # warm-up: one call of the cell's own traffic; every set has the same
    # lengths, so it launches every batch shape the window will
    run.engine.encode_batch(run.sets[0], sr=run.rate)


def reset_stats(run) -> None:
    from tokenize_audio_tpu_torch.engine import EngineStats

    run.engine.stats = EngineStats()


def stats(run):
    return run.engine.stats


def span_targets(run) -> list:
    return [
        (run.engine, "encode_batch", "engine.encode_batch"),
        (run.engine, "_dispatch", "engine.dispatch"),
        (run.engine, "_collect", "engine.collect"),
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
    run.engine = None


def check(run) -> dict:
    """The compared numbers, and the items attempted and failed."""
    ref = checks.Reference(run)
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
