"""Shared scaffolding for the within-process interleaved A/B probes.

Measurement discipline: end-to-end walls on a shared host swing between
runs, so every decision-grade comparison builds all configurations in ONE
process, interleaves them within every timing round, and decides on
medians. The probes (fetch_pack_probe, growth_probe, ...) share the
workload and the loop; only the engine configurations differ.

Each round's wall is read with the engine's device idle:
``encode_batch`` returns host codes, and ``sync`` waits on the card
besides, so no queued work is left out of a round.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch
import torch.nn.functional as F

from tokenize_audio_tpu_torch.config import fp32_precision
from tokenize_audio_tpu_torch.engine.metrics import EngineStats
from tokenize_audio_tpu_torch.mimi.model import (
    causal_conv1d,
    matmul_precision,
    seanet_encode,
    transformer_apply,
)
from tokenize_audio_tpu_torch.ops.cuda.rvq import first_divergence_margins
from tokenize_audio_tpu_torch.qualify import TIE_MARGIN


def bench_audios(utts: int = 192, seed: int = 0):
    """The benchmark workload shape: lognormal 0.8-59 s utterances as int16
    PCM (the production wire format). Returns (audios, total_seconds)."""
    rng = np.random.default_rng(seed)
    lengths_s = np.clip(rng.lognormal(mean=1.9, sigma=0.8, size=utts), 0.8, 59.0)
    audios = [
        (rng.standard_normal(int(s * 24_000)) * 0.3 * 32767).astype(np.int16)
        for s in lengths_s
    ]
    return audios, sum(len(a) for a in audios) / 24_000.0


def sync(device: torch.device) -> None:
    """Wait until ``device`` is idle, if it is a card (nothing to wait for
    on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_and_check_equal(engines: dict, audios):
    """Warm every engine on the workload and assert all emit identical
    codes (the formats/configs under test must be pure transport/layout)."""
    ref = None
    for name, eng in engines.items():
        got = eng.encode_batch(audios)
        if ref is None:
            ref = got
        else:
            assert all((a == b).all() for a, b in zip(ref, got)), name
    return ref


def codes_equal(variants: dict) -> bool:
    """Whether every variant's code list equals the first's, bit for bit."""
    ref, *rest = variants.values()
    return all(len(got) == len(ref) and all(np.array_equal(a, b) for a, b in zip(ref, got))
               for got in rest)


@torch.no_grad()
def rvq_input(engine, audio: np.ndarray) -> torch.Tensor:
    """The RVQ input (1, hidden, frames) of one int16 utterance as the
    engine's masked encode computes it (``mimi.model._encode``), alone in
    its batch and with the plain SEANet, on the engine's device."""
    cfg = dataclasses.replace(engine.cfg, seanet_backend="torch")
    params, spf = engine.params, cfg.samples_per_frame
    x = np.zeros((1, -(-len(audio) // spf) * spf), dtype=np.float32)
    x[0, : len(audio)] = audio.astype(np.float32) / 32768.0
    valid = torch.tensor([len(audio)], dtype=torch.int32, device=engine.device)
    with fp32_precision(matmul_precision(cfg)):
        x, valid = seanet_encode(params, cfg, torch.from_numpy(x).to(engine.device)[:, None, :],
                                 valid)
        x = transformer_apply(params["tfm"], cfg, x.transpose(1, 2)).transpose(1, 2)
        pos = torch.arange(x.shape[-1], device=x.device)[None, None, :]
        x = torch.where(pos < valid[:, None, None], x, 0.0)
        x, _ = causal_conv1d(x, valid, params["downsample"]["w"], None, stride=2,
                             pad_mode="replicate")
    return x


def flip_margins(engine, emb: torch.Tensor, got: np.ndarray, want: np.ndarray) -> list:
    """The relative margin of each frame's first differing book between
    ``got`` and ``want`` ((K, frames) codes), replayed on ``emb``
    (``rvq_input``) head by head."""
    margins = []
    with fp32_precision("ieee"):
        for head, lo, hi in (("semantic", 0, 1), ("acoustic", 1, got.shape[0])):
            if hi <= lo:
                continue
            p = engine.params["rvq"][head]
            x = F.conv1d(emb, p["in_proj"][:, :, None])[0].T.contiguous()
            g, w = (torch.from_numpy(np.ascontiguousarray(c[lo:hi].T)).to(x.device)
                    for c in (got, want))
            margins += first_divergence_margins(x, p["embed"][: hi - lo].contiguous(), g, w)[1]
    return margins


def within_ties(engine, audios, got, want, what) -> dict:
    """Hold two code lists of ``audios`` to the qualification kit's rule,
    for configurations that change batch shapes (bucket lengths, batch
    rows) and with them the card's summation order: >= 0.999 of frames
    equal, and each differing frame's first differing book a near-tie
    (relative margin < ``qualify.TIE_MARGIN``) on the utterance's own RVQ
    input. Raises AssertionError otherwise. Returns the frames, the equal
    frames and the margins."""
    frames = same = 0
    margins = []
    for audio, g, w in zip(audios, got, want):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        eq = (g == w).all(axis=0)
        frames, same = frames + eq.size, same + int(eq.sum())
        if not eq.all():
            margins += flip_margins(engine, rvq_input(engine, audio), g, w)
    assert same >= 0.999 * frames, f"{what}: {same} of {frames} frames equal"
    # either side may hold the smaller distance: a tie is small in magnitude
    assert max(map(abs, margins), default=0.0) < TIE_MARGIN, (what, margins)
    return {"frames": frames, "equal_frames": same, "flip_margins": margins}


def timed_pass(engine, audios, total_s: float) -> float:
    """One encode of ``audios`` from an idle card to an idle card, in audio
    seconds per wall second."""
    sync(engine.device)
    t0 = time.perf_counter()
    engine.encode_batch(audios)
    sync(engine.device)
    return total_s / (time.perf_counter() - t0)


def interleaved_rounds(engines: dict, audios, total_s: float, rounds: int):
    """Alternate every engine within each round; returns
    ({name: [x_realtime per round]}, {name: last round's stage seconds})."""
    results = {name: [] for name in engines}
    stages = {}
    for r in range(rounds):
        for name, eng in engines.items():
            eng.stats = EngineStats()
            results[name].append(timed_pass(eng, audios, total_s))
            stages[name] = {
                k: round(v, 3) for k, v in eng.stats.stage_seconds.items()
            }
        print(
            f"round {r}: "
            + "  ".join(f"{n}={results[n][-1]:.0f}x" for n in results),
            flush=True,
        )
    return results, stages


def permuted_rounds(variants: dict, audios, total_s: float, rounds: int, device: str) -> dict:
    """The depth and budget probes' loop: warm every variant (printing its
    rate), then ``rounds`` rounds in an order drawn anew per round from
    ``default_rng(1)``, then the medians. Returns the report, with the warm
    passes' codes by variant."""
    codes = {}
    for name, eng in variants.items():
        sync(eng.device)
        t0 = time.perf_counter()
        codes[name] = eng.encode_batch(audios)
        sync(eng.device)
        print(f"warm {name}: {total_s / (time.perf_counter() - t0):.0f}x", flush=True)

    results = {k: [] for k in variants}
    order_rng = np.random.default_rng(1)
    names = list(variants)
    for r in range(rounds):
        for i in order_rng.permutation(len(names)):
            name = names[i]
            results[name].append(timed_pass(variants[name], audios, total_s))
        print(f"round {r}: " + " ".join(f"{n}={results[n][-1]:.0f}" for n in names), flush=True)

    print("\nmedians over", rounds, "interleaved rounds:")
    for n in names:
        print(f"  {n}: median {statistics.median(results[n]):.1f}x  "
              f"(min {min(results[n]):.0f}, max {max(results[n]):.0f})")
    return {
        "device": device,
        "audio_seconds": total_s,
        "rounds": rounds,
        "median_x_realtime": {n: statistics.median(xs) for n, xs in results.items()},
        "all": results,
        "codes": codes,
    }
