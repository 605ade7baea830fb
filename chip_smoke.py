#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tokenize_audio_tpu_torch) on one GPU.

    python3 chip_smoke.py [--baseline-cu OLD.cu] [--candidate-cu OTHER.cu ...]
                          [--rvq-baseline-cu OLD.cu] [--rvq-candidate-cu OTHER.cu ...]

Needs one CUDA device and ``nvcc`` (the kernels build from
``tokenize_audio_tpu_torch/csrc`` at first use). Phases, each of which fails
the run (non-zero exit, no final result line) if its check fails:

  1. device   — the card's name and power limit (nvidia-smi), and which
                optional libraries (pandas, pyarrow, transformers,
                tokenizers, huggingface_hub, safetensors) import on this machine
                (information only);
  2. build    — the four kernels compiled for sm_90a, with nvcc's ptxas
                report;
  3. kernels  — each kernel against its plain PyTorch version at large
                shapes: agreement, CUDA-event times, and the bound the card's
                FP32 rate and memory rate set for the same work; the RVQ
                line also gives how many clusters of each of its variants
                the card holds at once, and the same check at EnCodec
                24 kHz's shapes (D 128, V 1024, K 8; its ``encodec``
                entry); EnCodec's LSTM kernel at the EnCodec cell's 1-, 5-
                and 24-row batches, beside cuDNN's ``torch.lstm``, with
                its launches counted by its wrapper (``lstm_residual.
                launches``); EnCodec's resblock kernel at the cell's four
                stages of its largest and a mean batch, beside the cuDNN
                chain it replaced (``encodec_resblock_elu``);
  4. main     — MimiEncoderEngine at full kyutai/mimi width (random weights,
                seed 0), 32 codebooks, packed transfer, fifo drain, on a
                YODAS2-shaped sub-shard through encode_batch(defer=True) and
                finish(); both kernels' launch counts must rise, and the codes
                are held against the plain-PyTorch ("torch") backends (>= 0.999
                of frames, as the qualify phase's census supports, and every
                first divergence a near-tie under the kit's TIE_MARGIN); every
                (B, C, T) the main path launches the resblock kernel with,
                and every (N, K) it launches the RVQ kernel with, is recorded;
                then DAC 44.1 kHz (``phase_dac``) on the same engine at its
                published widths, one web batch of seeded utterances against
                the benchmark's plain reference (``port_bench/reference/
                dac_ref.py``) under the cell's ``code_gap_max``, with 29
                Snakes a batch (``dac.model.launches``);
  5. stream   — the engine with long_audio_policy="stream" (defaults
                otherwise: stream_batch 8, 320 s horizon, 8 s chunks), 32
                codebooks, on 24 kHz utterances of 61-340 s and four short
                ones in one encode_batch(defer=True) + finish(): each long
                one against a one-shot encode on the card ("torch"
                backends) piece by piece at the 320 s cut, >= 0.999 of
                frames, with each flip's relative margin; the short ones
                against the split policy; the RVQ kernel's launches and
                (N, K) while streaming (the ``stream_path``); TF32 flags at
                every stream conv and step; 65 s streamed on the card
                against the CPU engine; 90 and 130 s at 16 kHz against a
                one-shot encode of the card-resampled audio; RTF and peak
                memory;
  6. yodas2   — the YODAS2 shard processor through its CLI entry point,
                ``datasets.yodas2.main`` (dir: source, local hub, default
                engine flags: kernel backends, 32 codebooks, packed
                transfer, fifo drain, fetch-ahead 1), on a two-sub-shard
                mirror of 24 entries each (WAV 24 kHz, one FLAC and one
                16 kHz WAV per sub-shard, lognormal chunks with a degenerate
                one and one over 60 s): the report, the hub JSON, both
                kernels' launch counts and shapes (the ``yodas2_path``), the
                TF32 flags at every conv1d and transformer call in every
                thread (the decode-prefetch threads resample on the card),
                and the codes against a direct encode_batch of the same
                chunks; a second run with ``--long-audio-policy stream``,
                whose chunks up to 60 s must get the first run's codes and
                whose longer chunk its one-shot codes (>= 0.999 of frames);
                stage seconds, the processor's and the direct engine's
                real-time factors, a profiled run's device breakdown, and a
                16 -> 24 kHz resample on the card against the CPU with TF32
                switched on by the caller;
  6b. modes   — the engine's precision modes, drains, probes and retry at
                full width, 32 codebooks, kernel backends, on the main
                sub-shard: parity, matmul_precision="high" (TF32) and
                compute_dtype="bfloat16", each with both kernels' launches
                (bf16: the RVQ kernel only, the resblock kernel being
                float32-only), the TF32 flags at every conv1d, linear and
                matmul by launch site and thread against the sites' modes
                (resample, quantizer in_proj, RVQ and the fused stage's
                down-conv IEEE; the other SEANet convs, transformer and
                downsample TF32 under "high"), code match against parity
                per book and per frame (> 0.4 of codes, the CPU tests'
                bar) and
                interleaved RTF; a parity and a TF32 engine at once in two
                threads (parity codes bit-equal to its run alone); a 75 s
                utterance streamed by a bf16 engine (equal to the float32
                engine's); fifo and ready drains (bit-equal, equal
                frame counters, RTF); autotune_transfer,
                autotune_pipeline_depth, autotune_drain_policy and a
                request_autotune first batch (picks kept, codes = parity);
                one injected OutOfMemoryError at dispatch, collect and
                stream and one AcceleratorError (each retried once, codes
                equal) and a build failure (raised, not retried); the YODAS2
                CLI on the ``yodas2`` mirror with ``--fast --drain-policy
                ready --code-transfer-format auto-data`` and with
                ``--precision high --pipeline-depth auto --drain-policy auto
                --autotune-seconds 5`` (complete, launches, flags in every
                thread, code match against the parity run, whose hub stays
                as it was);
  7. codec    — MimiCodec at full width (8 codebooks) on the card:
                audio_to_str -> str_to_audio at 24 and 16 kHz (both kernels
                launched by the encode), a 32-book decode against the CPU's
                (atol 3e-4 x max|CPU|, rtol 1e-3), TF32 flags at every
                conv1d, conv_transpose1d and transformer call, the decode
                RTF, and ``python -m tokenize_audio_tpu_torch
                info|encode|decode`` as subprocesses on a WAV;
  8. bench    — the port's benchmark module (``tokenize_audio_tpu_torch.
                benchmark``) at full width under its bench config (192 s
                samples budget per batch, max batch 128, 2 s minimum bucket,
                8 codebooks): the engine bench (256 utterances, best of 5
                passes, fused 16 kHz stage) with both kernels' launches and
                shapes recorded in its first measured pass, the TF32 flags
                at every transformer and (fused) resample conv, peak memory
                and a profiled pass; fused 16 kHz codes against
                resample-then-encode on the card and the card against the
                CPU engine at 16 and 48 kHz; then the pipeline, compare, mp3
                (where libmp3lame and libmpg123 load), soak and CLI modes;
  9. corpora  — the four corpus processors' command lines in process on the
                card (default engine flags): LibriSpeech (40 utterances of
                16 kHz FLAC, 2-30 s, train layout in two chunks, then the
                devtest layout on 8), Common Voice (48 clips of 48 kHz WAV
                bytes, 1-10 s), LibriTTS-R tts0 (24 float32 24 kHz arrays,
                1-15 s), MLS stage 1 (24 rows of 10-20 s at 16 kHz, FLAC
                bytes and arrays) and stage 2, Emilia standard and
                conversational (a tar of 24 WAV members of 3-20 s, two at
                16 kHz, and a corrupt one): complete reports, every
                utterance's rows, a rerun that launches no kernel, both
                kernels' launches and shapes (the ``corpus_path``), every
                ``audio_str`` against a direct encode_batch_mixed (>= 0.999
                of frames, flips near-ties), TF32 flags in every thread, one
                LibriSpeech and one Common Voice utterance against the CPU
                engine, RTF and host stage seconds per corpus;
  9b. qualify — the port's qualification kit (``tokenize_audio_tpu_torch.
                qualify``) at the published kyutai/mimi width, 32 codebooks,
                kernel backends on the card, the HF oracle on the CPU, for
                weight seeds 0 (``save_pretrained`` + the kit's CLI with
                ``--hf-dir``), 1 and 2, each through the kit's default sweep
                (>= 10k frames in all): every report passing (no non-tie
                flip, per-layer deviations under the kit's atols through the
                resblock kernel, file conversion exact), TF32 off at every
                conv1d, linear and matmul, the kernels' launches by engine
                (parity sweep, bf16 check, per-layer) and shapes (the
                ``qualify_path``); seed 0's sweep also through the port's
                CPU engine (card vs CPU, CPU vs HF); the installed
                transformers' encode window mode (5.x applies the 250-step
                window, 4.x and the port's config do not) and the sweep's
                flips past the window, reported;
  9c. fleet   — ``python -m tokenize_audio_tpu_torch.runner.pod_runner run
                --max-concurrent 2 --wait`` over the port's YODAS2 command
                line on a two-shard mirror (the qualify phase's checkpoint
                as ``--params``): both shards complete with the single-GPU
                warning, hub codes equal to a direct encode_batch (>= 0.999
                of frames), a rerun that launches nothing, the monitor's
                status and verify, the manifests' shards and unit counts,
                and ``chip_check`` on GPU 0 and at an index with no GPU;
  9d. chaos   — the processors' SIGKILL contract ("kill anywhere, rerun the
                same command") on the card, the fleet's checkpoint as
                ``--params``: the YODAS2 command line (upload batch 1,
                default engine flags otherwise, 32 codebooks) on a 3 x 8-entry
                mirror (lognormal 1-30 s, a FLAC and a 16 kHz entry per
                sub-shard) and the parquet-corpus one (People's Speech, 3
                shards of 8 16 kHz FLAC rows, 8 codebooks), each run once
                uninterrupted in a child process, then in children
                SIGKILLed at 0.1 / 0.35 / 0.6 / 0.85 of that run's work
                window after each run's first evidence of work and rerun
                until one completes (tests/chaos_utils.py's
                ``kill_anywhere``; >= 1 kill mid-work), the hub held to the
                uninterrupted run's (>= 0.999 of frames, every difference a
                near-tie under the kit's TIE_MARGIN) and a rerun of the
                finished command skipping everything with no launch; at the
                same time, children killed during their first-use kernel
                build (an empty ``_build.BUILD_DIR``), at ``os.replace`` and
                while nvcc runs: what each left, and a rerun that builds,
                loads and encodes as this process does;
  9e. scripts — the port's qualification scripts (``tokenize_audio_tpu_torch.
                scripts``, after ``chaos``) at full width through their entry
                functions, each at its own defaults: ``precision_probe``
                (codebooks trained by residual k-means on 2400 s of the
                model's own pre-RVQ activations, 1500-frame rows of 2.88 M
                samples through the resblock kernel; TF32 and bf16 against
                parity on 240 s held out, codebook usage, interleaved
                timings; the parity codes against the plain backends on the
                trained params, >= 0.999 of frames, near-ties only; a
                second training bit-equal),
                ``split_boundary_census`` (every differing frame within 2
                frames of a piece boundary), ``seanet_backend_probe``
                (kernel vs plain, >= 0.999 of frames),
                ``stream_policy_probe``, ``resampler_sensitivity`` (the
                production filter restored), and, cut to 16 utterances and
                one seed, ``parity_census`` (near-ties only) and
                ``parity_sweep`` (>= 0.999 of frames) with the HF oracle on
                the CPU; both kernels' launches over the phase and per
                script, and their shapes (the ``scripts_path``, whose RVQ
                replay runs on the trained codebooks);
  9f. probes  — the port's A/B probes, warmup receipt and conv-layout probe
                (``tokenize_audio_tpu_torch.scripts``, after ``scripts``) at
                full width through their entry functions, each at its own
                defaults but for ``PROBES_CUTS`` (3 timing rounds where the
                JAX scripts run 5): drain policy, wire format, fetch dtype,
                pipeline depth and samples budget (each asserting its
                variants' codes bit-equal), fetch-ahead (4 sub-shards in
                every run, the runs' hubs identical), bucket growth (codes
                within the kit's rule: >= 0.999 of frames, every flip a
                near-tie), the tail-ladder warmup receipt (batch shapes per
                lattice > 0), and the conv-layout probe (channels-last
                SEANet within 1e-4 x max|NCL| of the plain NCL one; each of
                its three SEANets launch-counted and profiled: the cuDNN
                kernels each layout runs); both kernels' launches per
                script and their shapes (the ``probes_path``);
  9g. downstream — the chain downstream of the encoder, fed by the card: the
                YODAS2 command line (default flags: kernel backends, 32
                codebooks) on a fresh 2 x 24-entry mirror, with both kernels'
                launches and shapes (the ``downstream_path``); then, each
                through its command line in process: the pretrain converter
                and a rerun that uploads nothing, validate (0 bad rows), every
                document's audio spans against the hub's codes frame for
                frame (first 8 books), the five derivative modes (semantic =
                acoustic[::8]), CVSS on two languages of the card's code
                strings, the sampler (its .npy = the hub's codes cut to 8
                books), the trainer (every sampled code string round-trips),
                tokenizer surgery resizing a tiny causal LM on the card
                against the CPU (kept rows bit-equal, new rows within 1e-6 x
                max|w|), count_rows and estimate_tokens over every row; the
                installed transformers and tokenizers, and what they load;
  9h. mesh    — the in-process mesh (``parallel.mesh``, ``parallel.multihost``)
                at full width, 32 codebooks, on the main sub-shard against
                the solo engine's codes (>= 0.999 of frames, every flip a
                near-tie under the kit's TIE_MARGIN): world 1 in process on
                NCCL (the 1 x 1 mesh engine; a tp 1 ``shard_params_tp``
                encode with 2 all-reduces per layer), then world 2 on the
                one card as two ``--mesh-child`` processes on gloo (NCCL
                refuses two ranks on one device): the dp 2 engine, a tp 2
                encode of an 8 x 10 s batch against the replicated one,
                packed words against padded codes, the fused 16 kHz
                resample, an uneven 5-utterance tail and the stream policy
                on the 75 s utterance; both kernels' launches on every rank
                (each count set to 0 just before a run and read after it),
                rank 0's dp-engine shapes (the ``mesh_path``), each
                layout's RTF beside the solo engine's; a rank that fails or
                runs past its limit fails the run with its log;
 10. replay   — the resblock kernel at each shape recorded on the main path,
                the YODAS2 path, the bench, the corpora, the kit, the
                downstream encode, the mesh, the scripts and the probes:
                agreement with its plain version, CUDA-event times and the
                FP32 bound, summed per C as count x ms (the ``main_path``,
                ``yodas2_path``, ``bench_path``, ``corpus_path``,
                ``qualify_path``, ``downstream_path``, ``mesh_path``,
                ``scripts_path`` and ``probes_path`` entries of its record;
                the probes' shapes timed over 3 runs each, the others' 7);
 11. rvq_replay — the RVQ kernel at each recorded (N, K) of the main,
                stream, YODAS2, bench, corpus, qualify, downstream, mesh,
                scripts and probes paths, on the model's codebooks (the
                scripts': the k-means ones they trained): code agreement with its
                plain version (first divergences must be near-ties),
                CUDA-event times and the FP32 bound, summed as count x ms
                (the ``main_path``, ``stream_path``, ``yodas2_path``,
                ``bench_path``, ``corpus_path``, ``qualify_path``,
                ``downstream_path``, ``mesh_path``, ``scripts_path`` and
                ``probes_path`` entries of its record);
 12. tie      — a 3 s utterance encoded on the CPU (plain path, the path the
                CPU tests hold bit-equal to the JAX package) and on the card.

A ``phase_seconds`` line gives each phase's seconds, before the card's
nvidia-smi line.

Options, for comparing kernels on one card in one run, each another
version of a kernel's source with the same C entry, built beside the kernel
and timed beside it in the replay phases. Of csrc/seanet_resblock.cu
(``resblock_elu_launch``): ``--baseline-cu`` takes HF-layout weights (an
older commit's file) and must agree with the plain version;
``--candidate-cu`` (repeatable, named by its file's stem) takes the packed
weights of ``pack_weights``, and its error is reported, not checked, so an
edited copy that drops part of the work on purpose can be timed. Of
csrc/rvq.cu (``rvq_quantize_launch``): ``--rvq-baseline-cu`` takes the
(K, V, D) codebooks and e2 (an older commit's file), must agree like the
kernel, and is also timed at the large shape; ``--rvq-candidate-cu``
(repeatable, named by its file's stem) takes the codebooks of
``pack_codebooks`` too, and its code agreement is reported, not checked.
``--mesh-child RANK --mesh-dir DIR`` runs one rank of the mesh phase's
world 2; the phase starts both itself.

The second-to-last line is the ``{"kernels": [...]}`` record; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SEED = 0
SPF = 1920
SR = 24_000
RVQ_SHAPE = dict(n=4096, d=256, v=2048, k=32)
RVQ_SMALL_N = 267  # mean rows per main-path batch
# EnCodec 24 kHz at 6 kbps: 8 books of 1024 x 128; rows (batch rows x
# padded frames) of engine-web.encodec-8cb's largest and mean batch
ENCODEC_RVQ = dict(n=(13_960, 7_075), d=128, v=1024, k=8)
# EnCodec's LSTM kernel at engine-web.encodec-8cb's batches: (rows, padded
# frames) of its longest 1-, 5- and 24-row batch (the cell's 28 batches,
# planned from its traffic's lengths and its engine configuration)
ENCODEC_LSTM = ((1, 4500), (5, 1857), (24, 347))
# EnCodec's resblock kernel at engine-web.encodec-8cb's largest batch (20 x
# 223,360 samples) and one near its mean (24 x 96,640; the cell's mean is
# 2.26 M samples a batch): (rows, samples); stage s runs C = 32 * 2^s on
# the samples over (1, 2, 8, 40)
ENCODEC_RESBLOCK = ((20, 223_360), (24, 96_640))
ENCODEC_STAGES = ((32, 1), (64, 2), (128, 8), (256, 40))
RESBLOCK_BATCH, RESBLOCK_SECONDS = 16, 10.0
AB_PAIRS = 6
SLEEP_CYCLES = 2_000_000  # ~1 ms at the H100's clocks: longer than any fn's host-side enqueue
# published dense rates (NVIDIA data sheets): FP32 outside the tensor cores
# and HBM bandwidth, by H100 variant
PEAKS = {
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "SXM": (67e12, 3.35e12),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def peaks_for(name: str):
    for key in ("PCIe", "NVL"):
        if key in name:
            return key, *PEAKS[key]
    return "SXM", *PEAKS["SXM"]


def bound_ms(flops: float, nbytes: float, peak_flops: float, peak_bw: float):
    t_ops, t_bytes = flops / peak_flops, nbytes / peak_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, warmup: int = 2, reps: int = 7) -> float:
    """Median CUDA-event milliseconds of ``fn`` over ``reps`` runs: device
    time. Each run is enqueued behind a ~1 ms device-side sleep, so the
    host's launch overhead (Python, ctypes) is hidden behind it and not
    counted, as it would be for a small kernel on an idle card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def rvq_extra_run(name, fn, x, embeds, packed, out, stream):
    """A zero-arg launcher of another build of csrc/rvq.cu on these inputs:
    ``rvq_baseline`` takes the (K, V, D) codebooks and e2, the others the
    packed codebooks and the (K, V, D) ones, as the kernel does."""
    n, d = x.shape
    k, v, _ = embeds.shape
    args = (x, embeds, packed[1], out) if name == "rvq_baseline" else (
        x, packed[0], packed[1], embeds, out)
    ptrs = [a.data_ptr() for a in args]

    def run():
        check(fn(*ptrs, n, d, k, v, stream) == 0, f"{name} launch failed")

    return run


def code_share(got, want) -> float:
    """Share of equal codes, counted exactly (a float32 mean of all-equal
    codes can read 1 - 2**-24)."""
    return int((got == want).sum()) / got.numel()


def rvq_agreement(x, embeds, got, want, what, min_match=0.999):
    """Share of equal codes and the largest relative margin at a first
    divergence; fails unless every divergence is a near-tie and, with
    ``min_match``, the share is at least that."""
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    match = code_share(got, want)
    rows, margins, gaps = rvq.first_divergence_margins(x, embeds, got, want)
    max_margin = max(margins, default=0.0)
    if min_match is not None:
        check(match >= min_match, f"{what}: code match {match} < {min_match}")
    check(max_margin < 1e-6, f"{what}: first divergence not a near-tie: margin {max_margin}")
    return match, len(rows), max_margin, max(gaps, default=0.0)


def time_rvq_extras(torch, row, extras, x, embeds, packed, want, what):
    """Each of ``extras`` (name -> the C entry of another build of
    csrc/rvq.cu) on these inputs: ``<name>_code_match`` and CUDA-event
    ``<name>_ms`` into ``row``; ``rvq_baseline`` must agree like the
    kernel."""
    stream = torch.cuda.current_stream().cuda_stream
    for name, fn in extras.items():
        out = torch.empty_like(want)
        run = rvq_extra_run(name, fn, x, embeds, packed, out, stream)
        run()
        torch.cuda.synchronize()
        if name == "rvq_baseline":
            row[f"{name}_code_match"] = rvq_agreement(x, embeds, out, want, f"{name} {what}")[0]
        else:
            row[f"{name}_code_match"] = code_share(out, want)
        row[f"{name}_ms"] = cuda_ms(torch, run)


def rvq_encodec_shapes(torch, rng, peak_flops, peak_bw) -> list:
    """The RVQ kernel at EnCodec's shapes (``ENCODEC_RVQ``), each N against
    the plain version on the same inputs (``rvq_agreement``), both timed,
    with the shape's bound."""
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    dev = torch.device("cuda")
    d, v, k = (ENCODEC_RVQ[s] for s in ("d", "v", "k"))
    embeds = torch.from_numpy(rng.standard_normal((k, v, d)).astype(np.float32)).to(dev)
    packed = rvq.pack_codebooks(embeds)  # once, as the engine does
    rows = []
    for n in ENCODEC_RVQ["n"]:
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        got = rvq.rvq_quantize(x, embeds, packed=packed)
        want = rvq.rvq_quantize_reference(x, embeds)
        torch.cuda.synchronize()
        match, n_rows, max_margin, gap = rvq_agreement(
            x, embeds, got, want, f"rvq kernel, EnCodec N={n}")
        b_ms, b_by = bound_ms(2.0 * k * n * v * d, 4.0 * (k * v * d + n * d + n * k),
                              peak_flops, peak_bw)
        rows.append({
            "N": n, "D": d, "V": v, "K": k,
            "ms": cuda_ms(torch, lambda: rvq.rvq_quantize(x, embeds, packed=packed)),
            "plain_ms": cuda_ms(torch, lambda: rvq.rvq_quantize_reference(x, embeds)),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": gap,
            "code_match": match, "diverging_rows": n_rows, "max_rel_margin": max_margin,
        })
        emit({"phase": "kernel_stage", "name": "rvq_quantize", "model": "encodec", **rows[-1]})
    return rows


def lstm_encodec_shapes(torch, peak_flops, peak_bw) -> list:
    """The LSTM kernel at EnCodec's batches (``ENCODEC_LSTM``), with weights
    scaled as the benchmark's: each shape against the plain version with
    cuDNN (``torch.lstm``, what the kernel replaced, as ``library_ms``)
    and without it (``plain_ms``: PyTorch's own LSTM, a matrix product and a
    fused cell a step), all three timed, with the shape's bound."""
    from tokenize_audio_tpu_torch.ops.cuda import lstm

    dev = torch.device("cuda")
    h = lstm.HIDDEN
    g = torch.Generator().manual_seed(SEED)
    weights = []
    for _ in range(lstm.LAYERS):
        weights += [torch.randn((4 * h, h), generator=g) / h**0.5,
                    torch.randn((4 * h, h), generator=g) / h**0.5,
                    torch.randn((4 * h,), generator=g), torch.randn((4 * h,), generator=g)]
    weights = [w.to(dev) for w in weights]
    packed = lstm.pack_weights(weights)  # once, as the engine does
    n_weights = lstm.LAYERS * (2 * 4 * h * h + 2 * 4 * h)
    rows = []
    for b, t in ENCODEC_LSTM:
        x = torch.randn((b, h, t), generator=g).to(dev)
        launches = lstm.lstm_residual.launches
        got = lstm.lstm_residual(x, weights, lstm.LAYERS, packed)
        check(lstm.lstm_residual.launches == launches + 1,
              f"lstm B={b} T={t}: the wrapper did not launch the kernel")
        want = lstm.lstm_residual_reference(x, weights, lstm.LAYERS)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 5e-5, f"lstm kernel B={b} T={t}: max err {err} > 5e-5")
        # pbkit/encodec_flops.lstm_call's count: both layers' input and
        # recurrent products; x in, the sum out, the weights once
        b_ms, b_by = bound_ms(2.0 * 4 * h * 2 * h * t * lstm.LAYERS * b,
                              4.0 * (2 * b * t * h + n_weights), peak_flops, peak_bw)
        ms = cuda_ms(torch, lambda: lstm.lstm_residual(x, weights, lstm.LAYERS, packed))
        library_ms = cuda_ms(torch, lambda: lstm.lstm_residual_reference(x, weights, lstm.LAYERS))
        with torch.backends.cudnn.flags(enabled=False):
            plain_ms = cuda_ms(torch, lambda: lstm.lstm_residual_reference(x, weights, lstm.LAYERS),
                               warmup=1, reps=3)
        rows.append({"B": b, "T": t, "ms": ms, "us_per_frame": 1e3 * ms / t, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "max_abs_err": err, "launches": lstm.lstm_residual.launches - launches})
        emit({"phase": "kernel_stage", "name": "lstm_residual", **rows[-1]})
        del x, got, want
    return rows


def encodec_resblock_shapes(torch, peak_flops, peak_bw) -> list:
    """EnCodec's resblock kernel at the EnCodec cell's stage shapes
    (``ENCODEC_RESBLOCK`` x ``ENCODEC_STAGES``), with weights scaled as the
    benchmark's (1/sqrt(fan_in), unit biases): each shape against the plain
    version with cuDNN (the parent's chain of three convs and PyTorch's
    elementwise passes, as ``library_ms``) and without it (``plain_ms``:
    PyTorch's own convs), all three timed, with the shape's bound."""
    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.ops.cuda import encodec_resblock as rb

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)
    gd = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for c, div in ENCODEC_STAGES:
        c2 = c // 2
        w = [torch.randn(s, generator=g) / f**0.5 for s, f in (
            ((c2, c, 3), 3 * c), ((c2,), 1), ((c, c2, 1), c2), ((c,), 1), ((c, c, 1), c), ((c,), 1))]
        w = [t.to(dev) for t in w]
        packed = rb.pack_weights(*w)  # once, as the engine does
        for b, samples in ENCODEC_RESBLOCK:
            t = samples // div
            x = torch.randn((b, c, t), generator=gd, device=dev) * 0.5
            valid = torch.randint(t // 2, t + 1, (b,), generator=gd, device=dev, dtype=torch.int32)
            valid[0] = t
            x = torch.where(torch.arange(t, device=dev) < valid[:, None, None], x, 0.0)
            launches = rb.resblock_elu.launches
            got = rb.resblock_elu(x, valid, *w, packed=packed)
            check(rb.resblock_elu.launches == launches + 1,
                  f"encodec resblock C={c} B={b} T={t}: the wrapper did not launch the kernel")
            with ieee_fp32():
                want = rb.resblock_elu_reference(x, valid, *w)
                torch.cuda.synchronize()
                err, scale = float((got - want).abs().max()), float(want.abs().max())
                check(err <= 1e-5 * scale,
                      f"encodec resblock C={c} B={b} T={t}: max err {err} > 1e-5 * {scale}")
                del got, want
                ms = cuda_ms(torch, lambda: rb.resblock_elu(x, valid, *w, packed=packed))
                library_ms = cuda_ms(torch, lambda: rb.resblock_elu_reference(x, valid, *w))
                with torch.backends.cudnn.flags(enabled=False):
                    plain_ms = cuda_ms(torch, lambda: rb.resblock_elu_reference(x, valid, *w),
                                       warmup=1, reps=3)
            # pbkit/encodec_flops's count for the block: its k3, k1 and
            # shortcut products; x in, ye out, the weights once
            n_weights = 3 * c * c2 + c2 + c * c2 + c * c + 2 * c
            b_ms, b_by = bound_ms(6.0 * c * c * b * t, 4.0 * (2 * b * c * t + n_weights + b),
                                  peak_flops, peak_bw)
            rows.append({"C": c, "B": b, "T": t, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "max_abs_err": err, "max_abs_plain": scale,
                         "launches": rb.resblock_elu.launches - launches})
            emit({"phase": "kernel_stage", "name": "encodec_resblock_elu", **rows[-1]})
            del x
        torch.cuda.empty_cache()
    return rows


def rvq_max_active_clusters():
    """How many clusters of each RVQ kernel variant the card holds at once
    (D = 256), by cudaOccupancyMaxActiveClusters."""
    from tokenize_audio_tpu_torch.ops.cuda import _build

    count = _build.load("rvq", "rvq_variant_count", [])()
    out = (ctypes.c_int * count)()
    fn = _build.load("rvq", "rvq_max_active_clusters",
                     [ctypes.c_int, ctypes.c_void_p, ctypes.c_int])
    err = fn(RVQ_SHAPE["d"], ctypes.addressof(out), count)
    check(err == 0, f"rvq_max_active_clusters: cudaError {err}")
    return list(out)


OPTIONAL_LIBRARIES = ("pandas", "pyarrow", "transformers", "tokenizers", "huggingface_hub",
                      "safetensors")
_IMPORT_PROBE = """
import importlib, json
out = {}
for name in %r:
    try:
        out[name] = getattr(importlib.import_module(name), "__version__", "imported")
    except Exception:  # absent, or present and broken: not importable here
        out[name] = None
print(json.dumps(out))
"""


def optional_libraries() -> dict:
    """Which optional libraries import on this machine (name -> version, or
    None), probed in a child process so that nothing they load stays in
    this one. Information only: no phase depends on it."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE % (OPTIONAL_LIBRARIES,)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        return {"probe_failed": out.stderr[-2000:]}
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_kernels(torch, peak_flops, peak_bw, rvq_extras):
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

    dev = torch.device("cuda")
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    rng = np.random.default_rng(SEED)
    records = []
    with ieee_fp32():
        # --- RVQ: the full-size random codebooks, 1 semantic + 31 acoustic
        n, d, v, k = (RVQ_SHAPE[s] for s in ("n", "d", "v", "k"))
        embeds = np.concatenate(
            [params["rvq"]["semantic"]["embed"], params["rvq"]["acoustic"]["embed"]]
        )[:k]
        embeds = torch.from_numpy(np.ascontiguousarray(embeds)).to(dev)
        x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
        packed = rvq.pack_codebooks(embeds)  # once, as the engine does
        got = rvq.rvq_quantize(x, embeds, packed=packed)
        want = rvq.rvq_quantize_reference(x, embeds)
        torch.cuda.synchronize()
        match, n_rows, max_margin, gap = rvq_agreement(x, embeds, got, want, "rvq kernel")
        ms = cuda_ms(torch, lambda: rvq.rvq_quantize(x, embeds, packed=packed))
        plain_ms = cuda_ms(torch, lambda: rvq.rvq_quantize_reference(x, embeds))
        others = {}
        time_rvq_extras(torch, others, rvq_extras, x, embeds, packed, want, f"N={n} K={k}")
        # the main path's batches are small: time one at its mean row count
        xs = x[:RVQ_SMALL_N].contiguous()
        packed_ac = (packed[0][1:], packed[1][1:])
        small = {
            "N": RVQ_SMALL_N, "K": k - 1,
            "ms": cuda_ms(torch, lambda: rvq.rvq_quantize(xs, embeds[1:], packed=packed_ac)),
            "plain_ms": cuda_ms(torch, lambda: rvq.rvq_quantize_reference(xs, embeds[1:])),
        }
        flops = 2.0 * k * n * v * d
        nbytes = 4.0 * (k * v * d + n * d + n * k)
        b_ms, b_by = bound_ms(flops, nbytes, peak_flops, peak_bw)
        records.append({
            "name": "rvq_quantize",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/rvq.cu",
            "replaces": "tokenize_audio_tpu/ops/pallas/rvq.py:82",
            "launches": None,
            "max_abs_err": gap,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "shape": {"N": n, "D": d, "V": v, "K": k},
            "code_match": match,
            "diverging_rows": n_rows,
            "max_rel_margin": max_margin,
            **others,
            "small_batch": small,
            "encodec": rvq_encodec_shapes(torch, rng, peak_flops, peak_bw),
            "max_active_clusters_per_variant": rvq_max_active_clusters(),
        })
        del packed, packed_ac
        emit({"phase": "kernel", **records[-1]})

        # --- EnCodec's LSTM: the engine-web.encodec-8cb cell's batches
        shapes = lstm_encodec_shapes(torch, peak_flops, peak_bw)
        records.append({
            "name": "lstm_residual",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/lstm.cu",
            "replaces": "cuDNN's torch.lstm (no TPU kernel: the JAX package has no EnCodec)",
            "launches": sum(r["launches"] for r in shapes),
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in shapes) else "bytes",
            "library_ms": sum(r["library_ms"] for r in shapes),
            "shape": "sum of engine-web.encodec-8cb's longest 1-, 5- and 24-row batches",
            "stages": shapes,
        })
        emit({"phase": "kernel", **records[-1]})

        # --- EnCodec's resblock: the engine-web.encodec-8cb cell's stages
        shapes = encodec_resblock_shapes(torch, peak_flops, peak_bw)
        records.append({
            "name": "encodec_resblock_elu",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/encodec_resblock.cu",
            "replaces": "cuDNN's three convs and PyTorch's elementwise passes (no TPU kernel: "
                        "the JAX package has no EnCodec)",
            "launches": sum(r["launches"] for r in shapes),
            "max_abs_err": max(r["max_abs_err"] for r in shapes),
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in shapes) else "bytes",
            "library_ms": sum(r["library_ms"] for r in shapes),
            "shape": "sum of the four stages of engine-web.encodec-8cb's largest and a mean batch",
            "stages": shapes,
        })
        emit({"phase": "kernel", **records[-1]})

        # --- SEANet resblock: the four stage shapes of a 16 x 10 s batch
        t_audio = int(RESBLOCK_SECONDS * SR)
        stages, tot_ms, tot_plain, tot_bound, worst = [], 0.0, 0.0, 0.0, 0.0
        t, c = t_audio, cfg.num_filters
        for block, stride in zip(params["blocks"], cfg.encoder_strides):
            res = block["res"][0]
            w = [torch.from_numpy(res[a][p]).to(dev) for a in ("c1", "c2") for p in ("w", "b")]
            w3, b3, w1, b1 = w
            packed = seanet.pack_weights(w3, w1)
            xs = rng.standard_normal((RESBLOCK_BATCH, c, t)).astype(np.float32) * 0.5
            valid = rng.integers(t // 2, t + 1, RESBLOCK_BATCH).astype(np.int32)
            valid[0] = t
            for i, vl in enumerate(valid):
                xs[i, :, vl:] = 0.0  # the masked invariant the model keeps
            xt = torch.from_numpy(xs).to(dev)
            vt = torch.from_numpy(valid).to(dev)
            del xs
            got = seanet.resblock_elu(xt, vt, w3, b3, w1, b1, packed=packed)
            want = seanet.resblock_elu_reference(xt, vt, w3, b3, w1, b1)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            check(err <= 1e-4 * scale, f"resblock C={c}: max err {err} > 1e-4 * {scale}")
            del got, want
            ms = cuda_ms(torch, lambda: seanet.resblock_elu(xt, vt, w3, b3, w1, b1, packed=packed))
            plain_ms = cuda_ms(
                torch, lambda: seanet.resblock_elu_reference(xt, vt, w3, b3, w1, b1), reps=5
            )
            c2 = c // 2
            flops = 2.0 * (3 * c * c2 + c * c2) * RESBLOCK_BATCH * t
            nbytes = 4.0 * (2 * RESBLOCK_BATCH * c * t + 4 * c * c2 + c2 + c + RESBLOCK_BATCH)
            b_ms, b_by = bound_ms(flops, nbytes, peak_flops, peak_bw)
            stages.append({
                "C": c, "T": t, "B": RESBLOCK_BATCH, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "max_abs_plain": scale,
            })
            emit({"phase": "kernel_stage", "name": "resblock_elu", **stages[-1]})
            tot_ms, tot_plain, tot_bound = tot_ms + ms, tot_plain + plain_ms, tot_bound + b_ms
            worst = max(worst, err)
            del xt
            torch.cuda.empty_cache()
            t, c = t // stride, c * 2
        records.append({
            "name": "resblock_elu",
            "route": "cuda",
            "source": "tokenize_audio_tpu_torch/csrc/seanet_resblock.cu",
            "replaces": "tokenize_audio_tpu/ops/pallas/seanet.py:137",
            "launches": None,
            "max_abs_err": worst,
            "ms": tot_ms,
            "plain_ms": tot_plain,
            "bound_ms": tot_bound,
            "bound_by": "operations" if all(s["bound_by"] == "operations" for s in stages) else "bytes",
            "library_ms": None,
            "shape": "sum of the four stage shapes of one 16 x 10 s batch",
            "stages": stages,
        })
    return records


def tone_pcm(rng, seconds: float, sr: int = SR):
    """int16 PCM of a random 80-400 Hz tone (0.3) plus noise (0.1)."""
    n = int(seconds * sr)
    tt = np.arange(n) / sr
    tone = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * tt)
    noise = 0.1 * rng.standard_normal(n)
    return (np.clip(tone + noise, -1, 1) * 32767).astype(np.int16)


def make_subshard(rng):
    """~48 int16 utterances with lognormal durations in [1, 30] s, plus one
    75 s utterance that the 60 s cap splits."""
    durs = np.clip(rng.lognormal(math.log(6.0), 0.8, 48), 1.0, 30.0).tolist() + [75.0]
    return [tone_pcm(rng, dur) for dur in durs]


class KernelSpy:
    """Replaces both kernel wrappers by spies that record, while ``active``,
    the (B, C, T) of each resblock launch and the (N, K) of each RVQ launch
    (which must pass the packed codebooks). While a spy is installed the
    wrapper's launch count (kept on its module-global name) is the spy's."""

    def __init__(self, active: bool = True):
        from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

        self.rvq, self.seanet = rvq, seanet
        self.active = active
        self.shapes, self.rvq_shapes = collections.Counter(), collections.Counter()

    def __enter__(self):
        self.orig = orig_rb, orig_rvq = self.seanet.resblock_elu, self.rvq.rvq_quantize

        def rb_spy(x, *args, **kwargs):
            if self.active:
                self.shapes[tuple(x.shape)] += 1
            return orig_rb(x, *args, **kwargs)

        def rvq_spy(x, embeds, *args, **kwargs):
            check(kwargs.get("packed") is not None, "an RVQ launch without the packed codebooks")
            if self.active:
                self.rvq_shapes[(x.shape[0], embeds.shape[0])] += 1
            return orig_rvq(x, embeds, *args, **kwargs)

        self.seanet.resblock_elu, self.rvq.rvq_quantize = rb_spy, rvq_spy
        self.reset()
        return self

    def reset(self):
        self.rvq.rvq_quantize.launches = 0
        self.seanet.resblock_elu.launches = 0

    def launches(self):
        return {"rvq_quantize": self.rvq.rvq_quantize.launches,
                "resblock_elu": self.seanet.resblock_elu.launches}

    def __exit__(self, *exc):
        self.seanet.resblock_elu, self.rvq.rvq_quantize = self.orig


# DAC 44.1 kHz: its cell's configuration, engine settings and limit
DAC_CELL = "engine-web.dac-44k-9cb"
# one batch: 16 ragged rows whose whole-frame lengths share the 7.04 s
# bucket of the cell's lattice (2 s x 1.15^n), 27 rows of 192 s
DAC_UTTERANCES, DAC_SECONDS = 16, (6.2, 7.0)
DAC_SNAKES = 29  # a batch: 7 in each of the four blocks and the last one


def phase_dac(torch):
    """DAC at the published widths through ``MimiEncoderEngine``: one web
    batch of seeded int16 utterances of ragged lengths, each row's codes
    against the plain reference's quantizer input under the cell's
    ``code_gap_max``, TF32 off inside the encode, and 29 Snakes."""
    bench = Path(__file__).resolve().parent / "port_bench"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    from reference import dac_ref, dac_weights
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.dac import model as dac_model
    from tokenize_audio_tpu_torch.dac.config import DacConfig
    from tokenize_audio_tpu_torch.dac.weights import convert_hf_state_dict
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

    cfg_d = json.loads((bench / "configs" / "dac-44k-9cb.json").read_text())
    cell = json.loads((bench / "cells" / f"{DAC_CELL}.json").read_text())
    keys = {f.name for f in dataclasses.fields(DacConfig)}
    cfg = DacConfig(**{k: v for k, v in cfg_d.items() if k in keys})
    rate, books = cfg.sampling_rate, cfg_d["run"]["num_codebooks"]
    sd = dac_weights.state_dict(cfg_d, SEED, torch.device("cuda"))
    engine = MimiEncoderEngine(convert_hf_state_dict(sd, cfg), cfg,
                               EngineConfig(sample_rate=rate, **cell["engine"]), num_codebooks=books)
    rng = np.random.default_rng(SEED + 7)
    secs = rng.uniform(*DAC_SECONDS, DAC_UTTERANCES)
    audios = [np.clip(rng.standard_normal(int(t * rate)) * 0.3 * 32767, -32768, 32767).astype(np.int16)
              for t in secs]
    seen = {}
    orig = dac_model.rvq_encode

    def spy(*args, **kwargs):
        seen["cudnn.allow_tf32"] = torch.backends.cudnn.allow_tf32
        seen["cuda.matmul.allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
        return orig(*args, **kwargs)

    dac_model.rvq_encode = spy
    try:
        snakes = dac_model.launches
        t0 = time.perf_counter()
        codes = engine.encode_batch(audios, sr=rate)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        snakes = dac_model.launches - snakes
    finally:
        dac_model.rvq_encode = orig
    batches = engine.stats.batches
    check(seen and not any(seen.values()), f"DAC: TF32 flags inside encode: {seen}")
    check(batches == 1 and snakes == DAC_SNAKES,
          f"DAC: {snakes} Snakes in {batches} batches, not {DAC_SNAKES} in one")
    gaps, used = [], [set() for _ in range(books)]
    for a, c in zip(audios, codes):
        check(c.shape == (books, -(-len(a) // cfg.hop_length)) and c.dtype == np.uint16
              and int(c.max()) < cfg.codebook_size, f"DAC codes {c.shape} {c.dtype} for {len(a)}")
        x = torch.from_numpy(a).cuda().float() / 32768.0
        emb = dac_ref.embeddings(sd, cfg_d, x)
        c64 = torch.from_numpy(c.astype(np.int64)).cuda()
        gaps.append(float(dac_ref.code_gaps(sd, cfg_d, emb, c64).max()))
        for book, row in zip(used, c):
            book.update(row.tolist())
    limit = cell["limits"]["code_gap_max"]
    check(max(gaps) <= limit, f"DAC: code_gap_max {max(gaps)} over the cell's {limit}")
    audio_s = sum(len(a) for a in audios) / rate
    emit({"phase": "dac", "utterances": len(audios), "audio_seconds": audio_s, "batches": batches,
          "snakes": snakes, "code_gap_max": max(gaps), "limit": limit,
          "distinct_codes": [len(b) for b in used], "first_call_rtf": audio_s / wall,
          "peak_bytes": int(torch.cuda.max_memory_allocated())})
    return {"batches": batches, "snakes": snakes}


def phase_main(torch):
    from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, model, params_to_torch, random_params
    from tokenize_audio_tpu_torch.qualify import TIE_MARGIN

    cfg = MimiConfig()
    params = params_to_torch(random_params(cfg, seed=SEED))  # on the card
    rng = np.random.default_rng(SEED + 1)
    audios = make_subshard(rng)
    audio_seconds = sum(len(a) for a in audios) / SR

    # TF32 flags as seen inside encode
    seen = {}
    orig_tfm = model.transformer_apply

    def spy(*args, **kwargs):
        seen["cudnn.allow_tf32"] = torch.backends.cudnn.allow_tf32
        seen["cuda.matmul.allow_tf32"] = torch.backends.cuda.matmul.allow_tf32
        return orig_tfm(*args, **kwargs)

    model.transformer_apply = spy
    try:
        engine = MimiEncoderEngine(params, cfg, num_codebooks=32)
        engine.encode_batch(audios[:4], sr=SR)  # first-use set-up, not counted
        torch.cuda.synchronize()
        engine.stats = EngineStats()
        # the kernels' shapes on the main path
        with KernelSpy() as kernels, RvqCallSpy() as kernel_rvq:
            t0 = time.perf_counter()
            finish = engine.encode_batch(audios, sr=SR, defer=True)
            codes = finish()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launches()
        shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    finally:
        model.transformer_apply = orig_tfm
    check(seen and not any(seen.values()), f"TF32 flags inside encode: {seen}")
    check(all(n > 0 for n in launches.values()), f"kernel launches on the main path: {launches}")
    check(sum(shapes.values()) == launches["resblock_elu"],
          f"resblock shapes {sum(shapes.values())} vs launches {launches['resblock_elu']}")
    check(sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"rvq shapes {sum(rvq_shapes.values())} vs launches {launches['rvq_quantize']}")
    check(len(codes) == len(audios), "one code array per utterance")
    for a, c in zip(audios, codes):
        check(c.shape == (32, -(-len(a) // SPF)), f"codes shape {c.shape} for {len(a)} samples")
        check(c.dtype == np.int32 and c.min() >= 0 and c.max() < cfg.codebook_size, "code range")
    stats = engine.stats.as_dict()

    profile = device_breakdown(
        torch, lambda: engine.encode_batch(audios, sr=SR, defer=True)()
    )

    # the same sub-shard through the plain-PyTorch backends on the same card
    plain_cfg = dataclasses.replace(cfg, rvq_backend="torch", seanet_backend="torch")
    plain_engine = MimiEncoderEngine(params, plain_cfg, num_codebooks=32)
    plain_engine.encode_batch(audios[:4], sr=SR)
    torch.cuda.synchronize()
    with RvqCallSpy() as plain_rvq:
        t0 = time.perf_counter()
        plain_codes = plain_engine.encode_batch(audios, sr=SR)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    plain_profile = device_breakdown(torch, lambda: plain_engine.encode_batch(audios, sr=SR))
    ab = interleaved_rtf(torch, {"kernel": engine, "torch": plain_engine}, audios, audio_seconds)
    same = np.concatenate([(a == b).reshape(-1) for a, b in zip(codes, plain_codes)])
    frames_same = np.concatenate([(a == b).all(axis=0) for a, b in zip(codes, plain_codes)])
    code_match, frame_match = float(same.mean()), float(frames_same.mean())
    # summation-order deltas flip only near-ties (and the books after them in
    # that frame): the qualify phase's census bounds how often, and each
    # first divergence must be a near-tie, replayed on the plain run's RVQ
    # input of the same batched calls in which the two backends diverged
    check(frame_match >= 0.999, f"kernel vs torch backend frame match {frame_match}")
    check(len(kernel_rvq.calls) == len(plain_rvq.calls)
          and all(k[0].shape == p[0].shape for k, p in zip(kernel_rvq.calls, plain_rvq.calls)),
          "the two backends' batched runs made the same RVQ calls")
    margins, call_frames = [], 0
    for (_, got), (emb, want) in zip(kernel_rvq.calls, plain_rvq.calls):
        m, n = row_tie_margins(torch, plain_engine.params["rvq"], emb, got.cpu().numpy(),
                               want.cpu().numpy(), "kernel vs torch backend")
        margins, call_frames = margins + m, call_frames + n
    # every differing frame of the returned codes is a frame of some call
    check(call_frames >= int((~frames_same).sum()),
          f"the batched RVQ calls hold {call_frames} differing frames, "
          f"the codes {int((~frames_same).sum())}")
    max_margin = max(margins, default=0.0)
    check(max_margin < TIE_MARGIN,
          f"kernel vs torch backend: a first divergence is no near-tie: {max_margin}")
    emit({
        "phase": "main",
        "utterances": len(audios),
        "audio_seconds": audio_seconds,
        "wall_seconds": wall,
        "realtime_factor": audio_seconds / wall,
        "launches": launches,
        "tf32_inside_encode": seen,
        "engine_stats": stats,
        "torch_backend_wall_seconds": plain_wall,
        "torch_backend_realtime_factor": audio_seconds / plain_wall,
        "kernel_vs_torch_backend_code_match": code_match,
        "kernel_vs_torch_backend_frame_match": frame_match,
        "kernel_vs_torch_backend_flip_margins": margins,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    emit({"phase": "main_ab", **ab})
    emit({"phase": "main_profile", "backend": "kernel", **profile})
    emit({"phase": "main_profile", "backend": "torch", **plain_profile})
    return launches, shapes, rvq_shapes


class RvqCallSpy:
    """While open, records the RVQ input and (B, K, T) codes of every
    ``split_rvq_encode`` call, as device tensors (no sync)."""

    def __enter__(self):
        from tokenize_audio_tpu_torch.mimi import model

        self.model, self.orig, self.calls = model, model.split_rvq_encode, []

        def spy(p, emb, *args, **kwargs):
            codes = self.orig(p, emb, *args, **kwargs)
            self.calls.append((emb, codes))
            return codes

        model.split_rvq_encode = spy
        return self

    def __exit__(self, *exc):
        self.model.split_rvq_encode = self.orig


def interleaved_rtf(torch, engines, audios, audio_seconds, pairs: int = AB_PAIRS):
    """Real-time factor of each engine over ``pairs`` rounds, alternating
    which runs first (one process, one card)."""
    runs = {name: [] for name in engines}
    names = list(engines)
    for i in range(pairs):
        for name in names if i % 2 == 0 else names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].encode_batch(audios, sr=SR, defer=True)()
            torch.cuda.synchronize()
            runs[name].append(audio_seconds / (time.perf_counter() - t0))
    return {
        "pairs": pairs,
        "median_rtf": {n: float(np.median(r)) for n, r in runs.items()},
        "rtf_runs": runs,
    }


def device_breakdown(torch, run, top: int = 12):
    """One profiled run of ``run``: device time by kernel name (top
    ``top``), the summed time of each of this port's kernels (all its
    template instances), total device time, wall time and the device's busy
    share (union of device intervals over the wall)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return profile_summary(prof, wall, top)


def profile_summary(prof, wall: float, top: int = 12):
    """``device_breakdown``'s summary of a finished profile of ``wall``
    seconds."""
    from torch.autograd import DeviceType

    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events() if e.device_type == DeviceType.CUDA
    )
    if not spans:
        return {"device_time": "not measured (no device events in the trace)"}
    by_name, busy, cur_s, cur_e = {}, 0.0, spans[0][0], spans[0][1]
    for s, e, name in spans:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + (e - s)
        if s > cur_e:
            busy, cur_s = busy + (cur_e - cur_s), s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(by_name.values())
    top_k = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {
        "wall_ms": wall * 1e3,
        "device_ms": total / 1e3,
        "busy_share": busy / 1e6 / wall,
        "top_kernels_ms": [[n, t / 1e3] for n, t in top_k],
        "port_kernels_ms": {
            k: sum(t for n, t in by_name.items() if k in n) / 1e3
            for k in ("rvq_kernel", "resblock_kernel")
        },
    }


YODAS2_SHARD, YODAS2_SUBSHARDS, YODAS2_ENTRIES = "en000", 2, 24
# the mirror writer (tests/torch_yodas2_mirror.py) and the FLAC encoder it
# uses are imported by their own names: an installed ``tests`` package would
# shadow ``tests.*``
TESTS_DIR = Path(__file__).resolve().parent / "tests"
YODAS2_STAGES = ("source_fetch", "host_extract", "host_decode", "resample", "host_slice",
                 "host_serialize", "host_assemble", "hub_upload", "pad", "dispatch", "fetch")


def lognormal_chunks(rng, seconds: float, start_cs: int = 0):
    """Consecutive chunks (start_cs, end_cs) of lognormal 1-30 s (median
    6 s, as make_subshard) with gaps under 0.5 s, inside ``seconds``; at
    least one."""
    end_cs, t, chunks = int(seconds * 100), start_cs, []
    while True:
        d = int(np.clip(rng.lognormal(math.log(6.0), 0.8), 1.0, 30.0) * 100)
        if t + d > end_cs:
            break
        chunks.append((t, t + d))
        t += d + int(rng.integers(0, 50))
    return chunks or [(start_cs, end_cs)]


def make_yodas2_mirror(rng):
    """YODAS2_SUBSHARDS sub-shards of YODAS2_ENTRIES entries: 10-60 s of
    16-bit 24 kHz WAV, but entry 1 of each sub-shard is a 4 s FLAC and entry
    2 a 16 kHz WAV; entry 0 of sub-shard 0 is 75 s long and starts with a
    65 s chunk (split by the engine's 60 s cap) and a degenerate one."""
    from torch_yodas2_mirror import Entry

    subshards = []
    for s in range(YODAS2_SUBSHARDS):
        entries = []
        for a in range(YODAS2_ENTRIES):
            container, sr = ("flac", SR) if a == 1 else ("wav", 16_000 if a == 2 else SR)
            seconds = 75.0 if (s, a) == (0, 0) else 4.0 if a == 1 else float(rng.uniform(10, 60))
            if (s, a) == (0, 0):
                chunks = [(0, 6500), (6500, 6500)] + lognormal_chunks(rng, seconds, 6520)
            else:
                chunks = lognormal_chunks(rng, seconds)
            n = int(seconds * sr)
            tt = np.arange(n) / sr
            wave = 0.3 * np.sin(2 * np.pi * rng.uniform(80, 400) * tt) + 0.1 * rng.standard_normal(n)
            pcm = (np.clip(wave, -1, 1) * 32767).astype(np.int16)
            entries.append(Entry(f"yt{s}-{a:02d}", pcm, sr, container, chunks))
        subshards.append(entries)
    return subshards


class ThreadFlagSpy:
    """Records both TF32 flags, and whether the caller is the main thread,
    at every call of ``torch.nn.functional.conv1d`` (the resample conv and
    the model's convs), of ``model.transformer_apply`` and of each of
    ``extra`` ((module, attribute, label) triples); a conv1d called inside
    ``core.audio._resample_batch`` (``resample``, ``resample_many`` and the
    fused resample in ``encode``) is also recorded as ``resample_conv1d``."""

    def __init__(self, torch, extra=()):
        from tokenize_audio_tpu_torch.core import audio
        from tokenize_audio_tpu_torch.mimi import model

        self.torch, self.audio = torch, audio
        self.calls = []  # (what, main thread?, cudnn.allow_tf32, cuda.matmul.allow_tf32)
        self.targets = [(torch.nn.functional, "conv1d", "conv1d"),
                        (model, "transformer_apply", "transformer_apply"), *extra]
        self.orig = [getattr(mod, attr) for mod, attr, _ in self.targets]
        self.orig_resample = audio._resample_batch
        self.local = threading.local()

    def _record(self, what):
        torch = self.torch
        self.calls.append((what, threading.current_thread() is threading.main_thread(),
                           torch.backends.cudnn.allow_tf32,
                           torch.backends.cuda.matmul.allow_tf32))

    def _wrap(self, what, fn):
        def spy(*args, **kwargs):
            self._record(what)
            if what == "conv1d" and getattr(self.local, "resampling", False):
                self._record("resample_conv1d")
            return fn(*args, **kwargs)

        return spy

    def _resample(self, *args, **kwargs):
        self.local.resampling = True
        try:
            return self.orig_resample(*args, **kwargs)
        finally:
            self.local.resampling = False

    def __enter__(self):
        for (mod, attr, what), fn in zip(self.targets, self.orig):
            setattr(mod, attr, self._wrap(what, fn))
        self.audio._resample_batch = self._resample
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.targets, self.orig):
            setattr(mod, attr, fn)
        self.audio._resample_batch = self.orig_resample

    def summary(self):
        out = {}
        for what, main, cudnn, matmul in self.calls:
            key = f"{what}_{'main' if main else 'other'}_threads"
            row = out.setdefault(key, {"calls": 0, "tf32_on": 0})
            row["calls"] += 1
            row["tf32_on"] += int(cudnn or matmul)
        return out


def run_yodas2_cli(torch, root, work, tag, captured, profiled=False, extra_args=()):
    """One run of the port's YODAS2 CLI (default flags plus ``extra_args``)
    on the mirror at ``root``, into a fresh hub, work and progress directory
    under ``work/tag``; returns the report, the hub directory and the wall
    seconds from the end of the engine's construction (its stats are reset
    there) to the report, and with ``profiled`` a torch.profiler device
    breakdown of that window."""
    from torch.profiler import ProfilerActivity, profile

    from tokenize_audio_tpu_torch.datasets import yodas2
    from tokenize_audio_tpu_torch.engine import EngineStats

    orig = yodas2.engine_from_args
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None

    def capture(*args, **kwargs):
        engine = orig(*args, **kwargs)
        torch.cuda.synchronize()
        engine.stats = EngineStats(started_at=time.perf_counter())
        captured[tag] = engine
        if prof is not None:
            prof.start()
        return engine

    hub = str(Path(work) / tag / "hub")
    yodas2.engine_from_args = capture
    try:
        report = yodas2.main([
            "--shard-id", YODAS2_SHARD, "--source", f"dir:{root}", "--hub", hub,
            "--progress-dir", str(Path(work) / tag / "progress"),
            "--work-dir", str(Path(work) / tag / "work"), *extra_args,
        ])
        torch.cuda.synchronize()
        wall = captured[tag].stats.wall_seconds
    finally:
        yodas2.engine_from_args = orig
        if prof is not None and tag in captured:
            prof.stop()
    check(report["processed"] == YODAS2_SUBSHARDS and report["failed"] == 0
          and report["uploaded"] == YODAS2_SUBSHARDS, f"yodas2 {tag} report {report}")
    return report, hub, wall, (profile_summary(prof, wall) if prof is not None else None)


def resample_tf32_check(torch):
    """Resamples on the card against the CPU, with both TF32 flags switched
    on by the caller: as ``resample`` / ``resample_many`` run them (the conv
    under ieee_fp32), and with ieee_fp32 taken out of the conv (as it ran
    before it was put there). 16 -> 24 kHz on one 20 s row (the processor's
    ``prepare_audio``) and on 64 rows of 1-20 s (``resample_many``), and
    48 -> 24 kHz on one row; max abs differences, the IEEE ones <= 1e-6."""
    import contextlib

    from tokenize_audio_tpu_torch.core import audio

    rng = np.random.default_rng(SEED + 5)
    cases = {
        "16k_to_24k_1x20s": (16_000, [rng.standard_normal(20 * 16_000)]),
        "16k_to_24k_64_rows": (16_000, [rng.standard_normal(int(rng.uniform(1, 20) * 16_000))
                                        for _ in range(64)]),
        "48k_to_24k_1x20s": (48_000, [rng.standard_normal(20 * 48_000)]),
    }
    out = {}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    orig = audio.ieee_fp32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for name, (sr, rows) in cases.items():
            rows = [(0.3 * r).astype(np.float32) for r in rows]
            want = audio.resample_many(rows, sr, SR, device="cpu")
            row = {}
            for mode, ctx in (("ieee", orig), ("tf32_conv", contextlib.nullcontext)):
                audio.ieee_fp32 = ctx
                got = audio.resample_many(rows, sr, SR)
                row[f"max_abs_diff_{mode}"] = max(float(np.abs(g - w).max())
                                                  for g, w in zip(got, want))
            audio.ieee_fp32 = orig
            out[name] = row
    finally:
        audio.ieee_fp32 = orig
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    worst = max(r["max_abs_diff_ieee"] for r in out.values())
    check(worst <= 1e-6, f"resample on the card vs CPU: max abs diff {worst} > 1e-6")
    return out


def hub_codes(hub) -> dict:
    """chunk id -> codes of every sub-shard JSON a YODAS2 run uploaded."""
    got = {}
    for s in range(YODAS2_SUBSHARDS):
        path = Path(hub) / "data" / YODAS2_SHARD / f"{s:08d}.json"
        check(path.is_file(), f"hub lacks {path}")
        for e in json.loads(path.read_text()):
            for cid, c in e["codes"].items():
                got[cid] = np.asarray(c)
    return got


def one_shot_codes(torch, params, cfg, audio, k: int = 32):
    """One utterance through ``mimi.model.encode`` on the card in one piece,
    with the plain-PyTorch ("torch") backends: (k, frames) codes and the
    RVQ's input (1, hidden, frames)."""
    from tokenize_audio_tpu_torch.mimi import model

    plain = dataclasses.replace(cfg, rvq_backend="torch", seanet_backend="torch")
    n = len(audio)
    padded = np.zeros(-(-n // SPF) * SPF, dtype=audio.dtype)
    padded[:n] = audio
    seen, orig = {}, model.split_rvq_encode

    def spy(p, emb, *args, **kwargs):
        seen["emb"] = emb
        return orig(p, emb, *args, **kwargs)

    model.split_rvq_encode = spy
    try:
        codes, valid = model.encode(params, plain, torch.from_numpy(padded)[None].cuda(),
                                    torch.tensor([n], dtype=torch.int32).cuda(), num_quantizers=k)
    finally:
        model.split_rvq_encode = orig
    return codes[0, :, : int(valid[0])].cpu().numpy(), seen["emb"]


def flip_margins(torch, rvq_params, emb, got, want, limit: int = 200):
    """The relative margin at each frame whose codes ``got`` differ from the
    plain one-shot codes ``want`` ((K, frames) each), replayed on the
    one-shot's RVQ input ``emb`` head by head (``first_divergence_margins``;
    at most ``limit`` frames are replayed)."""
    import torch.nn.functional as F

    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    if int((got != want).any(axis=0).sum()) > limit:
        return None
    margins = []
    with ieee_fp32():
        for head, lo, hi in (("semantic", 0, 1), ("acoustic", 1, got.shape[0])):
            if hi <= lo:
                continue
            p = rvq_params[head]
            x = F.conv1d(emb, p["in_proj"][:, :, None])[0].T.contiguous()
            g, w = (torch.from_numpy(np.ascontiguousarray(c[lo:hi].T)).to(x.device)
                    for c in (got, want))
            margins += rvq.first_divergence_margins(x, p["embed"][: hi - lo].contiguous(), g, w)[1]
    return margins


def phase_yodas2(torch, tmp):
    """The port's YODAS2 processor through ``datasets.yodas2.main``: a cold
    run, a checked run (kernel launches and shapes, TF32 flags in every
    thread, hub JSON, codes against a direct encode_batch of the same
    chunks), a run with ``--long-audio-policy stream`` (chunks up to 60 s
    equal to the checked run's, the longer one against a one-shot encode)
    and a profiled run. Returns the kernels' launch counts and shapes of the
    checked run, and the mirror's root and the checked run's hub."""
    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    from torch_yodas2_mirror import write_mirror
    from tokenize_audio_tpu_torch.datasets.yodas2 import parse_chunk_id, slice_chunks
    from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

    t0 = time.perf_counter()
    subshards = make_yodas2_mirror(np.random.default_rng(SEED + 6))
    root = write_mirror(str(Path(tmp) / "mirror"), YODAS2_SHARD, subshards)
    mirror_seconds = time.perf_counter() - t0
    entries = [e for sub in subshards for e in sub]
    captured = {}

    _, _, cold_wall, _ = run_yodas2_cli(torch, root, tmp, "cold", captured)
    cold_audio = captured.pop("cold").stats.audio_seconds

    with ThreadFlagSpy(torch) as spy, KernelSpy() as kernels:
        report, hub, wall, _ = run_yodas2_cli(torch, root, tmp, "checked", captured)
        launches = kernels.launches()
    shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    check(sum(shapes.values()) == launches["resblock_elu"]
          and sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"yodas2 shapes vs launches {launches}")
    engine = captured["checked"]
    stats, stages = engine.stats.as_dict(), dict(engine.stats.stage_seconds)
    check(all(n > 0 for n in launches.values()), f"kernel launches in the yodas2 run: {launches}")
    flags = spy.summary()
    check(all(row["tf32_on"] == 0 for row in flags.values()),
          f"TF32 flags on during the yodas2 run: {flags}")
    check(flags.get("conv1d_other_threads", {}).get("calls", 0) > 0,
          f"no conv1d (resample) in a prefetch thread: {flags}")
    check(flags.get("transformer_apply_main_threads", {}).get("calls", 0) > 0,
          f"no transformer_apply in the yodas2 run: {flags}")

    # the hub JSON: every non-degenerate chunk has (32, ceil(len / 1920)) codes < 2048
    got = hub_codes(hub)
    want_ids, segments = [], []
    for e in entries:
        audio24 = engine.prepare_audio(e.pcm, e.sample_rate)
        ids, segs = slice_chunks(audio24, e.text, SR)
        check(sorted(ids) == sorted(c for c in e.text if parse_chunk_id(c) is not None),
              f"{e.audio_id}: a chunk outside the audio")
        want_ids += ids
        segments += segs
    check(sorted(got) == sorted(want_ids), f"hub chunks {len(got)} vs {len(want_ids)} expected")
    for cid, seg in zip(want_ids, segments):
        c = got[cid]
        check(c.shape == (32, -(-len(seg) // SPF)), f"{cid}: codes {c.shape} for {len(seg)} samples")
        check(c.min() >= 0 and c.max() < 2048, f"{cid}: code out of range")
    check(max(len(s) for s in segments) > 60 * SR, "no chunk over the 60 s cap")
    check(sum(parse_chunk_id(c) is None for e in entries for c in e.text) > 0,
          "no degenerate chunk")

    # the same chunks through encode_batch directly, in this process, on this card
    chunk_seconds = sum(len(s) for s in segments) / SR
    engine.encode_batch(segments, sr=SR, defer=True)()  # its batch shapes, first pass
    torch.cuda.synchronize()
    r0, s0 = rvq.rvq_quantize.launches, seanet.resblock_elu.launches
    t0 = time.perf_counter()
    direct = engine.encode_batch(segments, sr=SR, defer=True)()
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    direct_launches = {"rvq_quantize": rvq.rvq_quantize.launches - r0,
                       "resblock_elu": seanet.resblock_elu.launches - s0}
    frames = np.concatenate([(got[cid] == d).all(axis=0) for cid, d in zip(want_ids, direct)])
    codes = np.concatenate([(got[cid] == d).reshape(-1) for cid, d in zip(want_ids, direct)])
    frame_match, code_match = float(frames.mean()), float(codes.mean())
    check(frame_match >= 0.999, f"processor vs direct encode_batch frame match {frame_match}")
    stream_run = yodas2_stream_run(torch, root, tmp, captured, got, want_ids, segments,
                                   engine.params, engine.cfg)
    del engine
    captured.clear()

    *_, profile = run_yodas2_cli(torch, root, tmp, "profiled", captured, profiled=True)
    captured.clear()
    resample = resample_tf32_check(torch)
    emit({
        "phase": "yodas2",
        "report": report,
        "subshards": YODAS2_SUBSHARDS,
        "entries": len(entries),
        "chunks": len(want_ids),
        "entry_audio_seconds": sum(len(e.pcm) / e.sample_rate for e in entries),
        "audio_seconds": chunk_seconds,
        "mirror_build_seconds": mirror_seconds,
        "wall_seconds": wall,
        "realtime_factor": chunk_seconds / wall,
        "cold_wall_seconds": cold_wall,
        "cold_realtime_factor": cold_audio / cold_wall,
        "direct_encode_batch_wall_seconds": direct_wall,
        "direct_encode_batch_realtime_factor": chunk_seconds / direct_wall,
        "direct_encode_batch_launches": direct_launches,
        "launches": launches,
        "tf32_calls": flags,
        "vs_direct_frame_match": frame_match,
        "vs_direct_frames_equal": int(frames.sum()),
        "vs_direct_frames": int(frames.size),
        "vs_direct_code_match": code_match,
        "stage_seconds": {k: stages.get(k, 0.0) for k in YODAS2_STAGES},
        "engine_stats": stats,
        "resample_vs_cpu_tf32_on": resample,
        "stream_run": stream_run,
    })
    emit({"phase": "yodas2_profile", **profile})
    return launches, shapes, rvq_shapes, {"root": root, "hub": hub}


def yodas2_stream_run(torch, root, tmp, captured, split_codes, ids, segments, params, cfg):
    """The YODAS2 CLI with ``--long-audio-policy stream`` on the same
    mirror: every chunk up to the 60 s cap must get the split run's codes,
    and each longer one its one-shot codes on >= 0.999 of frames."""
    with KernelSpy() as kernels:
        report, hub, wall, _ = run_yodas2_cli(torch, root, tmp, "stream", captured,
                                              extra_args=["--long-audio-policy", "stream"])
        launches = kernels.launches()
    engine = captured.pop("stream")
    check(engine.engine_cfg.long_audio_policy == "stream", "the stream run's engine policy")
    stream_seconds = engine.stats.stage_seconds.get("stream", 0.0)
    check(stream_seconds > 0, "the stream run streamed nothing")
    got = hub_codes(hub)
    check(sorted(got) == sorted(ids), "stream run hub chunks differ from the split run's")
    short_frames = short_equal = long_frames = long_equal = 0
    margins = []
    for cid, seg in zip(ids, segments):
        if len(seg) <= 60 * SR:
            short_frames += got[cid].shape[1]
            short_equal += int((got[cid] == split_codes[cid]).all(axis=0).sum())
            continue
        ref, emb = one_shot_codes(torch, params, cfg, seg)
        check(got[cid].shape == ref.shape, f"{cid}: streamed {got[cid].shape} vs {ref.shape}")
        long_frames += ref.shape[1]
        long_equal += int((got[cid] == ref).all(axis=0).sum())
        m = flip_margins(torch, params["rvq"], emb, got[cid], ref)
        margins += m if m is not None else [float("nan")]
        del emb
    check(long_frames > 0, "no chunk over the cap in the stream run")
    check(short_equal == short_frames,
          f"stream run: {short_equal} of {short_frames} chunk frames up to 60 s equal the split run's")
    check(long_equal >= 0.999 * long_frames,
          f"stream run: {long_equal} of {long_frames} long-chunk frames equal the one-shot")
    return {"report": report, "wall_seconds": wall, "stream_stage_seconds": stream_seconds,
            "launches": launches, "frames_up_to_60s": short_frames,
            "frames_up_to_60s_equal_split": short_equal, "long_frames": long_frames,
            "long_frames_equal_one_shot": long_equal, "flip_rel_margins": margins}


# Launch sites of an encode and the fp32 mode the JAX package gives each
# under matmul_precision="high": the nearest enclosing function of a conv or
# matmul launch names its site. IEEE in every mode: the resample
# (core/audio.py:143 of the JAX package), the fused stage's down-conv
# (ops/pallas/seanet.py:177-178), the quantizer in_proj and the RVQ
# (mimi/model.py:331, 365, 370); the rest follows matmul_precision.
IEEE_SITES = ("_resample_batch", "resblock_elu_reference", "seanet_stage", "split_rvq_encode",
              "rvq_quantize_reference")
TF32_SITES = ("seanet_encode", "transformer_apply", "_encode", "_stream_step",
              "_transformer_step")
MODES = {"parity": {}, "tf32": {"matmul_precision": "high"},
         "bf16": {"compute_dtype": "bfloat16"}}
MODES_AB_PAIRS = 4
MODES_PROBE = dict(seconds=30.0, rounds=2)  # per autotune probe
MODES_STREAM_SECONDS = 75.0
# A broken mode scrambles codes wholesale (chance is 1/2048 per code). The
# floor is the CPU tests' bar for bf16 against parity (> 0.4 of codes,
# tests/test_torch_modes.py, as the JAX package's test_mimi_parity.py),
# held in every mode; the rates themselves are reported, not gated.
MODES_CODE_FLOOR = 0.4


def site_of(frame):
    while frame is not None:
        name = frame.f_code.co_name
        if name in IEEE_SITES:
            return name, "ieee"
        if name in TF32_SITES:
            return name, "tf32"
        frame = frame.f_back
    return None, None


class SiteFlagSpy:
    """Both TF32 flags at every F.conv1d, F.linear and torch.matmul call,
    with the caller's thread and launch site (``site_of``)."""

    def __init__(self, torch):
        import torch.nn.functional as F

        self.torch = torch
        self.targets = [(F, "conv1d"), (F, "linear"), (torch, "matmul")]
        self.orig = [getattr(m, a) for m, a in self.targets]
        self.calls = []  # (thread name, site, site mode, cudnn flag, matmul flag)

    def _wrap(self, fn):
        torch = self.torch

        def spy(*args, **kwargs):
            site, mode = site_of(sys._getframe(1))
            self.calls.append((threading.current_thread().name, site, mode,
                               torch.backends.cudnn.allow_tf32,
                               torch.backends.cuda.matmul.allow_tf32))
            return fn(*args, **kwargs)

        return spy

    def __enter__(self):
        for (m, a), fn in zip(self.targets, self.orig):
            setattr(m, a, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for (m, a), fn in zip(self.targets, self.orig):
            setattr(m, a, fn)

    def check(self, what, precision, threads=None):
        """Fails unless every call (of ``threads``, by name; all when None)
        saw its site's flags for an engine at ``precision`` ("ieee" or
        "tf32"); returns {site: {"calls", "tf32_on", "threads"}}."""
        out = {}
        for thread, site, mode, cudnn, matmul in self.calls:
            if threads is not None and thread not in threads:
                continue
            check(site is not None, f"{what}: a conv/matmul launch outside every known site")
            want = mode == "tf32" and precision == "tf32"
            check(cudnn == matmul == want,
                  f"{what}: {site} ({mode}) in {thread} saw TF32 flags {(cudnn, matmul)}")
            row = out.setdefault(site, {"calls": 0, "tf32_on": 0, "threads": []})
            row["calls"] += 1
            row["tf32_on"] += int(cudnn)
            if thread not in row["threads"]:
                row["threads"].append(thread)
        return out


def match_vs(codes, ref):
    """Per-book code match and whole-frame match of (K, frames) code lists."""
    same = np.concatenate([(a == b) for a, b in zip(codes, ref)], axis=1)
    return {"per_book": [float(x) for x in same.mean(axis=1)],
            "codes": float(same.mean()), "frames": float(same.all(axis=0).mean())}


def codes_equal(got, want, what):
    check(len(got) == len(want), f"{what}: {len(got)} code arrays vs {len(want)}")
    for g, w in zip(got, want):
        check(g.shape == w.shape and np.array_equal(g, w), f"{what}: codes differ")


def phase_modes(torch, tmp, mirror):
    """The engine's modes at full kyutai/mimi width (random weights, seed
    0), 32 codebooks, kernel backends, on the main phase's sub-shard:
    parity, matmul_precision="high" (TF32) and compute_dtype="bfloat16"
    with their launches, TF32 flags per launch site (and four 16 kHz
    utterances, for the fused resample), code match against parity and
    interleaved RTF; a parity and a TF32 engine at once in two threads; a
    75 s utterance streamed by a bf16 engine; the fifo and ready drains;
    the three probes and request_autotune; one injected fault at
    each retry site and a build failure; the YODAS2 CLI with --fast and
    with --precision high and the auto probes, on the ``yodas2`` phase's
    mirror. Returns each mode's kernel launches on the sub-shard."""
    from tokenize_audio_tpu_torch import cli
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine, encoder
    from tokenize_audio_tpu_torch.mimi import MimiConfig, params_to_torch, random_params
    from tokenize_audio_tpu_torch.mimi.streaming import StreamingMimiEncoder

    host_params = random_params(MimiConfig(), seed=SEED)
    params = params_to_torch(host_params)
    audios = make_subshard(np.random.default_rng(SEED + 1))
    audio_seconds = sum(len(a) for a in audios) / SR
    out = {"utterances": len(audios), "audio_seconds": audio_seconds}

    def make(mode="parity", **ecfg):
        cfg = MimiConfig(**MODES[mode])
        return MimiEncoderEngine(params, cfg, EngineConfig(**ecfg), num_codebooks=32)

    # four 16 kHz utterances: the resample fused into the encode
    rng16 = np.random.default_rng(SEED + 22)
    audios16 = [tone_pcm(rng16, float(rng16.uniform(3, 20)), 16_000) for _ in range(4)]
    # each mode once under the spies, then interleaved RTF rounds
    engines, codes, launches, sites = {}, {}, {}, {}
    for mode in MODES:
        engines[mode] = eng = make(mode)
        eng.encode_batch(audios[:4], sr=SR)  # first-use set-up, not counted
        torch.cuda.synchronize()
        with SiteFlagSpy(torch) as spy:
            with KernelSpy(active=False) as kernels:
                codes[mode] = eng.encode_batch(audios, sr=SR, defer=True)()
                torch.cuda.synchronize()
                launches[mode] = kernels.launches()
            eng.encode_batch(audios16, sr=16_000)
        sites[mode] = spy.check(mode, "tf32" if mode == "tf32" else "ieee")
    check(all(n > 0 for n in launches["parity"].values())
          and all(n > 0 for n in launches["tf32"].values()),
          f"parity and TF32 launch both kernels: {launches}")
    check(launches["bf16"]["resblock_elu"] == 0 and launches["bf16"]["rvq_quantize"] > 0,
          f"bf16 launches the RVQ kernel and not the (f32-only) resblock: {launches['bf16']}")
    check({"_resample_batch", "seanet_stage", "split_rvq_encode", "seanet_encode",
           "transformer_apply", "_encode"} <= set(sites["tf32"]),
          f"TF32 mode's launch sites: {sorted(sites['tf32'])}")
    check("seanet_stage" not in sites["bf16"], "bf16 ran the fused stage")
    ab = interleaved_rtf(torch, engines, audios, audio_seconds, pairs=MODES_AB_PAIRS)
    for mode in MODES:
        m = match_vs(codes[mode], codes["parity"])
        check(m["codes"] > MODES_CODE_FLOOR, f"{mode}: code match {m['codes']} vs parity")
        out[mode] = {"median_rtf": ab["median_rtf"][mode], "rtf_runs": ab["rtf_runs"][mode],
                     "launches": launches[mode], "vs_parity": m, "sites": sites[mode]}
    check(out["parity"]["vs_parity"]["codes"] == 1.0, "parity vs itself")

    # a parity engine and a TF32 engine at once, in two threads
    other = make_subshard(np.random.default_rng(SEED + 20))
    want_other = engines["tf32"].encode_batch(other, sr=SR)
    got, errors = {}, []
    # a batch shape the TF32 engine has seen replays its transformer from
    # a graph captured under TF32 flags (the precision is part of the key)
    replays_before = engines["tf32"].stats.transformer_graph_replays

    def run(name, eng, batch):
        try:
            got[name] = eng.encode_batch(batch, sr=SR)
        except Exception as e:  # reported below
            errors.append(repr(e))

    with SiteFlagSpy(torch) as spy:
        threads = [threading.Thread(target=run, args=("parity", engines["parity"], audios),
                                    name="parity"),
                   threading.Thread(target=run, args=("tf32", engines["tf32"], other),
                                    name="tf32")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        torch.cuda.synchronize()
    check(not any(t.is_alive() for t in threads) and not errors, f"concurrent run: {errors}")
    codes_equal(got["parity"], codes["parity"], "parity beside a TF32 engine")
    conc_sites = {"parity": spy.check("concurrent parity", "ieee", {"parity"}),
                  "tf32": spy.check("concurrent tf32", "tf32", {"tf32"})}
    check(conc_sites["tf32"].get("transformer_apply", {}).get("tf32_on", 0) > 0
          or engines["tf32"].stats.transformer_graph_replays > replays_before,
          "the concurrent TF32 engine ran no TF32 transformer")
    out["concurrent"] = {"sites": conc_sites, "tf32_vs_tf32_alone": match_vs(got["tf32"],
                                                                             want_other)}

    # a > 60 s utterance streamed by a bf16 engine: float32 stream codes
    long = [tone_pcm(np.random.default_rng(SEED + 21), MODES_STREAM_SECONDS)]
    stream_codes = {}
    for mode in ("parity", "bf16"):
        eng = make(mode, long_audio_policy="stream")
        stream_codes[mode] = eng.encode_batch(long, sr=SR)
        check(eng.stats.stage_seconds.get("stream", 0) > 0, f"{mode}: nothing streamed")
    codes_equal(stream_codes["bf16"], stream_codes["parity"], "bf16 engine's stream codes")
    out["stream"] = {"seconds": MODES_STREAM_SECONDS, "frames": int(stream_codes["bf16"][0].shape[1])}

    # the drains on the same batch list
    drains = {p: make(drain_policy=p) for p in ("fifo", "ready")}
    drain_codes = {p: e.encode_batch(audios, sr=SR) for p, e in drains.items()}
    codes_equal(drain_codes["ready"], drain_codes["fifo"], "ready drain vs fifo")
    check(drains["ready"].stats.frames == drains["fifo"].stats.frames
          and drains["ready"].stats.padded_frames == drains["fifo"].stats.padded_frames,
          "ready drain frame counters")
    codes_equal(drain_codes["fifo"], codes["parity"], "fifo drain vs the parity run")
    out["drains"] = interleaved_rtf(torch, drains, audios, audio_seconds, pairs=MODES_AB_PAIRS)

    # the probes, each leaving the engine in its pick
    eng = make()
    t0 = time.perf_counter()
    picks = {"transfer": eng.autotune_transfer(**MODES_PROBE),
             "depth": eng.autotune_pipeline_depth(**MODES_PROBE),
             "drain": eng.autotune_drain_policy(**MODES_PROBE)}
    probe_seconds = time.perf_counter() - t0
    check((eng.engine_cfg.code_transfer_format, eng.pipeline_depth, eng.engine_cfg.drain_policy)
          == (picks["transfer"], picks["depth"], picks["drain"]),
          f"engine not left in its picks {picks}")
    deferred = make()
    deferred.request_autotune(transfer=True, depth=True, **MODES_PROBE)
    codes_equal(deferred.encode_batch(audios, sr=SR), codes["parity"],
                "request_autotune's first batch vs parity")
    check(deferred._pending_autotune is None and deferred.last_autotune
          and deferred.last_autotune_depth, "request_autotune did not probe")
    out["autotune"] = {"picks": picks, "medians": {"transfer": eng.last_autotune,
                       "depth": {str(k): v for k, v in eng.last_autotune_depth.items()},
                       "drain": eng.last_autotune_drain}, "seconds": probe_seconds,
                       "deferred_picks": {"transfer": deferred.engine_cfg.code_transfer_format,
                                          "depth": deferred.pipeline_depth},
                       "deferred_medians": {"transfer": deferred.last_autotune,
                                            "depth": {str(k): v for k, v in
                                                      deferred.last_autotune_depth.items()}}}

    # one injected fault at each retry site; a build failure is not retried
    eng = make(long_audio_policy="stream")
    batch = audios[:6] + long
    want = eng.encode_batch(batch, sr=SR)

    def once(exc):
        left = {"n": 1}

        def wrap(fn):
            def call(*a, **k):
                if left["n"]:
                    left["n"] -= 1
                    raise exc()
                return fn(*a, **k)
            return call
        return wrap

    oom = once(lambda: torch.OutOfMemoryError("injected: CUDA out of memory"))
    retries = {}
    for site, (obj, attr, wrap) in {
        "dispatch": (encoder, "mimi_encode", oom),
        "collect": (eng, "_collect", once(lambda: torch.OutOfMemoryError("injected"))),
        "stream": (StreamingMimiEncoder, "encode_streams",
                   once(lambda: torch.OutOfMemoryError("injected"))),
        "accelerator_error": (encoder, "mimi_encode",
                              once(lambda: torch.AcceleratorError("injected"))),
    }.items():
        orig = getattr(obj, attr)
        setattr(obj, attr, wrap(orig))
        try:
            before = eng.stats.transient_retries
            codes_equal(eng.encode_batch(batch, sr=SR), want, f"retry at {site}")
            retries[site] = eng.stats.transient_retries - before
        finally:
            if obj is eng:
                del eng._collect
            else:
                setattr(obj, attr, orig)
    check(all(n == 1 for n in retries.values()), f"retries counted per site: {retries}")
    orig = encoder.mimi_encode
    encoder.mimi_encode = once(lambda: RuntimeError("injected: nvcc failed to build rvq.cu"))(orig)
    try:
        before = eng.stats.transient_retries
        try:
            eng.encode_batch(batch, sr=SR)
            check(False, "a build failure was swallowed")
        except RuntimeError as e:
            check("nvcc" in str(e), f"not the build failure: {e!r}")
        check(eng.stats.transient_retries == before, "a build failure was retried")
    finally:
        encoder.mimi_encode = orig
    codes_equal(eng.encode_batch(batch, sr=SR), want, "after the build failure")
    out["retries"] = retries

    # the YODAS2 CLI with the modes' flags (cli.random_params memoized)
    real_params, memo = cli.random_params, {}

    def random_params_once(cfg):
        if cfg not in memo:
            memo[cfg] = real_params(cfg)
        return memo[cfg]

    parity_hub = hub_codes(mirror["hub"])
    runs, captured = {}, {}
    cli.random_params = random_params_once
    try:
        for tag, flags, precision in (
            ("fast", ["--fast", "--drain-policy", "ready", "--code-transfer-format",
                      "auto-data"], "ieee"),
            ("high", ["--precision", "high", "--pipeline-depth", "auto", "--drain-policy",
                      "auto", "--autotune-seconds", "5"], "tf32"),
        ):
            with SiteFlagSpy(torch) as spy, KernelSpy(active=False) as kernels:
                report, hub, wall, _ = run_yodas2_cli(torch, mirror["root"], tmp, tag, captured,
                                                      extra_args=flags)
                n = kernels.launches()
            e = captured.pop(tag)
            got_hub = hub_codes(hub)
            check(sorted(got_hub) == sorted(parity_hub), f"yodas2 {tag}: hub chunks differ")
            runs[tag] = {
                "report": report, "wall_seconds": wall,
                "realtime_factor": e.stats.audio_seconds / wall, "launches": n,
                "config": {"compute_dtype": e.cfg.compute_dtype,
                           "matmul_precision": e.cfg.matmul_precision,
                           "transfer": e.engine_cfg.code_transfer_format,
                           "depth": e.pipeline_depth, "drain": e.engine_cfg.drain_policy},
                "autotune": {"transfer": e.last_autotune,
                             "depth": {str(k): v for k, v in e.last_autotune_depth.items()},
                             "drain": e.last_autotune_drain},
                "sites": spy.check(f"yodas2 {tag}", precision),
                "vs_parity": match_vs([got_hub[c] for c in sorted(parity_hub)],
                                      [parity_hub[c] for c in sorted(parity_hub)]),
            }
            del e
    finally:
        cli.random_params = real_params
    check(runs["fast"]["config"]["compute_dtype"] == "bfloat16"
          and runs["fast"]["config"]["drain"] == "ready" and runs["fast"]["autotune"]["transfer"],
          f"yodas2 --fast run config {runs['fast']['config']}")
    check(runs["high"]["config"]["matmul_precision"] == "high"
          and runs["high"]["autotune"]["depth"] and runs["high"]["autotune"]["drain"],
          f"yodas2 --precision high run config {runs['high']['config']}")
    check(runs["fast"]["launches"]["resblock_elu"] == 0
          and runs["fast"]["launches"]["rvq_quantize"] > 0
          and all(v > 0 for v in runs["high"]["launches"].values()),
          f"yodas2 mode runs' launches: {[r['launches'] for r in runs.values()]}")
    check(any(t != "MainThread" for row in runs["high"]["sites"].values() for t in row["threads"]),
          "no launch in a prefetch thread during the --precision high run")
    check(hub_codes(mirror["hub"]).keys() == parity_hub.keys()
          and all(np.array_equal(hub_codes(mirror["hub"])[c], parity_hub[c]) for c in parity_hub),
          "the parity run's hub changed")
    out["yodas2"] = runs
    emit({"phase": "modes", **out})
    return {mode: launches[mode] for mode in MODES}


STREAM_LONG_SECONDS = (61.0, 75.0, 120.0, 200.0, 300.0, 340.0)  # 340 s crosses the 320 s cut
STREAM_SHORT_SECONDS = (3.0, 7.5, 12.0, 20.0)
STREAM_TIE_SECONDS = 65.0  # card vs CPU
STREAM_16K_SECONDS = (90.0, 130.0)


def frames_equal(got, want, what):
    """(equal frames, frames) of two (K, frames) code arrays."""
    check(got.shape == want.shape, f"{what}: codes {got.shape} vs {want.shape}")
    return int((got == want).all(axis=0).sum()), got.shape[1]


def phase_stream(torch):
    """The engine's long_audio_policy="stream" at full width, 32 codebooks,
    otherwise the default EngineConfig (stream_batch 8, 320 s horizon, 8 s
    chunks): long 24 kHz utterances (61-340 s) and short ones in one
    encode_batch(defer=True) + finish(); each long one against a one-shot
    encode with the "torch" backends on the card, piece by piece at the
    320 s cut (flips with their relative margins), the short ones against
    the split policy; the RVQ kernel's launches and shapes while streaming
    (the resblock kernel is not in the step), TF32 flags at every stream
    conv and step; a 65 s utterance streamed on the card against the CPU
    engine; 16 kHz utterances against a one-shot encode of the
    card-resampled audio; RTF and peak memory. Returns the RVQ launches and
    shapes of the streaming."""
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.core.audio import pcm_to_float, resample
    from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params, streaming

    t_phase = time.perf_counter()
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    rng = np.random.default_rng(SEED + 8)
    longs = [tone_pcm(rng, s) for s in STREAM_LONG_SECONDS]
    shorts = [tone_pcm(rng, s) for s in STREAM_SHORT_SECONDS]
    audios = longs[:3] + shorts[:2] + longs[3:] + shorts[2:]
    is_long = [len(a) > 60 * SR for a in audios]
    long_seconds = sum(len(a) for a in longs) / SR
    ecfg = EngineConfig(long_audio_policy="stream")
    engine = MimiEncoderEngine(params, cfg, ecfg, num_codebooks=32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    extra = [(streaming, "_cached_conv", "stream_conv"),
             (streaming, "_transformer_step", "stream_step")]
    with KernelSpy(active=False) as kernels, ThreadFlagSpy(torch, extra) as flags:
        finish = engine.encode_batch(audios, sr=SR, defer=True)  # the short ones launch here
        torch.cuda.synchronize()
        kernels.reset()
        kernels.active = True
        t0 = time.perf_counter()
        codes = finish()  # the long ones stream here
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - t0
        kernels.active = False
        launches = kernels.launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rvq_shapes = kernels.rvq_shapes
    check(launches["rvq_quantize"] > 0, f"no RVQ launch while streaming: {launches}")
    check(launches["resblock_elu"] == 0, f"the resblock kernel ran in the stream step: {launches}")
    check(sum(rvq_shapes.values()) == launches["rvq_quantize"], "stream shapes vs launches")
    check(set(engine._stream_encoders) == {8}, f"stream encoders {set(engine._stream_encoders)}")
    tf32 = flags.summary()
    check(all(row["tf32_on"] == 0 for row in tf32.values()), f"TF32 flags on while streaming: {tf32}")
    for key in ("stream_conv_main_threads", "stream_step_main_threads"):
        check(tf32.get(key, {}).get("calls", 0) > 0, f"no {key}: {tf32}")

    # the same call again, warm: the stream stage's own seconds
    engine.stats = EngineStats()
    t0 = time.perf_counter()
    again = engine.encode_batch(audios, sr=SR, defer=True)()
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    stream_stage = engine.stats.stage_seconds["stream"]
    check(all(np.array_equal(a, b) for a, b in zip(again, codes)), "a second run changed codes")

    # each long utterance against its one-shot encode, piece by piece
    enc = engine._stream_encoders[8]
    cut = enc.max_frames_25 * (SPF // 2) // enc.chunk_samples * enc.chunk_samples
    long_rows, equal, total, margins = [], 0, 0, []
    for a, c, longer in zip(audios, codes, is_long):
        if not longer:
            continue
        check(c.shape == (32, -(-len(a) // SPF)), f"streamed codes {c.shape} for {len(a)} samples")
        row = {"seconds": len(a) / SR, "pieces": 0, "frames": 0, "frames_equal": 0}
        for s0 in range(0, len(a), cut):
            ref, emb = one_shot_codes(torch, engine.params, cfg, a[s0 : s0 + cut])
            piece = c[:, s0 // SPF : s0 // SPF + ref.shape[1]]
            e, n = frames_equal(piece, ref, f"{len(a) / SR} s piece at {s0}")
            row["pieces"] += 1
            row["frames"] += n
            row["frames_equal"] += e
            m = flip_margins(torch, engine.params["rvq"], emb, piece, ref)
            margins += m if m is not None else [float("nan")]
            del emb
            torch.cuda.empty_cache()
        long_rows.append(row)
        equal, total = equal + row["frames_equal"], total + row["frames"]
    check(equal >= 0.999 * total, f"stream vs one-shot: {equal} of {total} frames")

    # the short ones against the split policy
    split = MimiEncoderEngine(params, cfg, num_codebooks=32)
    short_codes = split.encode_batch([a for a, lg in zip(audios, is_long) if not lg], sr=SR)
    s_eq = s_tot = 0
    for c, w in zip([c for c, lg in zip(codes, is_long) if not lg], short_codes):
        e, n = frames_equal(c, w, "short vs split")
        s_eq, s_tot = s_eq + e, s_tot + n
    check(s_eq >= 0.999 * s_tot, f"short utterances vs split policy: {s_eq} of {s_tot} frames")
    del split

    # 16 kHz: resampled on the card, then streamed
    rows16 = [tone_pcm(rng, s, 16_000) for s in STREAM_16K_SECONDS]
    got16 = engine.encode_batch(rows16, sr=16_000)
    eq16 = tot16 = 0
    margins16 = []
    for a, c in zip(rows16, got16):
        a24 = resample(pcm_to_float(a), 16_000, SR, device=engine.device).cpu().numpy()
        ref, emb = one_shot_codes(torch, engine.params, cfg, a24)
        e, n = frames_equal(c, ref, "16 kHz stream vs one-shot")
        eq16, tot16 = eq16 + e, tot16 + n
        m = flip_margins(torch, engine.params["rvq"], emb, c, ref)
        margins16 += m if m is not None else [float("nan")]
        del emb
    check(eq16 >= 0.999 * tot16, f"16 kHz stream vs one-shot: {eq16} of {tot16} frames")

    # one utterance streamed on the card and on the CPU (plain path)
    tie = tone_pcm(rng, STREAM_TIE_SECONDS)
    card = engine.encode_chunk(tie)
    t0 = time.perf_counter()
    cpu = MimiEncoderEngine(params, cfg, ecfg, num_codebooks=32, device="cpu").encode_chunk(tie)
    cpu_seconds = time.perf_counter() - t0
    tie_eq, tie_n = frames_equal(card, cpu, "card vs CPU stream")
    check(tie_eq >= 0.999 * tie_n, f"card vs CPU stream: {tie_eq} of {tie_n} frames")
    del engine
    torch.cuda.empty_cache()
    emit({
        "phase": "stream",
        "long_seconds": list(STREAM_LONG_SECONDS), "short_seconds": list(STREAM_SHORT_SECONDS),
        "long_audio_seconds": long_seconds,
        "first_finish_wall_seconds": first_wall,
        "warm_call_wall_seconds": warm_wall,
        "warm_stream_stage_seconds": stream_stage,
        "stream_realtime_factor": long_seconds / stream_stage,
        "peak_memory_gb": peak_gb,
        "launches_while_streaming": launches,
        "rvq_shapes": sorted([n, k, c] for (n, k), c in rvq_shapes.items()),
        "tf32_calls": tf32,
        "vs_one_shot": {"frames": total, "frames_equal": equal, "per_utterance": long_rows,
                        "flip_rel_margins": margins},
        "short_vs_split": {"frames": s_tot, "frames_equal": s_eq},
        "16k_vs_one_shot": {"seconds": list(STREAM_16K_SECONDS), "frames": tot16,
                            "frames_equal": eq16, "flip_rel_margins": margins16},
        "card_vs_cpu": {"seconds": STREAM_TIE_SECONDS, "frames": tie_n, "frames_equal": tie_eq,
                        "cpu_wall_seconds": cpu_seconds},
        "phase_seconds": time.perf_counter() - t_phase,
    })
    return launches, rvq_shapes


CODEC_UTTERANCES = ((3.0, SR), (11.5, 16_000), (20.0, SR), (7.3, 16_000))
CODEC_DECODE = dict(batch=2, seconds=10.0, books=32)
CODEC_CLI_SECONDS = 6.0


def frames_for(n: int, sr: int) -> int:
    """Code frames of n samples at sr (the engine's resample length, then
    a ceil by 1920)."""
    return -(-(-(-n * SR // sr)) // SPF)


def phase_codec(torch, tmp):
    """MimiCodec at full width (random weights, seed 0, 8 codebooks) on the
    card: audio_to_str -> str_to_audio on four utterances at 24 and 16 kHz
    (both kernels launched by the encode), the card's decode of 32-book
    codes against the CPU's, TF32 flags at every conv1d, conv_transpose1d
    and decoder transformer call, the decode RTF, and ``python -m
    tokenize_audio_tpu_torch info|encode|decode`` as subprocesses on a WAV.
    Returns the kernels' launch counts of the encodes."""
    import torch.nn.functional as F

    from tokenize_audio_tpu_torch.codec import MimiCodec
    from tokenize_audio_tpu_torch.core.audio import pcm_to_float
    from tokenize_audio_tpu_torch.io import read_wav, write_wav
    from tokenize_audio_tpu_torch.mimi import MimiConfig, decoder, params_to_torch, random_params

    t_phase = time.perf_counter()
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    codec = MimiCodec(params, cfg, num_codebooks=8)
    check(codec.device.type == "cuda", f"the codec runs on {codec.device}")
    rng = np.random.default_rng(SEED + 9)
    utts = [(tone_pcm(rng, sec, sr), sr) for sec, sr in CODEC_UTTERANCES]
    extra = [(F, "conv_transpose1d", "conv_transpose1d"),
             (decoder, "transformer_apply", "decoder_transformer_apply")]
    with KernelSpy() as kernels, ThreadFlagSpy(torch, extra) as flags:
        strs = [codec.audio_to_str(a, sr=sr) for a, sr in utts]
        torch.cuda.synchronize()
        launches = kernels.launches()
        wavs = [codec.str_to_audio(s) for s in strs]
        torch.cuda.synchronize()
    check(all(n > 0 for n in launches.values()), f"codec encode launches {launches}")
    for (a, sr), s, w in zip(utts, strs, wavs):
        f = frames_for(len(a), sr)
        check(len(s) == 8 * f, f"code string of {len(s)} chars for {f} frames")
        check(w.shape == (f * SPF,) and bool(np.isfinite(w).all()),
              f"decoded {w.shape} for {f} frames")

    # 32-book codes decoded on the card and on the CPU
    b, t = CODEC_DECODE["batch"], int(CODEC_DECODE["seconds"] * cfg.frame_rate)
    codes = rng.integers(0, cfg.codebook_size, size=(b, CODEC_DECODE["books"], t))
    with ThreadFlagSpy(torch, extra) as dflags:
        card = codec.decode(codes)
        torch.cuda.synchronize()
    tf32 = {**flags.summary(), **{f"decode_{k}": v for k, v in dflags.summary().items()}}
    check(all(row["tf32_on"] == 0 for row in tf32.values()), f"TF32 flags on in the codec: {tf32}")
    for key in ("conv1d_main_threads", "conv_transpose1d_main_threads",
                "decoder_transformer_apply_main_threads", "transformer_apply_main_threads"):
        check(tf32.get(f"decode_{key}", tf32.get(key, {})).get("calls", 0) > 0, f"no {key}: {tf32}")
    cpu_params = params_to_torch({k: params[k] for k in ("rvq", "upsample", "dec_tfm", "dec")}, "cpu")
    t0 = time.perf_counter()
    ref = decoder.decode(cpu_params, cfg, torch.from_numpy(codes)).numpy()
    cpu_seconds = time.perf_counter() - t0
    check(card.shape == ref.shape == (b, t * SPF), f"decode {card.shape} vs CPU {ref.shape}")
    scale = float(np.abs(ref).max())
    err = float(np.abs(card - ref).max())
    excess = float((np.abs(card - ref) - (3e-4 * scale + 1e-3 * np.abs(ref))).max())
    check(excess <= 0, f"decode card vs CPU: max abs err {err} beyond atol 3e-4 * {scale}, rtol 1e-3")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        codec.decode(codes)  # returns host audio: the copy waits for the device
        walls.append(time.perf_counter() - t0)
    decode_rtf = b * CODEC_DECODE["seconds"] / float(np.median(walls))

    # the command line, one process per command, on the card
    wav = Path(tmp) / "codec_in.wav"
    txt, back = Path(tmp) / "codes.txt", Path(tmp) / "back.wav"
    pcm = tone_pcm(rng, CODEC_CLI_SECONDS)
    write_wav(str(wav), pcm_to_float(pcm), SR)
    frames = frames_for(len(pcm), SR)
    cli = {}
    for cmd in (["info", str(wav)], ["encode", str(wav), "-o", str(txt)],
                ["decode", str(txt), "-o", str(back)]):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", "tokenize_audio_tpu_torch", *cmd],
                             cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
                             timeout=600)
        check(out.returncode == 0, f"{cmd[0]}: rc {out.returncode}\n{out.stderr[-2000:]}")
        cli[cmd[0]] = {"seconds": time.perf_counter() - t0, "stdout": out.stdout[-300:]}
    probe = json.loads(cli["info"]["stdout"].strip().splitlines()[-1])
    check(probe["samples"] == len(pcm) and probe["frames_at_12_5hz"] == frames, f"info {probe}")
    s = txt.read_text().strip()
    audio, sr = read_wav(str(back))
    check(len(s) == 8 * frames, f"CLI code string of {len(s)} chars for {frames} frames")
    check(sr == SR and audio.shape == (frames * SPF,), f"CLI wav {audio.shape} at {sr}")
    cli["encode"]["equals_in_process"] = s == codec.audio_to_str(read_wav(str(wav))[0])
    del codec
    torch.cuda.empty_cache()
    emit({
        "phase": "codec",
        "utterances": [{"seconds": sec, "sr": sr, "chars": len(st), "samples_back": len(w)}
                       for (sec, sr), st, w in zip(CODEC_UTTERANCES, strs, wavs)],
        "encode_launches": launches,
        "tf32_calls": tf32,
        "decode_vs_cpu": {"shape": list(card.shape), "max_abs_err": err, "max_abs_cpu": scale,
                          "cpu_wall_seconds": cpu_seconds},
        "decode_wall_seconds": walls,
        "decode_realtime_factor": decode_rtf,
        "cli": cli,
        "phase_seconds": time.perf_counter() - t_phase,
    })
    return launches


BENCH_UTTS, BENCH_PASSES = 256, 5  # run_engine_bench's defaults
BENCH_FUSED_SAMPLE = 64  # utterances of the bench workload, fused vs unfused
BENCH_TIE_SECONDS = (5.5, 6.5, 8.0)  # card vs CPU, at 16 and at 48 kHz
BENCH_MIRROR = dict(subshards=2, audios=6, seconds=90.0)  # pipeline and compare
BENCH_MP3 = dict(subshards=1, audios=2, seconds=10.0)
BENCH_SOAK = dict(minutes=0.5, subshards=1, audios=2, seconds=30.0)
BENCH_CLI = ["--pipeline", "--subshards", "1", "--audios", "2", "--seconds", "10"]
MP3_LIBRARIES = ("libmp3lame.so.0", "libmpg123.so.0")


def frame_match(got, want, what) -> float:
    """Share of equal frames (all books of a frame equal) between two lists
    of per-utterance codes of the same shapes."""
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"{what}: codes {g.shape} vs {w.shape}")
    frames = np.concatenate([(g == w).all(axis=0) for g, w in zip(got, want)])
    return int(frames.sum()) / frames.size


def check_result_line(res, smi, what) -> None:
    """A benchmark mode's result: exactly metric, value, unit and detail, a
    positive value, the card's nvidia-smi line as its device, no
    ``vs_baseline``."""
    check(set(res) == {"metric", "value", "unit", "detail"} and res["value"] > 0
          and res["detail"]["device"] == smi and "vs_baseline" not in json.dumps(res),
          f"{what} result {res}")


def hub_jsons(work_root) -> list:
    return sorted(p.name for p in (Path(work_root) / "hub_m" / "data" / "en000").glob("*.json"))


def phase_bench(torch, tmp, smi):
    """The port's benchmark module (``tokenize_audio_tpu_torch.benchmark``)
    on the card at full kyutai/mimi width (random weights, seed 0) under its
    bench config: the engine bench (256 utterances, best of 5 passes, the
    fused 16 kHz stage) with both kernels spied on in its first measured
    pass and the TF32 flags recorded throughout; a profiled pass; the fused
    16 kHz codes against resample-then-encode on the card and, at 16 and
    48 kHz, against the CPU engine; then the pipeline, compare, mp3 (where
    both libraries load), soak and CLI modes. Returns the spied pass's
    launch counts and shapes."""
    from tokenize_audio_tpu_torch import benchmark
    from tokenize_audio_tpu_torch.core.audio import resample_many
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import random_params

    t_phase = time.perf_counter()
    # --- engine mode: the engine is captured at construction, its batches
    # counted per stage; the kernels are spied on in measured pass 1 only
    stage, batches, engines, launches = ["start"], collections.Counter(), [], {}
    real_engine = benchmark.MimiEncoderEngine

    def capture(*args, **kwargs):
        engine = real_engine(*args, **kwargs)
        real_dispatch = engine._dispatch

        def dispatch(*a, **kw):
            batches[stage[0]] += 1
            return real_dispatch(*a, **kw)

        engine._dispatch = dispatch
        engines.append(engine)
        return engine

    def progress(name):
        if stage[0] == "measured_pass_1":  # the spied pass has ended
            kernels.active = False
            launches.update(kernels.launches())
        stage[0] = name
        if name == "measured_pass_1":
            kernels.reset()
            kernels.active = True

    torch.cuda.reset_peak_memory_stats()
    benchmark.MimiEncoderEngine = capture
    try:
        with KernelSpy(active=False) as kernels, ThreadFlagSpy(torch) as flags:
            t0 = time.perf_counter()
            result = benchmark.run_engine_bench(n_utts=BENCH_UTTS, passes=BENCH_PASSES,
                                                progress=progress)
            torch.cuda.synchronize()
            engine_phase_seconds = time.perf_counter() - t0
    finally:
        benchmark.MimiEncoderEngine = real_engine
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(n > 0 for n in launches.values()) and len(launches) == 2,
          f"kernel launches in the bench's measured pass 1: {launches}")
    check(sum(kernels.shapes.values()) == launches["resblock_elu"]
          and sum(kernels.rvq_shapes.values()) == launches["rvq_quantize"],
          f"bench shapes vs launches {launches}")
    tf32 = flags.summary()
    check(all(row["tf32_on"] == 0 for row in tf32.values()), f"TF32 flags on in the bench: {tf32}")
    for key in ("transformer_apply_main_threads", "resample_conv1d_main_threads"):
        check(tf32.get(key, {}).get("calls", 0) > 0, f"no {key} in the bench: {tf32}")
    check_result_line(result, smi, "engine bench")
    emit({"phase": "bench", "mode": "engine", "result": result, "batches_per_stage": dict(batches),
          "peak_memory_gb": peak_gb, "launches_measured_pass_1": launches,
          "resblock_shapes": len(kernels.shapes), "rvq_shapes": len(kernels.rvq_shapes),
          "max_rvq_rows": max(n for n, _ in kernels.rvq_shapes),
          "rvq_books": sorted({k for _, k in kernels.rvq_shapes}),
          "max_resblock_rows": max(b for b, _, _ in kernels.shapes),
          "max_resblock_elements": max(b * c * t for b, c, t in kernels.shapes),
          "tf32_calls": tf32, "phase_seconds": engine_phase_seconds})

    [engine] = engines
    audios, audios16 = benchmark.engine_workload(BENCH_UTTS, 0, engine.engine_cfg)
    profile = device_breakdown(torch, lambda: engine.encode_batch(audios))
    emit({"phase": "bench", "mode": "engine_profile", **profile})

    # --- fused 16 kHz: against resample-then-encode on the card, then the
    # card against the CPU engine at 16 and 48 kHz
    sample = audios16[:: len(audios16) // BENCH_FUSED_SAMPLE][:BENCH_FUSED_SAMPLE]
    fused = engine.encode_batch(sample, sr=16_000)
    unfused = engine.encode_batch(resample_many(sample, 16_000, SR, device=engine.device))
    for a, c in zip(sample, fused):
        valid = -(-len(a) * 3 // 2)
        check(c.shape == (engine.num_codebooks, -(-valid // SPF)),
              f"fused codes {c.shape} for {len(a)} samples")
    fused_vs_unfused = frame_match(fused, unfused, "fused vs unfused")
    check(fused_vs_unfused >= 0.999, f"fused vs unfused frame match {fused_vs_unfused}")
    cpu = MimiEncoderEngine(random_params(engine.cfg, seed=0), engine.cfg, engine.engine_cfg,
                            device="cpu")
    rng = np.random.default_rng(SEED + 7)
    card_vs_cpu = {}
    for sr in (16_000, 48_000):
        rows = [(rng.standard_normal(int(s * sr)) * 0.3 * 32767).astype(np.int16)
                for s in BENCH_TIE_SECONDS]
        card_codes = engine.encode_batch(rows, sr=sr)
        cpu_codes = cpu.encode_batch(rows, sr=sr)
        card_vs_cpu[sr] = {"frames": sum(c.shape[1] for c in cpu_codes),
                           "frame_match": frame_match(card_codes, cpu_codes, f"card vs cpu {sr}")}
        check(card_vs_cpu[sr]["frame_match"] >= 0.999, f"card vs CPU at {sr} Hz: {card_vs_cpu}")
    emit({"phase": "bench", "mode": "fused_16k", "utterances": len(sample),
          "frames": sum(c.shape[1] for c in fused), "fused_vs_unfused_frame_match": fused_vs_unfused,
          "card_vs_cpu": card_vs_cpu})
    del engine, engines[:], cpu
    torch.cuda.empty_cache()

    # --- pipeline, compare, mp3, soak and the CLI
    def run_mode(mode, fn, **kw):
        t0 = time.perf_counter()
        res = fn(**kw)
        check_result_line(res, smi, mode)
        emit({"phase": "bench", "mode": mode, "result": res,
              "phase_seconds": time.perf_counter() - t0})
        return res

    work = Path(tmp) / "pipeline"
    run_mode("pipeline", benchmark.run_pipeline_bench, work_root=str(work), **BENCH_MIRROR)
    check(hub_jsons(work) == [f"{s:08d}.json" for s in range(BENCH_MIRROR["subshards"])],
          f"pipeline hub {hub_jsons(work)}")
    run_mode("compare", benchmark.run_compare, passes=3, **BENCH_MIRROR)
    missing = []
    for lib in MP3_LIBRARIES:
        try:
            ctypes.CDLL(lib)
        except OSError:
            missing.append(lib)
    if missing:
        emit({"phase": "bench_mp3", "ran": False, "missing": missing})
    else:
        work = Path(tmp) / "mp3"
        run_mode("mp3", benchmark.run_pipeline_bench, container="mp3", work_root=str(work),
                 **BENCH_MP3)
        check(hub_jsons(work) == ["00000000.json"], f"mp3 hub {hub_jsons(work)}")
    soak = run_mode("soak", benchmark.run_soak, **BENCH_SOAK)
    check(soak["detail"]["error_count"] == 0 and soak["detail"]["iterations"] >= 1,
          f"soak {soak['detail']}")

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(BENCH_CLI)
    lines = out.getvalue().strip().splitlines()
    check(rc == 0 and len(lines) == 1, f"benchmark CLI: rc {rc}, stdout {lines}")
    cli = json.loads(lines[0])
    check_result_line(cli, smi, "benchmark CLI")
    emit({"phase": "bench", "mode": "cli", "argv": BENCH_CLI, "line": cli,
          "bench_phase_seconds": time.perf_counter() - t_phase})
    return launches, kernels.shapes, kernels.rvq_shapes


CORPUS_SEED = SEED + 10
LS_UTTERANCES, LS_DEVTEST = 40, 8  # LibriSpeech train manifest; devtest on the first 8
CV_ROWS = 48  # Common Voice, 1-10 s clips at 48 kHz
LTTS_GROUPS = (3, 2, 4)  # LibriTTS-R: speakers x chapters x utterances, 1-15 s
MLS_LAYOUT = (2, 2, 6)  # MLS: speakers x books x utterances, 10-20 s at 16 kHz
EMILIA_SPEAKERS, EMILIA_PER_SPEAKER = 4, 6  # 3-20 s, two members at 16 kHz
EMILIA_SHARD = "EN_B00000"
EMILIA_CORRUPT = f"{EMILIA_SHARD}_S00009_W000000"
AUDIO_SPAN = re.compile("<\\|audio_start\\|>(.*?)<\\|audio_end\\|>")


def run_cli(torch, module, argv):
    """One in-process run of a processor's command line, ``module.main(argv)``
    (no ``--device``: the card; default engine flags), its stdout kept off
    this script's. Returns the report, the engine it built (None for MLS
    stage 2; its stats reset once built) and its wall seconds from then."""
    from tokenize_audio_tpu_torch.engine import EngineStats

    orig, built = module.engine_from_args, []

    def capture(*args, **kwargs):
        engine = orig(*args, **kwargs)
        torch.cuda.synchronize()
        engine.stats = EngineStats(started_at=time.perf_counter())
        built.append(engine)
        return engine

    module.engine_from_args = capture
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            report = module.main(argv)
        torch.cuda.synchronize()
    finally:
        module.engine_from_args = orig
    engine = built[0] if built else None
    return report, engine, engine.stats.wall_seconds if engine else 0.0


class HostStages:
    """Seconds spent in each of ``targets`` ((module, attribute, stage)
    triples), summed over every thread while installed."""

    def __init__(self, targets):
        self.targets, self.seconds, self.lock = targets, collections.Counter(), threading.Lock()

    def __enter__(self):
        self.orig = [getattr(mod, attr) for mod, attr, _ in self.targets]
        for (mod, attr, stage), fn in zip(self.targets, self.orig):
            def timed(*args, _fn=fn, _stage=stage, **kwargs):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kwargs)
                finally:
                    with self.lock:
                        self.seconds[_stage] += time.perf_counter() - t0
            setattr(mod, attr, timed)
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.targets, self.orig):
            setattr(mod, attr, fn)

    def take(self):
        with self.lock:
            out, self.seconds = dict(self.seconds), collections.Counter()
        return out


def corpus_inputs(tmp, rng):
    """Write each corpus's input under ``tmp`` (a LibriSpeech manifest of
    16 kHz FLAC files; Common Voice, LibriTTS-R and MLS parquet shards on
    local source hubs; an Emilia tar) and return, per corpus, its command
    lines and the audio of each utterance as its processor decodes it."""
    import torch_corpora as tc

    from tokenize_audio_tpu_torch.datasets import mls
    from tokenize_audio_tpu_torch.datasets.parquet_corpus import _decode_embedded_audio
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
    from tokenize_audio_tpu_torch.hub import LocalHub
    from tokenize_audio_tpu_torch.io import decode_audio

    tmp = Path(tmp)
    out = {}

    # LibriSpeech: lognormal 2-30 s (median 10 s), 16 kHz mono FLAC
    durs = np.clip(rng.lognormal(math.log(10.0), 0.6, LS_UTTERANCES), 2.0, 30.0)
    utts = [(f"{19 + i % 3}-{198 + i // 10}-{i:04d}", tc.tone_pcm(rng, d, 16_000), 16_000, "flac",
             f"utterance {i} of the manifest") for i, d in enumerate(durs)]
    manifest = tc.write_librispeech(str(tmp / "ls" / "audio"), utts)
    dev = tmp / "ls" / "devtest.json"
    dev.write_text(json.dumps(json.loads(Path(manifest).read_text())[:LS_DEVTEST]))
    ls = tmp / "ls"
    out["librispeech"] = {
        "runs": [("librispeech", ["--manifest", manifest, "--split", "train-clean-100",
                                  "--hub", f"dir:{ls / 'hub'}", "--progress-dir", str(ls / "prog"),
                                  "--work-dir", str(ls / "work"), "--chunk-rows", "40"]),
                 ("librispeech", ["--manifest", str(dev), "--split", "dev-clean",
                                  "--layout", "devtest", "--hub", f"dir:{ls / 'hub'}",
                                  "--progress-dir", str(ls / "prog_dt"),
                                  "--work-dir", str(ls / "work_dt")])],
        "audio": {e["id"]: decode_audio(e["audio"], raw_int16=True)
                  for e in json.loads(Path(manifest).read_text())},
        "hub": ls / "hub",
    }

    def parquet_source(name, path, rows):
        src = tmp / name / "src"
        local = write_parquet(rows, str(tmp / name / "in.parquet"))
        LocalHub(str(src)).upload_file(local, path)
        # the cells as the processor reads them back
        return src, {r["id"]: _decode_embedded_audio(r["audio"]) for r in read_parquet(local)}

    # Common Voice: {'bytes': 48 kHz WAV, 'path'} cells
    rows = [{"id": f"common_voice_en_{4000 + i}", "sentence": f"Sentence number {i}.",
             "client_id": f"client{i % 7}",
             "audio": {"bytes": tc.wav_bytes(tc.tone_pcm(rng, rng.uniform(1, 10), 48_000), 48_000),
                       "path": f"common_voice_en_{4000 + i}.mp3"}} for i in range(CV_ROWS)]
    src, audio = parquet_source("cv", "en/train-00000.parquet", rows)
    out["common_voice"] = {
        "runs": [("parquet_corpus", ["--corpus", "common_voice", "--split", "en",
                                     "--shard-id", "train-00000", "--source-hub", f"dir:{src}",
                                     "--target-hub", f"dir:{tmp / 'cv' / 'dst'}",
                                     "--progress-dir", str(tmp / "cv" / "prog"),
                                     "--work-dir", str(tmp / "cv" / "work")])],
        "audio": audio, "hub": tmp / "cv" / "dst",
    }

    # LibriTTS-R tts0: {'array': float32, 'sampling_rate': 24000} cells
    spk, chap, per = LTTS_GROUPS
    rows = [{"id": f"{84 + s}_{121 + c}_{i:06d}", "text_normalized": f"Line {i} of {s}/{c}.",
             "speaker_id": 84 + s, "chapter_id": 121 + c,
             "audio": tc.audio_cell(tc.tone_pcm(rng, rng.uniform(1, 15), SR), SR, "array")}
            for s in range(spk) for c in range(chap) for i in range(per)]
    src, audio = parquet_source("ltts", "data/train-00000.parquet", rows)
    out["libritts_r"] = {
        "runs": [("parquet_corpus", ["--corpus", "libritts_r", "--variant", "tts0",
                                     "--shard-id", "train-00000", "--source-hub", f"dir:{src}",
                                     "--target-hub", f"dir:{tmp / 'ltts' / 'dst'}",
                                     "--progress-dir", str(tmp / "ltts" / "prog"),
                                     "--work-dir", str(tmp / "ltts" / "work")])],
        "audio": audio, "hub": tmp / "ltts" / "dst",
    }

    # MLS: 16 kHz, half {'bytes': FLAC} and half {'array'} cells, consecutive
    # times with a 1 s gap after every third utterance
    s, b, per = MLS_LAYOUT
    rows = tc.mls_rows(rng, [f"{1000 + i}" for i in range(s)], [f"{200 + i}" for i in range(b)],
                       per_book=per, seconds=(10.0, 20.0), gap_every=3)
    pq = write_parquet(rows, str(tmp / "mls" / "in.parquet"))
    audio = {mls.make_entry_id(r["speaker_id"], r["book_id"], r["begin_time"], r["end_time"],
                               r["transcript"]): _decode_embedded_audio(r["audio"])
             for r in read_parquet(pq)}
    m = tmp / "mls"
    out["mls"] = {
        "runs": [("mls", ["stage1", "--shard-id", "0000", "--parquet", pq, "--output-dir",
                          str(m / "stage1"), "--progress-dir", str(m / "prog")]),
                 ("mls", ["stage2", "--stage1-dir", str(m / "stage1"), "--batch-name",
                          "batch_000", "--pairs", str(m / "pairs.txt"), "--hub",
                          f"dir:{m / 'hub'}", "--work-dir", str(m / "work2")])],
        "audio": audio, "hub": m / "hub", "stage1": m / "stage1", "pairs": m / "pairs.txt",
    }

    # Emilia: 24 kHz WAV members but two at 16 kHz (resampled in the
    # processor's worker threads), SPEAKER_xx labels, one corrupt member
    members, audio = [], {}
    for sp in range(EMILIA_SPEAKERS):
        for w in range(EMILIA_PER_SPEAKER):
            uid = f"{EMILIA_SHARD}_S{sp:05d}_W{w:06d}"
            sr = 16_000 if (sp, w) in ((0, 1), (2, 4)) else SR
            pcm = tc.tone_pcm(rng, rng.uniform(3, 20), sr)
            payload = tc.wav_bytes(pcm, sr)
            members.append((f"{uid}.wav", payload,
                            {"id": uid, "text": f"turn {w} of {sp}", "language": "en",
                             "speaker": f"SPEAKER_{(sp + w) % 3:02d}",
                             "duration": len(pcm) / sr}))
            audio[uid] = decode_audio(payload, raw_int16=True)
    members.append((f"{EMILIA_CORRUPT}.wav", tc.CORRUPT, {"text": "x", "speaker": "SPEAKER_00"}))
    e = tmp / "emilia"
    e.mkdir(parents=True)
    tar = tc.write_emilia_tar(str(e / f"{EMILIA_SHARD}.tar"), EMILIA_SHARD, members)
    LocalHub(str(e / "src")).upload_file(tar, f"Emilia/EN/{EMILIA_SHARD}.tar")
    base = ["--lang", "EN", "--shard-id", EMILIA_SHARD, "--source-hub", f"dir:{e / 'src'}"]
    out["emilia"] = {
        "runs": [("emilia", [*base, "--target-hub", f"dir:{e / 'dst'}", "--work-dir",
                             str(e / "work")]),
                 ("emilia", [*base, "--conversational", "--target-hub", f"dir:{e / 'dst_conv'}",
                             "--work-dir", str(e / "work_conv")])],
        "audio": audio, "hub": e,
    }
    return out


def corpus_strings(name, spec):
    """Utterance id -> every ``audio_str`` the corpus's outputs hold for it
    (each document's audio spans, mapped back to its utterances), and the
    output row count."""
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    found = collections.defaultdict(list)
    rows = [(p, r) for p in sorted(Path(spec["hub"]).rglob("*.parquet")) for r in read_parquet(str(p))]
    for path, r in rows:
        spans = AUDIO_SPAN.findall(r["text"])
        if name in ("librispeech", "common_voice"):
            uids = [r["id"].rsplit("_type", 1)[0]]
        elif name == "libritts_r":
            uids = r["id"].split("#")
        elif name == "mls":
            uids = None  # stage-2 documents: held against the stage-1 JSONs below
        else:  # emilia: a speaker's utterances in uid order
            doc = r["id"].rsplit("_type", 1)[0]
            uids = sorted(u for u in spec["audio"] if u.startswith(doc + "_")
                          and u != EMILIA_CORRUPT)
        if uids is None:
            found["_stage2_spans"] += spans
            continue
        check(len(uids) == len(spans), f"{name} {path.name} {r['id']}: {len(spans)} audio spans "
                                       f"for {len(uids)} utterances")
        for u, s in zip(uids, spans):
            found[u].append(s)
    if name == "mls":
        stage2 = found.pop("_stage2_spans")
        for p in sorted(Path(spec["stage1"]).rglob("*.json")):
            e = json.loads(p.read_text())
            found[e["entry_id"]].append(e["audio_str"])
        check(sorted(stage2) == sorted(s.strip() for ss in found.values() for s in ss
                                       for _ in range(2)),
              "mls stage-2 documents do not hold each stage-1 audio_str once per type")
    return dict(found), len(rows)


def direct_codes(torch, engine, audio, sr):
    """``engine.encode_batch_mixed`` of one utterance on the card: its
    (8, frames) codes and the RVQ input of that call (for flip margins)."""
    from tokenize_audio_tpu_torch.mimi import model

    seen, orig = {}, model.split_rvq_encode

    def spy(p, emb, *args, **kwargs):
        seen["emb"] = emb
        return orig(p, emb, *args, **kwargs)

    model.split_rvq_encode = spy
    try:
        [codes] = engine.encode_batch_mixed([(audio, sr)])
    finally:
        model.split_rvq_encode = orig
    return codes, seen["emb"]


def phase_corpora(torch, tmp):
    """The four corpus processors' command lines, in process on the card at
    full kyutai/mimi width (random weights, seed 0; each ``main`` builds its
    engine from the default flags; ``cli.random_params`` is memoized so the
    reruns do not draw the same weights again): LibriSpeech (train and
    devtest layouts), Common Voice at 48 kHz, LibriTTS-R tts0, MLS stage 1
    and 2, Emilia standard and conversational. Per corpus: complete
    reports, every utterance's rows, a rerun that launches no kernel, both
    kernels launched, every ``audio_str`` against a direct
    ``encode_batch_mixed`` of the same decoded audio (>= 0.999 of frames,
    each flip a near-tie), host stage seconds and RTF; TF32 off at every
    conv1d, resample conv and transformer call in every thread; one
    LibriSpeech utterance and one Common Voice clip against the CPU engine.
    Returns the kernels' launches summed over the corpora and the shapes of
    all."""
    from tokenize_audio_tpu_torch import cli
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.core.codes import chars_to_codes
    from tokenize_audio_tpu_torch.datasets import emilia, librispeech, mls, parquet_corpus
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig

    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    t_phase = time.perf_counter()
    modules = {"librispeech": librispeech, "parquet_corpus": parquet_corpus, "mls": mls,
               "emilia": emilia}
    corpora = corpus_inputs(tmp, np.random.default_rng(CORPUS_SEED))
    input_seconds = time.perf_counter() - t_phase
    real_params, memo = cli.random_params, {}

    def random_params_once(cfg):
        if cfg not in memo:
            memo[cfg] = real_params(cfg)
        return memo[cfg]

    host = [(librispeech, "decode_audio", "host_decode"), (emilia, "decode_audio", "host_decode"),
            (parquet_corpus, "_decode_embedded_audio", "host_decode"),
            (mls, "_decode_embedded_audio", "host_decode")] + [
        (m, "write_parquet", "parquet_write") for m in modules.values()]
    rows_out, launches, timing, codes_check, reruns = {}, {}, {}, {}, {}
    cli.random_params = random_params_once
    try:
        with KernelSpy(active=False) as kernels, ThreadFlagSpy(torch) as flags, \
                HostStages(host) as stages:
            for name, spec in corpora.items():
                # --- the checked runs: counts from 0, read just after
                stages.take()
                kernels.reset()
                kernels.active = True
                reports, engines, wall = [], [], 0.0
                for mod, argv in spec["runs"]:
                    if mod == "mls" and argv[0] == "stage2":
                        batches = mls.create_batch_lists(str(spec["stage1"]))
                        check(len(batches) == 1, f"mls batch lists {batches}")
                        spec["pairs"].write_text("".join(f"{s} {b}\n" for s, b in batches[0]))
                    report, engine, w = run_cli(torch, modules[mod], argv)
                    reports.append(report)
                    wall += w
                    if engine is not None:
                        engines.append(engine)
                kernels.active = False
                launches[name] = kernels.launches()
                check(all(n > 0 for n in launches[name].values()),
                      f"{name}: kernel launches {launches[name]}")
                host_stages = stages.take()
                audio_s = sum(e.stats.audio_seconds for e in engines)
                eng_stages = collections.Counter()
                for e in engines:
                    eng_stages.update(e.stats.stage_seconds)
                timing[name] = {"audio_seconds": audio_s, "wall_seconds": wall,
                                "realtime_factor": audio_s / wall,
                                "utterances": sum(e.stats.utterances for e in engines),
                                "frames": sum(e.stats.frames for e in engines),
                                "stage_seconds": {**host_stages, **dict(eng_stages)}}
                check_reports(name, reports, spec)

                # every utterance's rows, against a direct encode on the card
                found, rows_out[name] = corpus_strings(name, spec)
                want_ids = set(spec["audio"]) - {EMILIA_CORRUPT}
                check(set(found) == want_ids, f"{name}: outputs for {len(found)} of "
                                              f"{len(want_ids)} utterances")
                engine = engines[0]
                frames = equal = 0
                margins = []
                for uid in sorted(found):
                    audio, sr = spec["audio"][uid]
                    if name == "emilia":
                        audio, sr = engine.prepare_audio(audio, sr), SR
                    want, emb = direct_codes(torch, engine, audio, sr)
                    for s in found[uid]:
                        got = np.asarray(chars_to_codes(s, 8, 2048, return_tensors="np",
                                                        unicode_offset=0xE000))
                        check(got.shape == want.shape, f"{name} {uid}: {got.shape} vs {want.shape}")
                        same = (got == want).all(axis=0)
                        frames, equal = frames + same.size, equal + int(same.sum())
                        if not same.all():
                            m = flip_margins(torch, engine.params["rvq"], emb, got, want)
                            margins += [abs(x) for x in m] if m is not None else [float("nan")]
                    del emb
                check(equal >= 0.999 * frames, f"{name}: {equal} of {frames} frames equal a "
                                               "direct encode_batch_mixed")
                check(all(x < 1e-6 for x in margins), f"{name}: flips not near-ties: {margins}")
                codes_check[name] = {"frames": frames, "frames_equal": equal,
                                     "flip_rel_margins": margins}

                # --- a rerun of each command line: skipped, no kernel launched
                kernels.reset()
                again = [run_cli(torch, modules[mod], argv)[0] for mod, argv in spec["runs"]]
                reruns[name] = {"reports": again, "launches": kernels.launches()}
                check(not any(reruns[name]["launches"].values()),
                      f"{name}: the rerun launched kernels: {reruns[name]['launches']}")
                check_rerun(name, again)
                del engines, engine
        tf32 = flags.summary()
    finally:
        cli.random_params = real_params
    check(sum(kernels.shapes.values()) == sum(n["resblock_elu"] for n in launches.values())
          and sum(kernels.rvq_shapes.values()) == sum(n["rvq_quantize"] for n in launches.values()),
          f"corpora shapes vs launches {launches}")
    check(all(row["tf32_on"] == 0 for row in tf32.values()), f"TF32 flags on in the corpora: {tf32}")
    for key in ("transformer_apply_main_threads", "resample_conv1d_main_threads",
                "resample_conv1d_other_threads"):
        check(tf32.get(key, {}).get("calls", 0) > 0, f"no {key} in the corpora: {tf32}")

    # one LibriSpeech utterance and one Common Voice clip on the CPU engine
    [params] = memo.values()
    cpu = MimiEncoderEngine(params, MimiConfig(), EngineConfig(), device="cpu")
    card_vs_cpu = {}
    for name in ("librispeech", "common_voice"):
        spec = corpora[name]
        uid = min(spec["audio"], key=lambda u: len(spec["audio"][u][0]))
        found, _ = corpus_strings(name, spec)
        [want] = cpu.encode_batch_mixed([spec["audio"][uid]])
        got = np.asarray(chars_to_codes(found[uid][0], 8, 2048, return_tensors="np",
                                        unicode_offset=0xE000))
        e, n = frames_equal(got, want, f"{name} card vs CPU")
        check(e >= 0.999 * n, f"{name} {uid}: card vs CPU {e} of {n} frames")
        audio, sr = spec["audio"][uid]
        card_vs_cpu[name] = {"utterance": uid, "seconds": len(audio) / sr, "frames": n,
                             "frames_equal": e}
    del cpu
    for name in corpora:
        emit({"phase": "corpora", "corpus": name, "rows": rows_out[name],
              "launches": launches[name], **timing[name], "vs_direct": codes_check[name],
              "rerun": reruns[name]})
    emit({"phase": "corpora_summary", "tf32_calls": tf32, "card_vs_cpu": card_vs_cpu,
          "input_build_seconds": input_seconds,
          "resblock_shapes": len(kernels.shapes), "rvq_shapes": len(kernels.rvq_shapes),
          "phase_seconds": time.perf_counter() - t_phase})
    total = {k: sum(n[k] for n in launches.values()) for k in ("rvq_quantize", "resblock_elu")}
    return total, kernels.shapes, kernels.rvq_shapes


def check_reports(name, reports, spec):
    """Each checked run's report says it processed everything, failing
    nothing but the corrupt Emilia member put there on purpose."""
    n = len(spec["audio"])
    if name == "librispeech":
        train, dev = (r["report"] for r in reports)
        ok = (train["processed"], train["failed"], dev["processed"], dev["failed"]) == (2, 0, 1, 0)
        ok = ok and [r["engine"]["utterances"] for r in reports] == [n, LS_DEVTEST]
    elif name == "common_voice":
        ok = reports == [[{"shard": "train-00000", "status": "processed", "rows": 2 * n}]]
    elif name == "libritts_r":
        spk, chap, per = LTTS_GROUPS
        ok = reports == [[{"shard": "train-00000", "status": "processed",
                           "rows": spk * chap * (per - 1)}]]
    elif name == "mls":
        s1, s2 = reports
        ok = (s1["processed_count"], s1["last_processed_index"]) == (n, n - 1)
        s, b, per = MLS_LAYOUT
        # a 1 s gap after every third utterance: two segments per book
        ok = ok and s2 == {"batch": "batch_000", "status": "processed", "entries": n,
                           "docs": s * b * 2 * 2}
    else:
        std, conv = reports
        ok = all(r["status"] == "processed" and r["failed_files"] == [EMILIA_CORRUPT]
                 for r in reports)
        ok = ok and (std["rows"], conv["rows"]) == (2 * EMILIA_SPEAKERS, EMILIA_SPEAKERS)
    check(ok, f"{name} reports {reports}")


def check_rerun(name, reports):
    """Each rerun skipped its work (MLS stage 1: its progress ledger says
    every entry is done)."""
    if name == "librispeech":
        ok = [(r["report"]["processed"], r["report"]["skipped"]) for r in reports] == [(0, 2), (0, 1)]
    elif name in ("common_voice", "libritts_r"):
        ok = reports == [[{"shard": "train-00000", "status": "skipped"}]]
    elif name == "mls":
        s, b, per = MLS_LAYOUT
        ok = reports[0]["processed_count"] == s * b * per and reports[1]["status"] == "skipped"
    else:
        ok = all(r == {"shard": EMILIA_SHARD, "status": "skipped"} for r in reports)
    check(ok, f"{name} rerun reports {reports}")


QUALIFY_WEIGHT_SEEDS = (0, 1, 2)  # each through the kit's default sweep (audio seeds 0, 1, 2)
QUALIFY_BOOKS = 32
QUALIFY_MIN_FRAMES = 10_000


class QualifyRecorder:
    """Replaces the kit's engine class and HF reference by spies that
    record, per engine dtype ("float32": the parity sweep, "bfloat16": the
    informational check), the codes of each ``encode_batch`` and both
    kernels' launches in it, and each HF reference (audio, codes) in order."""

    def __init__(self, kernels):
        from tokenize_audio_tpu_torch import qualify

        self.qualify, self.kernels = qualify, kernels
        self.runs, self.hf = {}, []

    def __enter__(self):
        q, rec = self.qualify, self
        self.orig = q.MimiEncoderEngine, q._hf_codes

        class Recording(self.orig[0]):
            def encode_batch(self, audios, *args, **kwargs):
                before = rec.kernels.launches()
                out = super().encode_batch(audios, *args, **kwargs)
                after = rec.kernels.launches()
                run = rec.runs.setdefault(self.cfg.compute_dtype,
                                          {"launches": collections.Counter(), "codes": []})
                run["launches"].update({k: after[k] - before[k] for k in after})
                run["codes"].append(out)
                return out

        def hf_spy(model, audio, k):
            codes = rec.orig[1](model, audio, k)
            rec.hf.append((audio, codes))
            return codes

        q.MimiEncoderEngine, q._hf_codes = Recording, hf_spy
        return self

    def __exit__(self, *exc):
        self.qualify.MimiEncoderEngine, self.qualify._hf_codes = self.orig


def code_frames(got, want):
    """[equal frames, frames] of two lists of (K, frames) codes."""
    same = []
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"codes {g.shape} vs {w.shape}")
        same.append((g == w).all(axis=0))
    same = np.concatenate(same)
    return [int(same.sum()), int(same.size)]


def phase_qualify(torch, tmp):
    """The port's qualification kit at the published kyutai/mimi width
    (``transformers.MimiConfig()``), 32 codebooks, kernel backends, on the
    card, with the HF oracle on the CPU, for three weight seeds through the
    kit's default sweep: seed 0 saved with ``save_pretrained`` and run
    through the kit's command line with ``--hf-dir`` (the file-vs-module
    conversion check), seeds 1 and 2 through ``run_qualification``. Every
    report must pass (no non-tie flip; per-layer deviations under the
    kit's atols through the resblock kernel), over >= 10k frames, with both
    TF32 flags False at every conv1d, linear and matmul. Seed 0's sweep is
    also encoded by the port's CPU engine: card vs port-CPU and port-CPU vs
    HF frame matches under this machine's transformers, whose encode window
    mode and the sweep's flips past the window are reported. Returns the
    kernels' launches by engine, their shapes, and seed 0's checkpoint
    file."""
    import transformers

    from tokenize_audio_tpu_torch import qualify
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi.weights import config_from_hf, params_from_safetensors

    t0 = time.perf_counter()
    hf_dir = Path(tmp) / "oracle_seed0"
    qualify._random_oracle(QUALIFY_WEIGHT_SEEDS[0]).save_pretrained(str(hf_dir))
    reports, seed0 = [], None
    with SiteFlagSpy(torch) as flags, KernelSpy() as kernels, QualifyRecorder(kernels) as rec:
        for seed in QUALIFY_WEIGHT_SEEDS:
            if seed == QUALIFY_WEIGHT_SEEDS[0]:
                out = Path(tmp) / "qualify_seed0.json"
                with contextlib.redirect_stdout(io.StringIO()), \
                        contextlib.redirect_stderr(io.StringIO()):
                    rc = qualify.main(["--hf-dir", str(hf_dir), "--num-codebooks",
                                       str(QUALIFY_BOOKS), "--out", str(out),
                                       "--out-md", str(Path(tmp) / "qualify_seed0.md")])
                report = json.loads(out.read_text())
                check(rc == (0 if report["passed"] else 1), f"kit CLI exit {rc}")
                seed0 = {"hf": list(rec.hf), "card": [c for run in rec.runs["float32"]["codes"][:3]
                                                      for c in run]}
            else:
                report = qualify.run_qualification(oracle_seed=seed, num_codebooks=QUALIFY_BOOKS)
            report["weight_seed"] = seed
            reports.append(report)
            rec.hf.clear()
            emit({"phase": "qualify_report", **{k: v for k, v in report.items() if k != "checks"},
                  "checks": {name: {k: v for k, v in c.items() if k != "flips"}
                             for name, c in report["checks"].items()}})
        torch.cuda.synchronize()
        launches = kernels.launches()
    shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    kit_seconds = time.perf_counter() - t0
    check(sum(shapes.values()) == launches["resblock_elu"]
          and sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"qualify shapes vs launches {launches}")
    # the parity sweep's engine, the bf16 check's, and the per-layer check
    by_engine = {name: dict(rec.runs[dt]["launches"])
                 for name, dt in (("parity", "float32"), ("bf16", "bfloat16"))}
    by_engine["per_layer"] = {k: n - sum(r[k] for r in by_engine.values())
                              for k, n in launches.items()}
    check(all(by_engine["parity"][k] > 0 for k in launches),
          f"the parity sweep launched both kernels: {by_engine}")
    check(by_engine["bf16"]["resblock_elu"] == 0 and by_engine["bf16"]["rvq_quantize"] > 0,
          f"bf16 launches the RVQ kernel and not the (f32-only) resblock: {by_engine}")
    check(by_engine["per_layer"]["resblock_elu"] == 4 * len(QUALIFY_WEIGHT_SEEDS)
          and by_engine["per_layer"]["rvq_quantize"] == 0,
          f"the per-layer check runs the resblock kernel once per stage: {by_engine}")
    tf32_on = [c for c in flags.calls if c[3] or c[4]]
    check(not tf32_on, f"TF32 flags on inside the kit: {tf32_on[:5]}")
    sites = collections.Counter(site or "hf_oracle_cpu" for _, site, *_ in flags.calls)
    check(sites["seanet_encode"] > 0 and sites["transformer_apply"] > 0 and sites["_encode"] > 0,
          f"the kit's launch sites: {dict(sites)}")

    table, flips = [], []
    for rep in reports:
        c = rep["checks"]
        check(rep["passed"], f"weight seed {rep['weight_seed']}: kit failed: "
              + json.dumps({k: v for k, v in c.items() if k != "exact_codes"}))
        check(c["per_layer"]["seanet_max_abs_dev"] < qualify.SEANET_ATOL
              and c["per_layer"]["transformer_max_abs_dev"] < qualify.TFM_ATOL,
              f"weight seed {rep['weight_seed']}: per-layer {c['per_layer']}")
        e = c["exact_codes"]
        flips += e["flips"]
        table.append({"weight_seed": rep["weight_seed"], "frames": e["frames"],
                      "audio_seconds": e["audio_seconds"], "flipped_frames": e["flipped_frames"],
                      "non_tie_flips": e["non_tie_flips"], "per_audio_seed": e["per_seed"],
                      "seanet_max_abs_dev": c["per_layer"]["seanet_max_abs_dev"],
                      "transformer_max_abs_dev": c["per_layer"]["transformer_max_abs_dev"],
                      "bf16_code_match_vs_f32": c["bf16_fast_mode"]["code_match_vs_f32"]})
    check(reports[0]["checks"]["file_conversion_matches_module"]["max_abs_dev"] == 0.0,
          f"--hf-dir file conversion: {reports[0]['checks']['file_conversion_matches_module']}")
    frames = sum(r["frames"] for r in table)
    flipped = sum(r["flipped_frames"] for r in table)
    check(frames >= QUALIFY_MIN_FRAMES, f"census of {frames} frames < {QUALIFY_MIN_FRAMES}")

    # seed 0's sweep through the port's CPU engine
    t1 = time.perf_counter()
    hf_cfg = transformers.MimiConfig.from_pretrained(str(hf_dir))
    cfg = config_from_hf(hf_cfg)
    params = params_from_safetensors(str(hf_dir / "model.safetensors"), cfg)
    ecfg = EngineConfig(min_bucket_seconds=1.0, bucket_growth=1.7,
                        samples_per_batch=96 * 24_000)  # the kit's default
    audios = [a for a, _ in seed0["hf"]]
    refs = [r for _, r in seed0["hf"]]
    cpu = MimiEncoderEngine(params, cfg, ecfg, num_codebooks=QUALIFY_BOOKS,
                            device="cpu").encode_batch(audios)
    cpu_seconds = time.perf_counter() - t1
    card_vs_cpu = code_frames(seed0["card"], cpu)
    cpu_vs_hf = code_frames(cpu, refs)
    card_vs_hf = code_frames(seed0["card"], refs)
    bf16 = [r["bf16_code_match_vs_f32"] for r in table]
    summary = {
        "phase": "qualify",
        "transformers": transformers.__version__,
        "width": "transformers.MimiConfig() (kyutai/mimi): 8 layers, 512 wide, 2048-entry books",
        "codebooks": QUALIFY_BOOKS,
        "weight_seeds": list(QUALIFY_WEIGHT_SEEDS),
        "frames": frames,
        "audio_seconds": sum(r["audio_seconds"] for r in table),
        "flipped_frames": flipped,
        "flips_per_10k_frames": 1e4 * flipped / frames,
        "non_tie_flips": sum(r["non_tie_flips"] for r in table),
        "max_flip_rel_margin": max((f["rel_margin"] for f in flips), default=None),
        "flips": flips,
        "per_seed": table,
        "bf16_code_match_vs_f32": {"per_seed": bf16, "mean": float(np.mean(bf16))},
        "seed0_card_vs_port_cpu_frames": card_vs_cpu,
        "seed0_port_cpu_vs_hf_frames": cpu_vs_hf,
        "seed0_card_vs_hf_frames": card_vs_hf,
        # transformers 5.x's encode is windowed, the port's config is not:
        # frames from window_frame on may differ, and are held to the gate
        "hf_encode_sliding_window": reports[0]["hf_sliding_window"],
        "window_frame": reports[0]["checks"]["exact_codes"]["window_frame"],
        "frames_past_window": sum(r["checks"]["exact_codes"]["frames_past_window"]
                                  for r in reports),
        "flips_past_window": sum(r["checks"]["exact_codes"]["flips_past_window"]
                                 for r in reports),
        "launches": by_engine,
        "tf32_calls_by_site": dict(sites),
        "kit_seconds": kit_seconds,
        "cpu_engine_seconds": cpu_seconds,
        "seconds": time.perf_counter() - t0,
    }
    emit(summary)
    check(card_vs_cpu[0] >= 0.999 * card_vs_cpu[1], f"card vs port CPU frames {card_vs_cpu}")
    check(cpu_vs_hf[0] >= 0.999 * cpu_vs_hf[1], f"port CPU vs HF frames {cpu_vs_hf}")
    return by_engine, shapes, rvq_shapes, hf_dir / "model.safetensors"


FLEET_SHARDS = ("en000", "en001")
FLEET_SUBSHARDS, FLEET_ENTRIES = 2, 3  # 24 kHz WAV entries of 10-20 s per sub-shard
FLEET_WALLTIME = 300.0
ROOT = Path(__file__).resolve().parent


def run_module(argv, timeout=600):
    """``python -m <argv>`` from the checkout's root: (exit code, stdout)."""
    out = subprocess.run([sys.executable, "-m", *argv], cwd=ROOT, capture_output=True,
                         text=True, timeout=timeout)
    return out.returncode, out.stdout + out.stderr


def phase_fleet(torch, tmp, params_path):
    """The shard fleet on the card: a two-shard YODAS2 mirror (en000 and
    en001, two sub-shards of three 24 kHz entries each) tokenized by ``python
    -m tokenize_audio_tpu_torch.runner.pod_runner run --max-concurrent 2
    --wait`` over the port's YODAS2 command line (``{shard}``, the qualify
    phase's checkpoint as ``--params``, a walltime): both shards complete
    with the single-GPU warning, their hub codes equal to a direct
    encode_batch on >= 0.999 of frames; a rerun launches no child; the
    monitor's status (with the manifests' unit counts as expected) and
    verify agree; the manifests list exactly the two shards; and
    ``chip_check`` passes on GPU 0 and sees no device at an index with no
    GPU behind it."""
    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    from torch_yodas2_mirror import Entry, write_mirror
    from tokenize_audio_tpu_torch.datasets.yodas2 import slice_chunks
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig
    from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors
    from tokenize_audio_tpu_torch.runner import manifests, monitor, pod_runner

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 30)
    root, hub = Path(tmp) / "fleet_mirror", Path(tmp) / "fleet_hub"
    prog, work = Path(tmp) / "fleet_progress", Path(tmp) / "fleet_work"
    entries = {}
    for shard in FLEET_SHARDS:
        subshards = []
        for s in range(FLEET_SUBSHARDS):
            subshards.append([])
            for a in range(FLEET_ENTRIES):
                seconds = float(rng.uniform(10, 20))
                subshards[-1].append(Entry(f"{shard}-{s}-{a}", tone_pcm(rng, seconds), SR, "wav",
                                           lognormal_chunks(rng, seconds)))
        write_mirror(str(root), shard, subshards)
        entries[shard] = [e for sub in subshards for e in sub]
    shard_list = Path(tmp) / "fleet_shards.txt"
    shard_list.write_text("\n".join(FLEET_SHARDS) + "\n")

    def pod_run(tag):
        return run_module([
            "tokenize_audio_tpu_torch.runner.pod_runner", "run",
            "--shard-list", str(shard_list), "--max-concurrent", "2", "--poll-seconds", "0.5",
            "--run-dir", str(Path(tmp) / tag / "run"), "--log-dir", str(Path(tmp) / tag / "logs"),
            "--progress-dir", str(prog), "--walltime", str(FLEET_WALLTIME), "--wait", "--",
            sys.executable, "-m", "tokenize_audio_tpu_torch.datasets.yodas2",
            "--shard-id", "{shard}", "--source", f"dir:{root}", "--hub", f"dir:{hub}",
            "--progress-dir", str(prog), "--work-dir", str(work / "{shard}"),
            "--params", str(params_path),
        ], timeout=FLEET_WALLTIME + 120)

    t1 = time.perf_counter()
    rc, out = pod_run("first")
    run_seconds = time.perf_counter() - t1
    check(rc == 0, f"pod runner exit {rc}:\n{out[-3000:]}")
    check("contend for the same chip" in out, f"no single-GPU warning:\n{out[-3000:]}")
    check("launched=2 skipped=0" in out, f"pod runner launches:\n{out[-3000:]}")
    reports = {}
    for shard in FLEET_SHARDS:
        check(f"shard {shard} exited with 0" in out, f"{shard}: child exit:\n{out[-3000:]}")
        log = (Path(tmp) / "first" / "logs" / f"{shard}.log").read_text()
        lines = [ln for ln in log.splitlines() if ln.startswith("{")]
        check(bool(lines), f"{shard}: no report in its log:\n{log[-3000:]}")
        reports[shard] = json.loads(lines[-1])
        check(reports[shard]["processed"] == FLEET_SUBSHARDS and reports[shard]["failed"] == 0
              and reports[shard]["uploaded"] == FLEET_SUBSHARDS,
              f"{shard}: report {reports[shard]}")

    # each shard's hub codes against a direct encode_batch in this process
    cfg = MimiConfig()
    engine = MimiEncoderEngine(params_from_safetensors(str(params_path), cfg), cfg,
                               num_codebooks=cfg.num_quantizers)  # as the CLI stores them
    same, total, chunk_seconds = 0, 0, 0.0
    for shard in FLEET_SHARDS:
        got = {}
        for s in range(FLEET_SUBSHARDS):
            for e in json.loads((hub / "data" / shard / f"{s:08d}.json").read_text()):
                got.update({cid: np.asarray(c) for cid, c in e["codes"].items()})
        ids, segments = [], []
        for e in entries[shard]:
            i, seg = slice_chunks(engine.prepare_audio(e.pcm, e.sample_rate), e.text, SR)
            ids += i
            segments += seg
        check(sorted(got) == sorted(ids), f"{shard}: hub chunks {len(got)} vs {len(ids)}")
        direct = engine.encode_batch(segments, sr=SR)
        eq, n = code_frames([got[c] for c in ids], direct)
        same, total = same + eq, total + n
        chunk_seconds += sum(len(s) for s in segments) / SR
    check(same >= 0.999 * total, f"fleet hub vs direct frames {same}/{total}")
    del engine

    rc, rerun = pod_run("rerun")
    check(rc == 0 and "launched=0 skipped=2" in rerun
          and all(f"{s}: already completed" in rerun for s in FLEET_SHARDS),
          f"rerun:\n{rerun[-3000:]}")
    check(not list((Path(tmp) / "rerun" / "logs").iterdir()), "the rerun launched a child")

    counts_path = Path(tmp) / "fleet_expected.json"
    with contextlib.redirect_stdout(io.StringIO()) as listed:
        manifests.main(["shards", "--hub", f"dir:{root}", "--suffix", ".json"])
        manifests.main(["counts", "--hub", f"dir:{root}", "--out", str(counts_path)])
    listed = listed.getvalue()
    counts = json.loads(counts_path.read_text())
    check(listed.splitlines()[:len(FLEET_SHARDS)] == list(FLEET_SHARDS),
          f"manifests shards: {listed[:300]}")
    check(counts == {s: FLEET_SUBSHARDS for s in FLEET_SHARDS}, f"manifests counts: {counts}")
    with contextlib.redirect_stdout(io.StringIO()) as status:
        monitor.main(["status", "--progress-dir", str(prog), "--expected", str(counts_path)])
    status = status.getvalue()
    rows = monitor.scan_progress_dir(str(prog), counts)
    check(f"{len(FLEET_SHARDS)}/{len(FLEET_SHARDS)} shards completed" in status
          and [r["status"] for r in rows] == ["completed"] * len(FLEET_SHARDS),
          f"monitor status:\n{status}")
    with contextlib.redirect_stdout(io.StringIO()) as verify:
        vrc = monitor.main(["verify", "--progress-dir", str(prog), "--hub", f"dir:{hub}",
                            "--template", "data/{shard}/{unit}.json"])
    check(vrc == 0 and json.loads(verify.getvalue()) == [], f"monitor verify: {verify.getvalue()}")

    n_gpus = torch.cuda.device_count()
    runner_gpus = pod_runner._visible_gpu_devices()
    check(runner_gpus == n_gpus, f"the pod runner counts {runner_gpus} GPUs, torch {n_gpus}")
    rc_ok, ok_out = run_module(["tokenize_audio_tpu_torch.runner.chip_check", "--chip-env",
                                "CUDA_VISIBLE_DEVICES=0"], timeout=300)
    ok = json.loads(ok_out.strip().splitlines()[-1])
    check(rc_ok == 0 and ok["ok"] and ok["child"]["device0"] == torch.cuda.get_device_name(0),
          f"chip_check on GPU 0: {ok}")
    rc_bad, bad_out = run_module(["tokenize_audio_tpu_torch.runner.chip_check", "--chip-env",
                                  f"CUDA_VISIBLE_DEVICES={n_gpus}"], timeout=300)
    bad = json.loads(bad_out.strip().splitlines()[-1])
    check(rc_bad == 1 and not bad["ok"] and bad["child"]["n_devices"] == 0,
          f"chip_check at GPU {n_gpus} (none there): {bad}")
    emit({
        "phase": "fleet",
        "shards": list(FLEET_SHARDS),
        "chunk_audio_seconds": chunk_seconds,
        "runner_gpu_count": runner_gpus,
        "reports": reports,
        "pod_runner_wall_seconds": run_seconds,
        "realtime_factor": chunk_seconds / run_seconds,
        "vs_direct_frames_equal": same,
        "vs_direct_frames": total,
        "manifest_counts": counts,
        "chip_check_gpu0": ok,
        "chip_check_no_gpu": bad,
        "children_launches": "not counted: the children are other processes; their codes are "
                             "held against a direct encode_batch in this one",
        "seconds": time.perf_counter() - t0,
    })


CHAOS_SEED = SEED + 60
CHAOS_SHARD, CHAOS_SUBSHARDS, CHAOS_ENTRIES = "en000", 3, 8  # YODAS2: lognormal 1-30 s entries
CHAOS_CORPUS_SHARDS, CHAOS_CORPUS_ROWS = 3, 8  # People's Speech: 16 kHz FLAC rows of 2-15 s
# SIGKILL delays as shares of the uninterrupted child run's work window (from
# its first file written under its directories to its exit), measured in this
# run: a child's pace varied ~1.5x between H100 machines and with the other
# children running beside it, so fixed delays landed all before any durable
# output on one machine and after the end on another
CHAOS_KILL_SHARES = (0.1, 0.35, 0.6, 0.85)
CHAOS_BUILD_KILL_S = 1.0  # after an nvcc of the build is first seen: mid-compile
CHAOS_ORPHAN_WAIT_S = 120.0  # for a killed build's nvcc to end on its own
CHAOS_BUILD_SECONDS = 10.0  # the build child's utterance
# a processor's command line in a child process: the checkout on sys.path,
# warnings only (a full pipe would stall it: nothing reads it before the
# kill), READY once its module is imported, then ``main(argv)``
CHAOS_CLI = ("import importlib, logging, sys\n"
             "sys.path.insert(0, sys.argv[1])\n"
             "logging.basicConfig(level=logging.WARNING)\n"
             "module = importlib.import_module(sys.argv[2])\n"
             "print('READY', flush=True)\n"
             "module.main(sys.argv[3:])\n")
# the first-use kernel build in a child: BUILD_DIR patched to an empty
# directory here only, READY, then the engine built and one utterance encoded;
# with "replace", the child SIGKILLs itself where a build would os.replace a
# finished library into place
CHAOS_BUILD_CHILD = r"""
import json, os, signal, sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import numpy as np
from tokenize_audio_tpu_torch.ops.cuda import _build
_build.BUILD_DIR = Path(sys.argv[2])
if sys.argv[6:] == ["replace"]:
    real_replace = os.replace
    def replace(src, dst, *args, **kwargs):
        if str(src).endswith(".tmp.so"):
            print("KILL at os.replace " + str(src), flush=True)
            os.kill(os.getpid(), signal.SIGKILL)
        return real_replace(src, dst, *args, **kwargs)
    os.replace = replace
print("READY", flush=True)
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig
from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors
cfg = MimiConfig()
engine = MimiEncoderEngine(params_from_safetensors(sys.argv[3], cfg), cfg,
                           num_codebooks=cfg.num_quantizers)
[codes] = engine.encode_batch([np.load(sys.argv[4])])
np.save(sys.argv[5], codes)
print("DONE " + json.dumps({"loaded": sorted(_build._libs)}), flush=True)
"""


def paced_child(argv, root, timeout=600):
    """One uninterrupted child run (output to a file, so no pipe fills):
    (exit code, output, seconds from its first change under ``root`` to its
    exit, wall seconds)."""
    before, seen = file_stamps(root), None
    t0 = time.perf_counter()
    with tempfile.TemporaryFile() as log:
        p = subprocess.Popen([sys.executable, *argv], stdout=log, stderr=subprocess.STDOUT)
        while p.poll() is None and time.perf_counter() - t0 < timeout:
            if seen is None and file_stamps(root) != before:
                seen = time.perf_counter()
            time.sleep(0.02)
        if p.poll() is None:
            p.kill()
        p.wait()
        end = time.perf_counter()
        log.seek(0)
        out = log.read().decode(errors="replace")
    return p.returncode, out, end - (seen or end), end - t0


def chaos_children(module, argv_of, progress_of, what, done_token):
    """The child processes of one command line on the card: an
    uninterrupted run (the reference, whose work window sets the delays),
    then ``kill_anywhere`` (tests/chaos_utils.py): each run SIGKILLed at the
    next of CHAOS_KILL_SHARES of that window after its own first evidence of
    work (a file under its directory written or removed since it started),
    then one run to completion. A kill counts as mid-work when
    ``progress_of(dir)`` (read after it) says the work was not finished: it
    came after that run's evidence of work. ``argv_of(tag)`` gives (directory,
    argv). Runs in a worker thread (subprocesses only); returns the runs and
    kills, each kill with what it left."""
    from chaos_utils import kill_anywhere, run_child

    ref_dir, ref_argv = argv_of("clean")
    rc, out, window, wall = paced_child(["-c", CHAOS_CLI, str(ROOT), module, *ref_argv], ref_dir)
    check(rc == 0 and done_token in out, f"{what}: uninterrupted run exit {rc}:\n{out[-3000:]}")
    delays = [round(s * window, 3) for s in CHAOS_KILL_SHARES]
    root, argv = argv_of("chaos")
    runs, kills, before = [], [], {}

    def changed():
        return file_stamps(root) != before["stamps"]

    def run(kill_after):
        before["stamps"] = file_stamps(root)
        t = time.perf_counter()
        rc, out, killed = run_child(["-c", CHAOS_CLI, str(ROOT), module, *argv],
                                    kill_after=kill_after, timeout=600, evidence=changed)
        runs.append({"kill_after": kill_after, "rc": rc, "killed": killed,
                     "seconds": time.perf_counter() - t})
        if not killed and rc != 0:
            runs[-1]["tail"] = out[-2000:]
        return rc, out, killed

    def midwork():
        left = progress_of(root)
        left["mid_work"] = not left.pop("finished")
        kills.append({"kill_after": runs[-1]["kill_after"], **left})
        return left["mid_work"]

    t = time.perf_counter()
    try:
        kill_anywhere(run, midwork, delays, kill_attempts=len(delays), done_token=done_token)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: {e}; runs {runs}; kills {kills}") from None
    mid = sum(k["mid_work"] for k in kills)
    check(mid >= 1, f"{what}: no kill landed mid-work: runs {runs}; kills {kills}")
    return {"uninterrupted_wall_seconds": wall, "uninterrupted_work_seconds": window,
            "delays": delays, "runs": runs, "kills": kills, "kill_count": len(kills),
            "mid_work_kills": mid, "reruns": len(runs) - 1,
            "kill_loop_seconds": time.perf_counter() - t}


def finished_rerun(torch, module, argv):
    """The command line once more in this process on its finished output:
    (its report, both kernels' launches)."""
    (report, _), _, launches = counted_run(torch, lambda: in_process(module, argv))
    return report, launches


def chaos_yodas2(tmp, params_path):
    """The YODAS2 command line on a 3 x 8-entry mirror: (the children's part,
    the checks' part) of ``phase_chaos``."""
    from torch_yodas2_mirror import Entry, write_mirror

    rng = np.random.default_rng(CHAOS_SEED)
    subshards = []
    for s in range(CHAOS_SUBSHARDS):
        subshards.append([])
        for a in range(CHAOS_ENTRIES):
            container, sr = ("flac", SR) if a == 1 else ("wav", 16_000 if a == 2 else SR)
            seconds = float(np.clip(rng.lognormal(math.log(8.0), 0.8), 1.0, 30.0))
            subshards[-1].append(Entry(f"yt{s}-{a:02d}", tone_pcm(rng, seconds, sr), sr, container,
                                       lognormal_chunks(rng, seconds)))
    root = write_mirror(str(Path(tmp) / "chaos_mirror"), CHAOS_SHARD, subshards)

    def argv_of(tag):
        d = Path(tmp) / f"chaos_yodas2_{tag}"
        return d, ["--shard-id", CHAOS_SHARD, "--source", f"dir:{root}", "--hub",
                   f"dir:{d / 'hub'}", "--progress-dir", str(d / "prog"), "--work-dir",
                   str(d / "work"), "--params", str(params_path), "--upload-batch-size", "1"]

    def progress_of(d):
        work = d / "work" / CHAOS_SHARD
        hub = len(list((d / "hub" / "data" / CHAOS_SHARD).glob("*.json")))
        return {"hub_subshards": hub,
                "partial_entries": sum(len(p.read_text().splitlines())
                                       for p in work.glob("*.partial")),
                "outputs": len(list(work.glob("*.out.json"))),
                "finished": hub == CHAOS_SUBSHARDS}

    def hub_of(d):
        got = {}
        for p in sorted((d / "hub" / "data" / CHAOS_SHARD).glob("*.json")):
            for e in json.loads(p.read_text()):
                got.update({cid: np.asarray(c) for cid, c in e["codes"].items()})
        return got

    def children():
        return chaos_children("tokenize_audio_tpu_torch.datasets.yodas2", argv_of, progress_of,
                              "chaos yodas2", '"uploaded"')

    def checks(torch, params, cfg, loop):
        from tokenize_audio_tpu_torch.datasets import yodas2
        from tokenize_audio_tpu_torch.datasets.yodas2 import slice_chunks
        from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

        want, (d, argv) = hub_of(argv_of("clean")[0]), argv_of("chaos")
        got = hub_of(d)
        check(sorted(got) == sorted(want), f"chaos yodas2: hub chunks {len(got)} vs {len(want)}")
        rerun, launches = finished_rerun(torch, yodas2, argv)
        check(rerun["skipped"] == CHAOS_SUBSHARDS and rerun["processed"] == 0
              and not any(launches.values()),
              f"chaos yodas2: rerun of the finished shard {rerun}, launches {launches}")
        # each chunk's audio as the processor cuts it (16 kHz resampled on the card)
        engine = MimiEncoderEngine(params_from(params_path, cfg), cfg,
                                   num_codebooks=cfg.num_quantizers)
        ids, segments = [], []
        for e in (e for sub in subshards for e in sub):
            i, seg = slice_chunks(engine.prepare_audio(e.pcm, e.sample_rate), e.text, SR)
            ids += i
            segments += seg
        del engine
        match = match_within_ties(torch, params, cfg, segments, [got[c] for c in ids],
                                  [want[c] for c in ids], "chaos yodas2 hub vs uninterrupted")
        return {"audio_seconds": sum(len(s) for s in segments) / SR, "chunks": len(ids), **loop,
                "vs_uninterrupted": match, "finished_rerun": rerun,
                "finished_rerun_launches": launches}

    return children, checks


def params_from(params_path, cfg):
    from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors

    return params_from_safetensors(str(params_path), cfg)


def chaos_corpus(tmp, params_path):
    """The parquet-corpus command line (People's Speech, default flags, 8
    books) on 3 shards of 8 FLAC rows: (the children's part, the checks'
    part) of ``phase_chaos``; every document held to an uninterrupted run's,
    up to near-ties."""
    import torch_corpora as tc

    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
    from tokenize_audio_tpu_torch.hub import LocalHub

    rng = np.random.default_rng(CHAOS_SEED + 1)
    src, pcm = LocalHub(str(Path(tmp) / "chaos_ps_src")), {}
    shards = [f"train-{s:05d}" for s in range(CHAOS_CORPUS_SHARDS)]
    for shard in shards:
        rows = []
        for i in range(CHAOS_CORPUS_ROWS):
            rid = f"{shard}-utt{i:03d}"
            pcm[rid] = tc.tone_pcm(rng, float(rng.uniform(2, 15)), 16_000)
            rows.append({"id": rid, "text": f"utterance {i} of {shard}",
                         "audio": {"bytes": tc.flac_bytes(pcm[rid], 16_000),
                                   "path": f"{rid}.flac"}})
        local = write_parquet(rows, str(Path(tmp) / "chaos_ps_in.parquet"))
        src.upload_file(local, f"clean/{shard}.parquet")
    shard_list = Path(tmp) / "chaos_ps_shards.txt"
    shard_list.write_text("\n".join(shards) + "\n")

    def argv_of(tag):
        d = Path(tmp) / f"chaos_ps_{tag}"
        return d, ["--corpus", "peoples_speech", "--split", "clean", "--shard-id-list",
                   str(shard_list), "--source-hub", f"dir:{src.root}", "--target-hub",
                   f"dir:{d / 'dst'}", "--work-dir", str(d / "work"), "--progress-dir",
                   str(d / "prog"), "--params", str(params_path)]

    def progress_of(d):
        done = len(list((d / "dst" / "clean").glob("*.parquet")))
        return {"hub_shards": done, "finished": done == len(shards)}

    def docs_of(d):
        return {f"{p.name}:{r['id']}": r["text"]
                for p in sorted((d / "dst" / "clean").glob("*.parquet"))
                for r in read_parquet(str(p))}

    def children():
        return chaos_children("tokenize_audio_tpu_torch.datasets.parquet_corpus", argv_of,
                              progress_of, "chaos corpus", '"shard"')

    def checks(torch, params, cfg, loop):
        from tokenize_audio_tpu_torch.config import CODEBOOK_SIZE, UNICODE_OFFSET_LARGE
        from tokenize_audio_tpu_torch.core.codes import chars_to_codes
        from tokenize_audio_tpu_torch.datasets import parquet_corpus

        want, (d, argv) = docs_of(argv_of("clean")[0]), argv_of("chaos")
        got = docs_of(d)
        check(len(want) == 2 * len(pcm), f"chaos corpus: {len(want)} documents, {len(pcm)} rows")
        check(sorted(got) == sorted(want), f"chaos corpus: documents {len(got)} vs {len(want)}")
        rerun, launches = finished_rerun(torch, parquet_corpus, argv)
        check([r["status"] for r in rerun] == ["skipped"] * len(shards)
              and not any(launches.values()),
              f"chaos corpus: rerun of the finished shards {rerun}, launches {launches}")

        def codes_of(docs, key):
            [span] = AUDIO_SPAN.findall(docs[key])
            return np.asarray(chars_to_codes(span, 8, CODEBOOK_SIZE, return_tensors="np",
                                             unicode_offset=UNICODE_OFFSET_LARGE))

        keys = sorted(want)
        for k in keys:  # the text around the audio span is the row's own
            check(AUDIO_SPAN.sub("", got[k]) == AUDIO_SPAN.sub("", want[k]),
                  f"chaos corpus: {k} differs outside its audio span")
        rids = [k.split(":", 1)[1].rsplit("_type", 1)[0] for k in keys]
        match = match_within_ties(torch, params, cfg, [pcm[r] for r in rids],
                                  [codes_of(got, k) for k in keys],
                                  [codes_of(want, k) for k in keys],
                                  "chaos corpus documents vs uninterrupted", sr=16_000)
        return {"audio_seconds": sum(len(a) for a in pcm.values()) / 16_000, "rows": len(pcm),
                "documents": len(want), **loop, "vs_uninterrupted": match,
                "documents_equal": sum(got[k] == want[k] for k in keys),
                "finished_rerun": rerun, "finished_rerun_launches": launches}

    return children, checks


def processes_naming(needle: str) -> dict:
    """pid -> argv of every live process whose command line holds ``needle``."""
    out = {}
    for p in Path("/proc").iterdir():
        if not p.name.isdigit() or int(p.name) == os.getpid():
            continue
        try:
            argv = (p / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        argv = [a.decode(errors="replace") for a in argv if a]
        if any(needle in a for a in argv):
            out[int(p.name)] = argv
    return out


def chaos_build(tmp, params_path):
    """Children killed during their first-use kernel build (their
    ``_build.BUILD_DIR`` an empty directory), then rerun: (the children's
    part, the checks' part) of ``phase_chaos``. One child is killed where it
    would ``os.replace`` the first finished library into place, one
    CHAOS_BUILD_KILL_S after its nvcc is first seen: what each left (stale
    ``*.tmp.so``, an nvcc that outlived its parent), the next build removing
    a dead builder's file, and the rerun building and loading both libraries
    and encoding as this process does."""
    from chaos_utils import run_child

    from tokenize_audio_tpu_torch.ops.cuda import _build

    build_dir = Path(tmp) / "chaos_build"
    build_dir.mkdir()
    audio = tone_pcm(np.random.default_rng(CHAOS_SEED + 2), CHAOS_BUILD_SECONDS)
    np.save(Path(tmp) / "chaos_build_audio.npy", audio)

    def argv(tag, *extra):
        return ["-c", CHAOS_BUILD_CHILD, str(ROOT), str(build_dir), str(params_path),
                str(Path(tmp) / "chaos_build_audio.npy"), str(Path(tmp) / f"chaos_build_{tag}.npy"),
                *extra]

    def tmp_libs():
        return sorted(p.name for p in build_dir.glob("*.tmp.so"))

    def nvcc_pids():
        return sorted(pid for pid, a in processes_naming(str(build_dir)).items()
                      if Path(a[0]).name == "nvcc")

    def children():
        # 1. killed between nvcc's end and os.replace: a whole library left as .tmp.so
        rc, out, _ = run_child(argv("replace", "replace"), timeout=600)
        check(rc == -9 and "KILL at os.replace" in out,
              f"chaos build: no kill at os.replace (rc {rc}):\n{out[-2000:]}")
        at_replace = tmp_libs()
        check(len(at_replace) == 1, f"chaos build: the kill at os.replace left {at_replace}")
        # 2. killed while nvcc runs; the build first removes step 1's file
        rc, out, killed = run_child(argv("killed"), kill_after=CHAOS_BUILD_KILL_S, timeout=600,
                                    evidence=lambda: bool(nvcc_pids()))
        check(killed and rc == -9, f"chaos build: the kill did not land (rc {rc}):\n{out[-2000:]}")
        nvcc_left = nvcc_pids()
        check(nvcc_left, "chaos build: no nvcc ran at the kill")
        check(at_replace[0] not in tmp_libs(), f"chaos build: {at_replace[0]} was not removed")
        t_wait = time.perf_counter()
        while processes_naming(str(build_dir)) and time.perf_counter() - t_wait < CHAOS_ORPHAN_WAIT_S:
            time.sleep(0.2)
        orphan_seconds = time.perf_counter() - t_wait
        stragglers = processes_naming(str(build_dir))
        for pid in stragglers:  # the phase stops every process it started
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid, signal.SIGKILL)
        after_nvcc_kill = tmp_libs()
        # 3. the rerun: builds both, loads both, leaves no .tmp.so
        t1 = time.perf_counter()
        rc, out, _ = run_child(argv("rerun"), timeout=600)
        rerun_seconds = time.perf_counter() - t1
        check(rc == 0 and "DONE" in out, f"chaos build: rerun exit {rc}:\n{out[-3000:]}")
        loaded = json.loads(out.split("DONE ", 1)[1].splitlines()[0])["loaded"]
        check(loaded == sorted(_build.KERNELS), f"chaos build: rerun loaded {loaded}")
        libs = sorted(p.name for p in build_dir.glob("*.so") if ".tmp." not in p.name)
        check(libs == sorted(_build.library_path(n).name for n in _build.KERNELS),
              f"chaos build: libraries after the rerun {libs}")
        check(not tmp_libs(), f"chaos build: the rerun left {tmp_libs()}")
        return {"stale_after_kill_at_replace": at_replace,
                "kill_after_nvcc_seen": CHAOS_BUILD_KILL_S, "nvcc_at_kill": len(nvcc_left),
                "nvcc_outlived_parent": bool(nvcc_left), "orphans_ended_seconds": orphan_seconds,
                "orphans_killed": sorted(stragglers), "stale_after_nvcc_kill": after_nvcc_kill,
                "rerun_seconds": rerun_seconds, "rerun_loaded": loaded, "rerun_libraries": libs}

    def checks(torch, params, cfg, left):
        from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

        got = np.load(Path(tmp) / "chaos_build_rerun.npy")
        engine = MimiEncoderEngine(params_from(params_path, cfg), cfg,
                                   num_codebooks=cfg.num_quantizers)
        [want] = engine.encode_batch([audio])
        del engine
        return {**left, "vs_this_process": match_within_ties(
            torch, params, cfg, [audio], [got], [want], "chaos build: rerun vs this process")}

    return children, checks


def phase_chaos(torch, tmp, params_path):
    """The processors' SIGKILL contract on the card, "kill anywhere, rerun
    the same command", three jobs of child processes at once on the one
    card (the fleet's checkpoint as ``--params``): the YODAS2 and the
    parquet-corpus command lines each run uninterrupted, then SIGKILLed at
    CHAOS_KILL_SHARES of that run's work window after each run's first
    evidence of work and rerun until one completes (tests/chaos_utils.py's
    ``kill_anywhere``; at least one kill mid-work), each hub held to the
    uninterrupted run's (>= 0.999 of frames, every difference a near-tie
    under the kit's TIE_MARGIN, ``match_within_ties``) and a rerun of each
    finished command in this process skipping everything with no launch;
    and children killed during their first-use kernel build, then rerun
    (``chaos_build``). The children's launches are not counted."""
    from concurrent.futures import ThreadPoolExecutor

    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    from tokenize_audio_tpu_torch.mimi import MimiConfig, params_to_torch

    t0 = time.perf_counter()
    jobs = {"yodas2": chaos_yodas2(tmp, params_path), "corpus": chaos_corpus(tmp, params_path),
            "build": chaos_build(tmp, params_path)}
    with ThreadPoolExecutor(len(jobs)) as pool:
        running = {name: pool.submit(children) for name, (children, _) in jobs.items()}
        # every job runs to its end before any failure is raised
        left = {name: f.result() for name, f in running.items()}
    children_seconds = time.perf_counter() - t0
    cfg = MimiConfig()
    params = params_to_torch(params_from(params_path, cfg))  # on the card, for the replays
    out = {"phase": "chaos",
           **{name: checks(torch, params, cfg, left[name]) for name, (_, checks) in jobs.items()},
           "children_seconds": children_seconds,
           "children_launches": "not counted: the children are other processes",
           "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# the split-boundary contract: how far from a piece boundary a frame may differ
SCRIPTS_BOUNDARY_FRAMES = 2
SCRIPTS_CUTS = {"parity_census": ["--seeds", "0", "--n", "16"], "parity_sweep": ["--n", "16"]}


def phase_scripts(torch):
    """The port's qualification scripts (``tokenize_audio_tpu_torch.scripts``)
    on the card at full kyutai/mimi width, each through its entry function
    with its own defaults (the HF-oracle ones cut to ``SCRIPTS_CUTS``), with
    both kernels' launches and shapes counted over the phase and per
    script:

    - ``precision_probe``: codebooks trained by residual k-means on the
      model's own pre-RVQ activations (2400 s, 1500-frame rows of 2.88 M
      samples through the resblock kernel), then TF32 and bf16 against
      parity on 240 s held out, with interleaved timings; the parity codes
      (both kernels, on the k-means codebooks) held against an encode with
      the plain backends on the same trained params (>= 0.999 of frames,
      every first divergence a near-tie under the kit's TIE_MARGIN); a
      second training (not counted) must give the same codebooks;
    - ``split_boundary_census``: every differing frame within
      SCRIPTS_BOUNDARY_FRAMES of a piece boundary;
    - ``seanet_backend_probe`` (kernel vs plain SEANet, >= 0.999 of
      frames), ``stream_policy_probe`` and ``resampler_sensitivity`` (the
      production filter back in place after it);
    - ``parity_census`` (every flip a near-tie) and ``parity_sweep`` (>=
      0.999 of frames), the HF oracle on the CPU.

    Returns launches (total and per script), the shapes, and the trained
    codebooks (for the RVQ replay)."""
    import tokenize_audio_tpu_torch.core.audio as audio_mod
    from tokenize_audio_tpu_torch.mimi.model import encode
    from tokenize_audio_tpu_torch.qualify import TIE_MARGIN
    from tokenize_audio_tpu_torch.scripts import (
        bf16_qualification,
        parity_census,
        parity_sweep,
        precision_probe,
        resampler_sensitivity,
        seanet_backend_probe,
        split_boundary_census,
        stream_policy_probe,
    )

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    production_filter = audio_mod._kaiser_sinc_filter
    per_script, seconds = {}, {}
    with KernelSpy() as kernels:
        torch.cuda.synchronize()

        def run(name, fn, *args):
            # each script's launches, read with the card synchronised
            before = kernels.launches()
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):  # the phase's line carries it
                out = fn(*args)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            after = kernels.launches()
            per_script[name] = {k: after[k] - before[k] for k in after}
            return out

        report, state = run("precision_probe", precision_probe.run,
                            precision_probe.parser().parse_args([]), dev)
        # the first stage's launches on the training's 1500-frame rows
        pre_rvq_rows = kernels.shapes[(1, state["cfgs"]["highest"].num_filters, 1500 * SPF)]
        result, rows = run("split_boundary_census", split_boundary_census.main, [])
        backends = run("seanet_backend_probe", seanet_backend_probe.main, [])
        stream = run("stream_policy_probe", stream_policy_probe.main, [])
        resampler = run("resampler_sensitivity", resampler_sensitivity.main, [])
        parity, _ = run("parity_census", parity_census.main, SCRIPTS_CUTS["parity_census"])
        sweep = run("parity_sweep", parity_sweep.main, SCRIPTS_CUTS["parity_sweep"])
        launches = kernels.launches()
    shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    check(all(n > 0 for n in launches.values()), f"kernel launches in the scripts: {launches}")
    check(sum(shapes.values()) == launches["resblock_elu"]
          and sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"scripts shapes vs launches {launches}")
    check(per_script["precision_probe"]["rvq_quantize"] > 0,
          f"the RVQ kernel on the k-means codebooks: {per_script['precision_probe']}")
    check(pre_rvq_rows > 0, "the resblock kernel on 2.88 M-sample rows: no launch")

    # the probe's parity codes (both kernels) against the plain backends on
    # the same trained params: near-ties only, replayed on the plain RVQ input
    cfg = state["cfgs"]["highest"]
    plain = dataclasses.replace(cfg, rvq_backend="torch", seanet_backend="torch")
    with RvqCallSpy() as plain_rvq:
        want, _ = encode(state["dparams"], plain, state["rows"], state["valid"],
                         num_quantizers=len(report["usage"]))
    got, want = state["codes"]["highest"], want.cpu().numpy()
    frames_same = (got == want).all(axis=1)
    margins, differing = row_tie_margins(torch, state["dparams"]["rvq"], plain_rvq.calls[0][0],
                                         got, want, "precision probe kernel vs torch backends")
    check(differing == int((~frames_same).sum()), "the plain run's one RVQ call holds the codes")
    check(frames_same.mean() >= 0.999,
          f"precision probe kernel vs torch backends: frame match {frames_same.mean()}")
    check(max(map(abs, margins), default=0.0) < TIE_MARGIN,
          f"precision probe kernel vs torch backends: a flip is no near-tie: {margins}")
    check(min(report["usage"]) > cfg.codebook_size // 8,
          f"k-means codebook usage collapsed: {report['usage']}")
    heads = {h: state["dparams"]["rvq"][h]["embed"] for h in ("semantic", "acoustic")}
    del state
    # a decision-grade oracle is repeatable: a second training on the card
    # gives the same codebooks, bit for bit
    args = precision_probe.parser().parse_args([])
    with contextlib.redirect_stdout(io.StringIO()):
        again = bf16_qualification.trained_params(cfg, args.books, args.train_sec,
                                                  args.kmeans_iters, dev)
    check(all(np.array_equal(again["rvq"][h]["embed"], e.cpu().numpy()) for h, e in heads.items()),
          "the k-means codebooks differ between two trainings on the card")

    check(result["worst_distance_frames"] <= SCRIPTS_BOUNDARY_FRAMES,
          f"split-boundary census: a differing frame {result['worst_distance_frames']} frames "
          f"from a boundary (contract: {SCRIPTS_BOUNDARY_FRAMES})")
    check(backends["frame_agreement"] >= 0.999,
          f"SEANet kernel vs torch backend frame agreement {backends['frame_agreement']}")
    check(audio_mod._kaiser_sinc_filter is production_filter,
          "resampler_sensitivity left another filter design in place")
    check(parity["census"]["max_rel_margin"] is None
          or parity["census"]["max_rel_margin"] < TIE_MARGIN,
          f"parity census: a flip is no near-tie: {parity['census']}")
    check(sweep["frame_exact_match"] >= 0.999, f"parity sweep: {sweep}")
    for rep in (stream, sweep, parity["census"]):
        check(rep["device"] == torch.cuda.get_device_name(0), f"a script ran on {rep['device']}")
    out = {
        "phase": "scripts",
        "width": "MimiConfig() (kyutai/mimi): 8 layers, 512 wide, 2048-entry books",
        "precision_probe": {**report,
                            "kernel_vs_torch_backends_frame_match": float(frames_same.mean()),
                            "kernel_vs_torch_backends_flip_margins": margins},
        "split_boundary_census": {**result, "rows": rows},
        "seanet_backend_probe": backends,
        "stream_policy_probe": stream,
        "resampler_sensitivity": resampler,
        "parity_census": parity["census"],
        "parity_sweep": sweep,
        "cuts": SCRIPTS_CUTS,
        "launches": launches,
        "launches_per_script": per_script,
        "resblock_launches_on_2_88M_sample_rows": pre_rvq_rows,
        "script_seconds": seconds,
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    return launches, per_script, shapes, rvq_shapes, heads


# the A/B probes in the order they run; each at its own defaults but for
# PROBES_CUTS (five timing rounds cut to three)
PROBES = ("drain_policy_probe", "fetch_ahead_probe", "fetch_dtype_probe", "fetch_pack_probe",
          "growth_probe", "pipeline_depth_probe", "samples_budget_probe",
          "warmup_tails_receipt", "conv_layout_probe")
PROBES_CUTS = {"drain_policy_probe": ["3"], "fetch_pack_probe": ["--rounds", "3"],
               "growth_probe": ["--rounds", "3"], "pipeline_depth_probe": ["3"],
               "samples_budget_probe": ["3"]}
# NLC vs NCL plain SEANet, x max|NCL|: the bar the replay holds the resblock
# kernel to against its plain version (fp32 sums in another order, here
# over the SEANet's 14 convs)
PROBES_LAYOUT_RTOL = 1e-4


LAYOUT_CHILD = ("import json, torch, chip_smoke; "
                "print(json.dumps(chip_smoke.layout_profiles(torch)))")


def layout_profiles(torch, batch: int = 16, seconds: float = 20.0) -> dict:
    """The conv-layout probe's three SEANets at its defaults, each
    launch-counted (the kernel stage launches the resblock kernel, the
    plain ones nothing), timed by CUDA events, and profiled
    (``device_breakdown``: which cuDNN kernels each layout runs), up to
    three times until the profile's device time reaches 0.9 of the event
    time (``complete``)."""
    from tokenize_audio_tpu_torch.config import fp32_precision
    from tokenize_audio_tpu_torch.scripts import conv_layout_probe

    out = {}
    with KernelSpy(active=False) as kernels, fp32_precision("ieee"), torch.no_grad():
        _, _, audio, _, seanets = conv_layout_probe.setup(batch, seconds, torch.device("cuda"))
        for line, sea in seanets.items():
            kernels.reset()
            sea(audio)
            torch.cuda.synchronize()
            row = {"launches": kernels.launches(), "event_ms": cuda_ms(torch, lambda: sea(audio))}
            for attempt in range(3):
                row["profile"] = device_breakdown(torch, lambda: sea(audio))
                row["complete"] = row["profile"].get("device_ms", 0.0) >= 0.9 * row["event_ms"]
                if row["complete"]:
                    break
            out[line.strip()] = row
    return out


def phase_probes(torch):
    """The port's interleaved A/B probes, warmup receipt and conv-layout probe
    (``tokenize_audio_tpu_torch.scripts``) on the card at full kyutai/mimi
    width, each through its entry function at its own defaults but for
    ``PROBES_CUTS``, with both kernels' launches and shapes counted per
    script:

    - the transport probes (drain policy, wire format, fetch dtype,
      pipeline depth) assert their variants' codes bit-equal; fetch-ahead:
      4 sub-shards in every run, every run's hub the same;
    - samples budget asserts bit-equal codes too; growth pads to another
      lattice's lengths, where the card's convs sum in another order: its
      codes within the kit's rule (>= 0.999 of frames equal, every flip a
      near-tie under TIE_MARGIN; asserted by the probe, held again here);
    - the warmup receipt: programs > 0 per lattice;
    - the conv-layout probe: its NLC SEANet within PROBES_LAYOUT_RTOL x
      max|NCL| of the plain NCL one; then its three SEANets again in a
      child process (``layout_profiles``).

    A probe's failed assertion fails the phase after every probe has run.
    Returns launches (total and per script) and the shapes."""
    import importlib

    from tokenize_audio_tpu_torch.qualify import TIE_MARGIN

    t0 = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    per_script, seconds, reports, failures = {}, {}, {}, {}
    with KernelSpy() as kernels:
        for probe in PROBES:
            mod = importlib.import_module(f"tokenize_audio_tpu_torch.scripts.{probe}")
            before = kernels.launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            try:
                with contextlib.redirect_stdout(io.StringIO()):  # the phase's line carries it
                    reports[probe] = mod.main(PROBES_CUTS.get(probe, []))
            except AssertionError as e:
                failures[probe] = f"{type(e).__name__}: {e}"
            torch.cuda.synchronize()
            seconds[probe] = time.perf_counter() - t
            after = kernels.launches()
            per_script[probe] = {k: after[k] - before[k] for k in after}
        launches = kernels.launches()
        kernels.reset()
    shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    # the conv-layout probe's SEANets in a fresh process: late in a long run
    # the profiler here dropped most kernels' events. The probes' engines
    # are gone, but the memory pools of their transformer graphs stay
    # reserved in this process until the cache is emptied: hand the card's
    # memory back before the child claims it
    torch.cuda.empty_cache()
    child = subprocess.run([sys.executable, "-c", LAYOUT_CHILD], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
    check(child.returncode == 0, f"conv layout child failed:\n{child.stderr[-3000:]}")
    layouts = json.loads(child.stdout.strip().splitlines()[-1])
    summaries = {p: {k: v for k, v in rep.items() if k != "codes"} for p, rep in reports.items()}
    if failures:
        emit({"phase": "probes", "failures": failures, "reports": summaries,
              "launches_per_script": per_script, "script_seconds": seconds})
    check(not failures, f"probes failed: {failures}")
    for probe, rep in reports.items():
        check(rep["device"] == name, f"{probe} ran on {rep['device']}")
        check(all(n > 0 for n in per_script[probe].values()),
              f"{probe} launched {per_script[probe]}")
    check(sum(shapes.values()) == launches["resblock_elu"]
          and sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"probes shapes vs launches {launches}")
    fa = reports["fetch_ahead_probe"]
    check(len(fa["processed"]) == 1 + 2 * fa["rounds"] and set(fa["processed"].values()) == {4},
          f"fetch_ahead sub-shards per run: {fa['processed']}")
    check(len(set(fa["hub_digests"].values())) == 1, "fetch_ahead: the runs' hubs differ")
    for g, t in reports["growth_probe"]["ties"].items():
        check(t["equal_frames"] >= 0.999 * t["frames"]
              and max(map(abs, t["flip_margins"]), default=0.0) < TIE_MARGIN,
              f"growth {g}: {t['equal_frames']} of {t['frames']} frames, "
              f"margins {t['flip_margins']}")
    for lat in reports["warmup_tails_receipt"]["result"]["per_lattice"]:
        check(lat["programs"] > 0, f"warmup receipt: no program at {lat['sr']} Hz")
    lay = reports["conv_layout_probe"]
    check(lay["nlc_vs_ncl_torch_maxdiff_full"]
          <= PROBES_LAYOUT_RTOL * lay["ncl_torch_max_abs_full"],
          f"conv layout: NLC vs NCL torch {lay['nlc_vs_ncl_torch_maxdiff_full']} > "
          f"{PROBES_LAYOUT_RTOL} x {lay['ncl_torch_max_abs_full']}")
    check(layouts["seanet NCL kernel"]["launches"]["resblock_elu"] > 0
          and layouts["seanet NCL torch"]["launches"]["resblock_elu"] == 0
          and layouts["seanet NLC"]["launches"]["resblock_elu"] == 0,
          f"conv layout SEANet launches: { {k: v['launches'] for k, v in layouts.items()} }")
    out = {
        "phase": "probes",
        "width": "MimiConfig() (kyutai/mimi): 8 layers, 512 wide, 2048-entry books",
        "reports": summaries,
        "layouts": layouts,
        "cuts": PROBES_CUTS,
        "launches": launches,
        "launches_per_script": per_script,
        "script_seconds": seconds,
        "seconds": time.perf_counter() - t0,
    }
    emit(out)
    return launches, per_script, shapes, rvq_shapes


DOWNSTREAM_SEED = SEED + 40
DOWNSTREAM_PARQUET_ROWS = 40  # the mirror's 96 documents: two rollovers and a final flush
DOWNSTREAM_LANGS = ("fr", "de")
DOWNSTREAM_CVSS_ROWS = 8  # per language
DOWNSTREAM_VOCAB = 8 * 2048 + 64  # the code alphabet, the specials and merges within a frame
SURGERY_LM = dict(vocab_size=16, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4)
SURGERY_ATOL = 1e-6  # x max|w|: card vs CPU on the new rows, whose mean is reduced on each


def in_process(module, argv):
    """``module.main(argv)`` in this process, its stdout kept off this
    script's: (return value, stdout)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        ret = module.main(argv)
    return ret, out.getvalue()


def file_stamps(root) -> dict:
    """relative path -> (size, mtime_ns) of every file under ``root`` (none
    if it is missing); a file that vanishes while it is read is left out, as
    the chaos phase polls directories a child is writing."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            with contextlib.suppress(OSError):
                st = os.stat(os.path.join(dirpath, f))
                out[os.path.relpath(os.path.join(dirpath, f), root)] = (st.st_size,
                                                                         st.st_mtime_ns)
    return out


def parquet_rows(read_parquet, root) -> list:
    return [r for p in sorted(Path(root).rglob("*.parquet")) for r in read_parquet(str(p))]


class EmbeddingSpy:
    """Records the device and dtype of the model each call of
    ``surgery.extend_model_embeddings`` resizes."""

    def __init__(self, surgery):
        self.surgery, self.seen = surgery, []

    def __enter__(self):
        self.orig = orig = self.surgery.extend_model_embeddings

        def spy(model, *args, **kwargs):
            w = model.get_input_embeddings().weight
            self.seen.append({"device": str(w.device), "dtype": str(w.dtype)})
            return orig(model, *args, **kwargs)

        self.surgery.extend_model_embeddings = spy
        return self

    def __exit__(self, *exc):
        self.surgery.extend_model_embeddings = self.orig


def surgery_run(torch, tmp, chunk_strs):
    """The surgery command line on a tiny causal LM (SURGERY_LM, seeded, no
    download) and a tiny codec tokenizer: rename, BOS, the 8 x 2048 audio
    alphabet and the pipeline specials, the model resized on the card and
    then with ``--device cpu``. Kept rows bit-equal to the base model's, the
    two runs' tokenizers and vocab sizes equal, every other tensor equal,
    and the new rows within SURGERY_ATOL x max|w| of each other."""
    from safetensors.torch import load_file
    from transformers import AutoModelForCausalLM, AutoTokenizer, LlamaConfig, LlamaForCausalLM

    from tokenize_audio_tpu_torch.bpe import surgery, trainer
    from tokenize_audio_tpu_torch.config import UNICODE_OFFSET

    tmp = Path(tmp)
    rng = np.random.default_rng(DOWNSTREAM_SEED + 1)
    (tmp / "base_codes").mkdir(parents=True)
    arrays = np.empty(4, dtype=object)
    arrays[:] = [rng.integers(0, 4, size=(2, 16)).astype(np.uint16) for _ in range(4)]
    np.save(str(tmp / "base_codes" / "c.npy"), arrays, allow_pickle=True)
    base = trainer.CodecBPETrainer(2, 4, vocab_size=2 * 4 + 2, eos_token="<|endoftext|>",
                                   unk_token="<unk>", max_token_codebook_ngrams=0,
                                   unicode_offset=UNICODE_OFFSET).train(str(tmp / "base_codes"))
    base.save_pretrained(str(tmp / "base_tok"))
    torch.manual_seed(DOWNSTREAM_SEED)
    LlamaForCausalLM(LlamaConfig(**SURGERY_LM)).save_pretrained(str(tmp / "lm"))
    lm = load_file(str(tmp / "lm" / "model.safetensors"))
    runs = {}
    with EmbeddingSpy(surgery) as spy:
        for tag, device in (("card", []), ("cpu", ["--device", "cpu"])):
            t = time.perf_counter()
            _, out = in_process(surgery, [
                "--tokenizer", str(tmp / "base_tok"), "--out-dir", str(tmp / f"tok_{tag}"),
                "--rename", "<|endoftext|>=<|end_of_text|>", "--bos", "<|begin_of_text|>",
                "--add-audio-alphabet", "--pipeline-specials",
                "--model", str(tmp / "lm"), "--model-out", str(tmp / f"lm_{tag}"), *device])
            runs[tag] = {"report": json.loads(out), "seconds": time.perf_counter() - t,
                         "tensors": load_file(str(tmp / f"lm_{tag}" / "model.safetensors")),
                         "tokenizer": json.loads((tmp / f"tok_{tag}" / "tokenizer.json")
                                                 .read_text())}
    card, cpu = runs["card"], runs["cpu"]
    check([s["device"] for s in spy.seen] == ["cuda:0", "cpu"],
          f"surgery resized the model on {spy.seen}")
    want = len(base) + 1 + 8 * 2048 + 4  # BOS, alphabet, specials; the rename adds none
    for tag, r in runs.items():
        rep = r["report"]
        check(rep["vocab_size"] == rep["model_vocab_size"] == want,
              f"surgery {tag}: vocab {rep} != {want}")
    check(card["tokenizer"]["model"] == cpu["tokenizer"]["model"]
          and card["tokenizer"]["added_tokens"] == cpu["tokenizer"]["added_tokens"],
          "surgery: the card's tokenizer differs from the CPU's")
    n_copy, worst, scale = SURGERY_LM["vocab_size"], 0.0, 0.0
    check(sorted(card["tensors"]) == sorted(cpu["tensors"]), "surgery: tensor names differ")
    for name, w in cpu["tensors"].items():
        c = card["tensors"][name]
        check(c.dtype == w.dtype and c.shape == w.shape, f"surgery {name}: {c.shape} vs {w.shape}")
        if name in ("model.embed_tokens.weight", "lm_head.weight"):
            check(w.shape[0] == want, f"surgery {name}: {w.shape[0]} rows")
            for got in (c, w):
                check(torch.equal(got[:n_copy], lm[name][:n_copy]), f"surgery {name}: kept rows")
            worst = max(worst, float((c[n_copy:] - w[n_copy:]).abs().max()))
            scale = max(scale, float(w.abs().max()))
        else:
            check(torch.equal(c, w) and torch.equal(w, lm[name]), f"surgery {name} changed")
    check(worst <= SURGERY_ATOL * scale,
          f"surgery: card vs CPU new rows {worst} > {SURGERY_ATOL} x {scale}")
    # what from_pretrained loads without a dtype (transformers 5 reads the
    # checkpoint's, "auto"; 4.x float32), a float32 and a bfloat16 checkpoint
    loaded = {"float32_checkpoint": str(AutoModelForCausalLM.from_pretrained(
        str(tmp / "lm")).dtype)}
    LlamaForCausalLM(LlamaConfig(**SURGERY_LM)).to(torch.bfloat16).save_pretrained(
        str(tmp / "lm_bf16"))
    loaded["bfloat16_checkpoint"] = str(AutoModelForCausalLM.from_pretrained(
        str(tmp / "lm_bf16")).dtype)
    tok = AutoTokenizer.from_pretrained(str(tmp / "tok_card"))
    ids = tok.encode(tok.bos_token + chunk_strs[0] + "<|audio_end|>")
    check(tok.decode(ids) == tok.bos_token + chunk_strs[0] + "<|audio_end|>",
          "surgery: the extended tokenizer does not round-trip a code string")
    return {
        "vocab_size": want, "kept_rows": n_copy, "new_rows": want - n_copy,
        "max_abs_diff_new_rows": worst, "max_abs_w": scale, "atol": SURGERY_ATOL * scale,
        "devices": spy.seen, "from_pretrained_dtype": loaded,
        "tokenizer_class": type(tok).__name__,
        "tokenizer_files": sorted(p.name for p in (tmp / "tok_card").iterdir()),
        "model_files": sorted(p.name for p in (tmp / "lm_card").iterdir()),
        "seconds": {tag: r["seconds"] for tag, r in runs.items()},
    }


def phase_downstream(torch, tmp):
    """The chain downstream of the encoder, fed by the card: the port's
    YODAS2 command line on a fresh mirror (make_yodas2_mirror, its own seed;
    default flags: kernel backends, 32 codebooks) with both kernels'
    launches and shapes (the ``downstream_path``); then, each through its
    command line in process, the pretrain converter (and a rerun that
    uploads nothing), validate (0 bad rows), every document's audio spans
    against the hub's codes frame for frame (first 8 books), the five
    derivative modes (semantic = acoustic[::8]), CVSS on two languages of
    the card's code strings, the sampler (its .npy = the hub's codes cut to
    8 books) and the trainer (every sampled code string round-trips),
    surgery on the card against the CPU, count_rows and estimate_tokens
    over every row. Returns the launches and the shapes."""
    if str(TESTS_DIR) not in sys.path:
        sys.path.insert(0, str(TESTS_DIR))
    from torch_yodas2_mirror import write_mirror
    from tokenize_audio_tpu_torch.analytics import count_rows, estimate_tokens, validate
    from tokenize_audio_tpu_torch.bpe import sampler, trainer
    from tokenize_audio_tpu_torch.core.codes import chars_to_codes, codes_to_chars
    from tokenize_audio_tpu_torch.datasets import cvss, derivatives, pretrain_converter
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet, write_parquet
    from tokenize_audio_tpu_torch.hub import LocalHub

    t0 = time.perf_counter()
    tmp, seconds = Path(tmp), {}

    def stage(name, t):
        seconds[name] = time.perf_counter() - t
        return time.perf_counter()

    # the feeding encode, on the card
    subshards = make_yodas2_mirror(np.random.default_rng(DOWNSTREAM_SEED))
    root = write_mirror(str(tmp / "mirror"), YODAS2_SHARD, subshards)
    t = stage("mirror", t0)
    captured = {}
    with KernelSpy() as kernels:
        report, hub, _, _ = run_yodas2_cli(torch, root, tmp, "downstream", captured)
        launches = kernels.launches()
    shapes, rvq_shapes = kernels.shapes, kernels.rvq_shapes
    audio_seconds = captured.pop("downstream").stats.audio_seconds
    check(all(n > 0 for n in launches.values()), f"kernel launches in the encode: {launches}")
    check(sum(shapes.values()) == launches["resblock_elu"]
          and sum(rvq_shapes.values()) == launches["rvq_quantize"],
          f"downstream shapes vs launches {launches}")
    sids = [f"{s:08d}" for s in range(YODAS2_SUBSHARDS)]
    entries = []  # (audio_id, [(chunk id, (32, T) codes)]) in the hub's order
    for sid in sids:
        for e in json.loads((Path(hub) / "data" / YODAS2_SHARD / f"{sid}.json").read_text()):
            entries.append((e["audio_id"], [(cid, np.asarray(c)) for cid, c in e["codes"].items()
                                            if c]))
    chunks = [c for _, cs in entries for _, c in cs]
    check(all(c.shape[0] == 32 for c in chunks), "the hub's codes are not 32 books")
    chunk_strs = [codes_to_chars(c[:8], 2048, unicode_offset=0xE000) for c in chunks]
    frames = sum(c.shape[1] for c in chunks)
    t = stage("encode", t)

    # pretrain parquet, a rerun, validate, spans against the hub
    pre = tmp / "pretrain"
    conv_argv = ["--shard-id", YODAS2_SHARD, "--subshard-ids", ",".join(sids),
                 "--source-hub", f"dir:{hub}/data", "--target-hub", f"dir:{pre}",
                 "--work-dir", str(tmp / "conv_work"), "--progress-dir", str(tmp / "conv_prog"),
                 "--parquet-rows", str(DOWNSTREAM_PARQUET_ROWS)]
    conv = json.loads(in_process(pretrain_converter, conv_argv)[1])
    check(conv == {"processed": len(sids), "skipped": 0, "failed": 0}, f"converter {conv}")
    stamps, rows = file_stamps(pre), parquet_rows(read_parquet, pre)
    n_docs = 2 * len(entries)
    check(len(rows) == n_docs and len(stamps) == -(-n_docs // DOWNSTREAM_PARQUET_ROWS),
          f"converter: {len(rows)} rows in {len(stamps)} files for {len(entries)} entries")
    t = stage("convert", t)
    rerun = json.loads(in_process(pretrain_converter, conv_argv)[1])
    check(rerun == {"processed": 0, "skipped": len(sids), "failed": 0}, f"converter rerun {rerun}")
    check(file_stamps(pre) == stamps, "the converter's rerun uploaded")
    check(sorted(map(json.dumps, parquet_rows(read_parquet, pre))) == sorted(map(json.dumps, rows)),
          "the converter's rerun changed the rows")
    t = stage("convert_rerun", t)
    rc, out = in_process(validate, ["--hub", f"dir:{pre}", "--prefix", "data/"])
    qa = json.loads(out)
    check(rc == 0 and sum(r["bad_rows"] for r in qa.values()) == 0
          and sum(r["rows"] for r in qa.values()) == n_docs, f"validate: rc {rc}, {qa}")
    by_id = dict(entries)
    span_frames = 0
    for r in rows:
        aid, kind = r["id"].rsplit("_", 1)
        spans = AUDIO_SPAN.findall(r["text"])
        check(len(spans) == len(by_id[aid]), f"{r['id']}: {len(spans)} audio spans")
        for span, (cid, c) in zip(spans, by_id[aid]):
            got = chars_to_codes(span, 8, 2048, return_tensors="np", unicode_offset=0xE000)
            check(np.array_equal(np.asarray(got), c[:8]), f"{r['id']} {cid}: codes differ")
            span_frames += c.shape[1]
    t = stage("validate_and_spans", t)

    # the five derivative modes
    derived = {}
    for mode in ("asr", "acoustic", "semantic", "tts0", "fix"):
        rep, _ = in_process(derivatives, [
            "--mode", mode, "--source-hub", f"dir:{pre}", "--target-hub", f"dir:{tmp / mode}",
            "--progress-dir", str(tmp / f"prog_{mode}"), "--work-dir", str(tmp / f"work_{mode}")])
        check(rep.processed == len(stamps) and rep.failed == 0, f"derivatives {mode}: {rep}")
        derived[mode] = {r["id"]: r["text"] for r in parquet_rows(read_parquet, tmp / mode)}
    ids = {k: sorted(r["id"][:-6] for r in rows if r["id"].endswith(k)) for k in ("_type1", "_type2")}
    for mode, kind in (("asr", "_type2"), ("acoustic", "_type2"), ("semantic", "_type2"),
                       ("tts0", "_type1")):
        check(sorted(derived[mode]) == ids[kind], f"derivatives {mode}: ids")
    check(len(derived["fix"]) == n_docs, "derivatives fix: rows")
    for rid, text in derived["semantic"].items():
        acoustic = AUDIO_SPAN.findall(derived["acoustic"][rid])
        check("<|text_start|>" not in derived["acoustic"][rid], f"acoustic {rid} keeps text")
        check(AUDIO_SPAN.findall(text) == [s[::8] for s in acoustic], f"semantic {rid}")
    check(all("<|text_start|>[0]" in text for text in derived["tts0"].values()), "tts0 tags")
    t = stage("derivatives", t)

    # CVSS: two languages of S2ST rows made of the card's code strings
    src = LocalHub(str(tmp / "cvss_src"))
    s2st = {}
    for li, lang in enumerate(DOWNSTREAM_LANGS):
        s2st[lang] = [{"id": f"{lang}-{i}", "original_text": f"{lang} text {i}",
                       "original_audio_str": chunk_strs[(2 * i + li) % len(chunk_strs)],
                       "translated_text": f"english text {i}",
                       "translated_audio_str": chunk_strs[(2 * i + li + 1) % len(chunk_strs)]}
                      for i in range(DOWNSTREAM_CVSS_ROWS)]
        src.upload_file(write_parquet(s2st[lang], str(tmp / f"{lang}.parquet")),
                        f"{lang}/test.parquet")
    _, out = in_process(cvss, ["--source-hub", f"dir:{tmp / 'cvss_src'}",
                               "--target-hub", f"dir:{tmp / 'cvss'}",
                               "--work-dir", str(tmp / "cvss_work"),
                               "--languages", *DOWNSTREAM_LANGS, "--splits", "test"])
    cvss_report = json.loads(out)
    n_cvss = DOWNSTREAM_CVSS_ROWS * len(DOWNSTREAM_LANGS)
    check(cvss_report == [{"split": "test", "status": "processed", "rows": n_cvss}],
          f"cvss {cvss_report}")
    combined = read_parquet(str(tmp / "cvss" / "data" / "test.parquet"))
    want = [(r["id"], lang, cvss.combine_row(r, lang)) for lang in DOWNSTREAM_LANGS
            for r in s2st[lang]]
    check([(r["id"], r["lang"], r["text"]) for r in combined] == want, "cvss rows")
    t = stage("cvss", t)

    # the sampler's corpus and the trainer's tokenizer
    npys, tok_dir = tmp / "npys", tmp / "tokenizer"
    sample = json.loads(in_process(sampler, ["--hub", f"dir:{hub}", "--out-dir", str(npys),
                                            "--per-shard", str(len(sids)), "--seed", "42",
                                            "--num-codebooks", "8"])[1])
    check(sample == {"processed": len(sids), "skipped": 0, "failed": 0}, f"sampler {sample}")
    corpus = []
    for sid in sids:
        corpus += list(np.load(str(npys / f"{YODAS2_SHARD}_{sid}.npy"), allow_pickle=True))
    check(len(corpus) == len(chunks) and all(
        a.dtype == np.uint16 and np.array_equal(a, c[:8]) for a, c in zip(corpus, chunks)),
        "the sampler's .npy differ from the hub's codes")
    t = stage("sample", t)
    trained = json.loads(in_process(trainer, [
        "--codes-dir", str(npys), "--out-dir", str(tok_dir), "--num-codebooks", "8",
        "--codebook-size", "2048", "--vocab-size", str(DOWNSTREAM_VOCAB),
        "--max-token-codebook-ngrams", "1", "--unicode-offset", "0xE000",
        "--pipeline-specials"])[1])
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(str(tok_dir))
    tok_json = json.loads((tok_dir / "tokenizer.json").read_text())
    strs = [codes_to_chars(a, 2048, unicode_offset=0xE000) for a in corpus]
    check(all(tok.decode(tok.encode(s)) == s for s in strs),
          "a sampled code string does not survive encode then decode")
    check(trained["vocab_size"] == len(tok) > 8 * 2048, f"trainer {trained}, len {len(tok)}")
    t = stage("train", t)

    surgery_report = surgery_run(torch, tmp / "surgery", chunk_strs)
    t = stage("surgery", t)

    # count_rows and estimate_tokens over every row
    counted = json.loads(in_process(count_rows, ["--hub", f"dir:{pre}", "--prefix", "data/",
                                                "--group-depth", "0"])[1])
    check(counted == {"all": {"files": len(stamps), "rows": n_docs}}, f"count_rows {counted}")
    exact = sum(len(tok.encode(r["text"])) for r in rows)
    _, out = in_process(estimate_tokens, [
        "--hub", f"dir:{pre}", "--prefix", "data/", "--tokenizer", str(tok_dir),
        "--sample-rows", str(len(stamps) * n_docs), "--output", str(tmp / "estimate.json")])
    est = json.loads(out)["all"]
    # every row sampled; the estimator's int(mean x rows) can truncate the
    # float product one below the exact count
    check(est["total_rows"] == est["sampled_rows"] == n_docs
          and est["estimated_total_tokens"] == int(exact / n_docs * n_docs)
          and exact - est["estimated_total_tokens"] in (0, 1), f"estimate {est} vs exact {exact}")
    stage("analytics", t)

    import tokenizers
    import transformers

    emit({
        "phase": "downstream",
        "yodas2_report": report,
        "entries": len(entries),
        "chunks": len(chunks),
        "frames": frames,
        "audio_seconds": audio_seconds,
        "launches": launches,
        "converter": {"report": conv, "rerun": rerun, "rows": n_docs, "files": len(stamps),
                      "parquet_rows": DOWNSTREAM_PARQUET_ROWS},
        "validate_bad_rows": 0,
        "span_frames_checked": span_frames,
        "derivatives_rows": {m: len(d) for m, d in derived.items()},
        "cvss_rows": len(combined),
        "sampler": {"report": sample, "arrays": len(corpus)},
        "trainer": {"vocab_size": trained["vocab_size"],
                    "merges": len(tok_json["model"]["merges"]),
                    "round_trips": len(strs), "tokenizer_class": type(tok).__name__},
        "surgery": surgery_report,
        "count_rows": counted,
        "estimate": est,
        "exact_tokens": exact,
        "transformers": transformers.__version__,
        "tokenizers": tokenizers.__version__,
        "stage_seconds": seconds,
        "seconds": time.perf_counter() - t0,
    })
    return launches, shapes, rvq_shapes


MESH_RANK_SECONDS = 300  # each world-2 rank's wall limit
MESH_TP_BATCH = (8, 10.0)  # rows x seconds of the padded tensor-parallel batch
MESH_16K_SECONDS = (2.0, 4.5, 7.0, 9.5, 12.0, 14.5, 17.0, 20.0)  # fused 16 kHz utterances
# __graft_entry__.dryrun_multichip's uneven tail: 5 utterances, batch 2 x dp,
# a 0.4 s cap that splits the last one
MESH_TAIL_SAMPLES = (SPF + 7, 3 * SPF, 2 * SPF - 11, SPF // 2, 5 * SPF + 3)
MESH_TAIL_CFG = dict(batch_size=4, min_bucket_seconds=0.05, max_chunk_seconds=0.4,
                     code_transfer_format="packed")


def row_tie_margins(torch, rvq_params, emb, got, want, what):
    """(margins, differing frames) of two batched runs' codes ``got`` and
    ``want`` ((B, K, T) each): each differing row's ``flip_margins``,
    replayed on ``emb`` (B, hidden, T), the RVQ input of ``want``'s run."""
    margins, frames = [], 0
    for b in np.nonzero((got != want).any(axis=(1, 2)))[0]:
        frames += int((got[b] != want[b]).any(axis=0).sum())
        m = flip_margins(torch, rvq_params, emb[b:b + 1], got[b], want[b])
        check(m is not None, f"{what}: too many differing frames")
        margins += m
    return margins, frames


def mesh_inputs():
    """The mesh phase's inputs, drawn alike by the parent and every rank:
    the main phase's sub-shard, an 8 x 10 s padded int16 batch, 16 kHz
    int16 utterances and the uneven tail."""
    audios = make_subshard(np.random.default_rng(SEED + 1))
    rng = np.random.default_rng(SEED + 50)
    rows, secs = MESH_TP_BATCH
    batch = np.stack([tone_pcm(rng, secs) for _ in range(rows)])
    valid = rng.integers(batch.shape[1] // 3, batch.shape[1] + 1, rows).astype(np.int32)
    valid[0] = batch.shape[1]
    for i, v in enumerate(valid):
        batch[i, v:] = 0
    pcm16 = [tone_pcm(rng, s, 16_000) for s in MESH_16K_SECONDS]
    tail = [tone_pcm(rng, 1.0)[:n] for n in MESH_TAIL_SAMPLES]
    return {"subshard": audios, "tp_batch": batch, "tp_valid": valid, "pcm16": pcm16,
            "tail": tail}


def rvq_input_of(torch, params, cfg, audio, sr=SR, cap_seconds=60.0):
    """The RVQ input (1, hidden, frames) of ``audio`` as the engine encodes
    it: each piece of its split at ``cap_seconds`` in one plain-backend
    encode on the card at the source rate (fused resample off 24 kHz),
    concatenated on the time axis."""
    from tokenize_audio_tpu_torch.core.audio import split_long_audio
    from tokenize_audio_tpu_torch.mimi import model

    plain = dataclasses.replace(cfg, rvq_backend="torch", seanet_backend="torch")
    g = math.gcd(sr, SR)
    up, down = SR // g, sr // g
    spf_io = SPF * down // up
    cap = max(spf_io, int(cap_seconds * sr) // spf_io * spf_io)
    seen, orig, embs = {}, model.split_rvq_encode, []

    def spy(p, emb, *args, **kwargs):
        seen["emb"] = emb
        return orig(p, emb, *args, **kwargs)

    model.split_rvq_encode = spy
    try:
        for piece in split_long_audio(audio, cap):
            padded = np.zeros(-(-len(piece) // spf_io) * spf_io, dtype=piece.dtype)
            padded[: len(piece)] = piece
            _, valid = model.encode(params, plain, torch.from_numpy(padded)[None].cuda(),
                                    torch.tensor([len(piece)], dtype=torch.int32).cuda(),
                                    num_quantizers=32, resample=None if sr == SR else (up, down))
            embs.append(seen["emb"][:, :, : int(valid[0])])
    finally:
        model.split_rvq_encode = orig
    return torch.cat(embs, dim=2)


def match_within_ties(torch, params, cfg, audios, got, want, what, sr=SR, cap_seconds=60.0):
    """Frame-for-frame match of two code lists, one per utterance of
    ``audios``: >= 0.999 of frames equal, and every differing frame a
    near-tie (``flip_margins`` under the kit's TIE_MARGIN, replayed on the
    utterance's own RVQ input, ``rvq_input_of``)."""
    from tokenize_audio_tpu_torch.qualify import TIE_MARGIN

    check(len(got) == len(want) == len(audios), f"{what}: {len(got)} code arrays vs {len(want)}")
    same = frames = 0
    margins = []
    for audio, g, w in zip(audios, got, want):
        check(g.shape == w.shape, f"{what}: codes {g.shape} vs {w.shape}")
        eq = (g == w).all(axis=0)
        same, frames = same + int(eq.sum()), frames + eq.size
        if not eq.all():
            m = flip_margins(torch, params["rvq"],
                             rvq_input_of(torch, params, cfg, audio, sr, cap_seconds), g, w)
            check(m is not None, f"{what}: too many differing frames")
            margins += m
    check(same >= 0.999 * frames, f"{what}: {same} of {frames} frames equal")
    # either side may hold the smaller distance: a tie is small in magnitude
    check(max(map(abs, margins), default=0.0) < TIE_MARGIN,
          f"{what}: a flip is no near-tie: {margins}")
    return {"frames": frames, "equal_frames": same, "flip_margins": margins}


def counted_run(torch, run):
    """``run()`` with both kernel wrappers' launch counts set to 0 just
    before it and read just after (the card synchronised): (result,
    seconds, {kernel: launches})."""
    from tokenize_audio_tpu_torch.ops.cuda import rvq, seanet

    rvq.rvq_quantize.launches = seanet.resblock_elu.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {"rvq_quantize": rvq.rvq_quantize.launches,
                                           "resblock_elu": seanet.resblock_elu.launches}


@contextlib.contextmanager
def all_reduce_spy():
    """While open, records the shape of every ``torch.distributed.all_reduce``."""
    import torch.distributed as dist

    calls, orig = [], dist.all_reduce

    def spy(t, *args, **kwargs):
        calls.append(tuple(t.shape))
        return orig(t, *args, **kwargs)

    dist.all_reduce = spy
    try:
        yield calls
    finally:
        dist.all_reduce = orig


def mesh_child(torch, rank: int, tmp: str) -> int:
    """One rank of the mesh phase's world 2: gloo (NCCL refuses two ranks on
    one card), both ranks on cuda:0. Runs, each with both kernels' launch
    counts set to 0 just before and read just after: the dp 2 engine on the
    sub-shard (shapes spied), the tp 2 ``shard_params_tp`` encode of the
    padded batch (all-reduces counted), packed against padded on this
    rank's rows, the fused 16 kHz encode, the uneven tail and the stream
    policy on the 75 s utterance. Writes ``rank{r}.npz`` / ``.json``."""
    import torch.distributed as dist

    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, model, random_params
    from tokenize_audio_tpu_torch.parallel import multihost
    from tokenize_audio_tpu_torch.parallel.mesh import (
        batch_sharding, make_mesh, replicate_params, shard_params_tp,
    )

    tmp = Path(tmp)
    dev = multihost.init_distributed(f"file://{tmp}/store2", 2, rank, backend="gloo",
                                     device="cuda:0")
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    x = mesh_inputs()
    dp_mesh, tp_mesh = make_mesh(dp=2, tp=1), make_mesh(dp=1, tp=2)
    info = {"rank": rank, "backend": dp_mesh.backend, "device": str(dev),
            "dp_mesh": [dp_mesh.data_index, dp_mesh.model_index],
            "tp_mesh": [tp_mesh.data_index, tp_mesh.model_index]}
    saved = {}

    def counted(name, run):
        out, seconds, launches = counted_run(torch, run)
        info[name] = {"seconds": seconds, "launches": launches}
        return out

    def keep(name, codes):
        saved.update({f"{name}_{i}": c for i, c in enumerate(codes)})

    engine = MimiEncoderEngine(params, cfg, num_codebooks=32, mesh=dp_mesh)
    engine.encode_batch(x["subshard"])  # first-use set-up of every shape, not counted
    with KernelSpy() as spy:
        keep("dp", counted("dp_engine", lambda: engine.encode_batch(x["subshard"])))
        info["shapes"] = [[list(k), n] for k, n in spy.shapes.items()]
        info["rvq_shapes"] = [[list(k), n] for k, n in spy.rvq_shapes.items()]

    b = torch.from_numpy(x["tp_batch"]).to(dev)
    v = torch.from_numpy(x["tp_valid"]).to(dev)
    p_tp = shard_params_tp(params, tp_mesh, cfg)
    with all_reduce_spy() as reduces:
        codes, _ = counted("tp_encode", lambda: model.encode(
            p_tp, cfg, b, v, num_quantizers=32, group=tp_mesh.model_group))
    saved["tp"] = codes.cpu().numpy()
    info["tp_encode"]["all_reduces"] = len(reduces)

    rows = batch_sharding(dp_mesh).span(len(x["tp_batch"]))
    rep = replicate_params(params, dp_mesh)
    padded, _ = model.encode(rep, cfg, b[rows], v[rows], num_quantizers=32)
    packed, _ = model.encode(rep, cfg, b[rows], v[rows], num_quantizers=32, transfer="packed")
    u16 = np.ascontiguousarray(packed.cpu().numpy()).view("<u2")
    u16 = u16.reshape(packed.shape[0], packed.shape[1], -1).transpose(0, 2, 1)
    info["packed_rows"] = [rows.start, rows.stop]
    info["packed_unpacks_to_padded"] = bool(np.array_equal(u16, padded.cpu().numpy()))

    keep("fused16", counted("fused16", lambda: engine.encode_batch(x["pcm16"], sr=16_000)))
    tail = MimiEncoderEngine(params, cfg, EngineConfig(**MESH_TAIL_CFG), num_codebooks=32,
                             mesh=dp_mesh)
    keep("tail", counted("tail", lambda: tail.encode_batch(x["tail"])))
    stream = MimiEncoderEngine(params, cfg, EngineConfig(long_audio_policy="stream"),
                               num_codebooks=32, mesh=dp_mesh)
    keep("stream", counted("stream", lambda: stream.encode_batch([x["subshard"][-1]])))
    np.savez(tmp / f"rank{rank}.npz", **saved)
    (tmp / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()
    return 0


def phase_mesh(torch, tmp):
    """The in-process mesh at full kyutai/mimi width (random weights, seed
    0), 32 codebooks, on the main phase's sub-shard against the solo
    engine's codes: world 1 in process on NCCL (the 1 x 1 mesh engine, a
    tp 1 ``shard_params_tp`` encode with its all-reduces counted), then
    world 2 on the one card (two ``--mesh-child`` processes, gloo): the dp
    2 engine, a tp 2 encode against the replicated one, packed words against
    padded codes, the fused 16 kHz resample, the uneven tail and the stream
    policy, each against the solo engine under the near-tie rule. Returns
    each rank's launches and world-2 rank 0's dp-engine shapes (the
    ``mesh_path``)."""
    import os

    import torch.distributed as dist

    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, model, params_to_torch, random_params
    from tokenize_audio_tpu_torch.parallel import multihost
    from tokenize_audio_tpu_torch.parallel.mesh import make_mesh, shard_params_tp

    t_phase = time.perf_counter()
    cfg = MimiConfig()
    raw = random_params(cfg, seed=SEED)
    params = params_to_torch(raw)  # on the card, for the near-tie replays
    x = mesh_inputs()
    audios = x["subshard"]
    audio_seconds = sum(len(a) for a in audios) / SR
    # each engine's timed pass follows an unmeasured one, which sets up
    # every batch shape's convolutions
    solo = MimiEncoderEngine(raw, cfg, num_codebooks=32)
    solo.encode_batch(audios)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo_codes = solo.encode_batch(audios)
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    frames = [-(-int(v) // SPF) for v in x["tp_valid"]]
    tp_audio = [x["tp_batch"][i, : x["tp_valid"][i]] for i in range(len(frames))]

    def rows_of(codes):
        return [codes[i, :, :f] for i, f in enumerate(frames)]

    # ---- world 1: the in-process mesh on NCCL --------------------------
    dev = multihost.init_distributed(f"file://{tmp}/store1", 1, 0)
    try:
        check(dist.get_backend() == "nccl", f"world 1 backend {dist.get_backend()}")
        mesh = make_mesh()
        check(mesh.shape == {"data": 1, "model": 1} and mesh.device == dev, f"world 1 mesh {mesh}")
        engine = MimiEncoderEngine(raw, cfg, num_codebooks=32, mesh=mesh)
        engine.encode_batch(audios)
        torch.cuda.synchronize()
        with KernelSpy() as spy:
            t0 = time.perf_counter()
            codes1 = engine.encode_batch(audios)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t0
            w1_launches = spy.launches()
        check(all(n > 0 for n in w1_launches.values()), f"world 1 engine launches {w1_launches}")
        w1_match = match_within_ties(torch, params, cfg, audios, codes1, solo_codes,
                                     "world 1 mesh engine vs solo")
        b = torch.from_numpy(x["tp_batch"]).to(dev)
        v = torch.from_numpy(x["tp_valid"]).to(dev)
        p_tp = shard_params_tp(raw, mesh, cfg)
        with all_reduce_spy() as reduces:
            (tp1, _), _, tp1_launches = counted_run(torch, lambda: model.encode(
                p_tp, cfg, b, v, num_quantizers=32, group=mesh.model_group))
        check(len(reduces) == 2 * cfg.num_hidden_layers,
              f"world 1 tp encode: {len(reduces)} all-reduces, not 2 per layer")
        check(all(n > 0 for n in tp1_launches.values()), f"world 1 tp launches {tp1_launches}")
        replicated, _ = model.encode(params, cfg, b, v, num_quantizers=32)
        replicated = replicated.cpu().numpy()
        tp1_match = match_within_ties(torch, params, cfg, tp_audio, rows_of(tp1.cpu().numpy()),
                                      rows_of(replicated), "world 1 tp encode vs replicated")
    finally:
        dist.destroy_process_group()

    # ---- world 2: two ranks on the one card, gloo ----------------------
    t_world2 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--mesh-child",
                               str(r), "--mesh-dir", str(tmp)], cwd=ROOT, env=dict(os.environ),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        # the references, on the card while the ranks run
        ref16 = solo.encode_batch(x["pcm16"], sr=16_000)
        ref_tail = MimiEncoderEngine(raw, cfg, EngineConfig(**MESH_TAIL_CFG),
                                     num_codebooks=32).encode_batch(x["tail"])
        ref_stream = MimiEncoderEngine(raw, cfg, EngineConfig(long_audio_policy="stream"),
                                       num_codebooks=32).encode_batch([audios[-1]])
        for r, p in enumerate(procs):
            left = MESH_RANK_SECONDS - (time.perf_counter() - t_world2)
            try:
                logs.append(p.communicate(timeout=max(1.0, left))[0])
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"mesh rank {r} ran past {MESH_RANK_SECONDS} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                logs.append(p.communicate()[0])
    for r, p in enumerate(procs):
        check(p.returncode == 0,
              f"mesh rank {r} exited {p.returncode}:\n" + "\n".join(f"--- {t[-4000:]}" for t in logs))
    world2_seconds = time.perf_counter() - t_world2
    ranks, launches = [], {"world1": {"engine": w1_launches, "tp_encode": tp1_launches}}
    for r in range(2):
        info = json.loads((Path(tmp) / f"rank{r}.json").read_text())
        z = np.load(Path(tmp) / f"rank{r}.npz")

        def got(name, n):
            return [z[f"{name}_{i}"] for i in range(n)]

        what = f"world 2 rank {r}"
        check(info["backend"] == "gloo" and info["device"] == "cuda:0", f"{what}: {info}")
        for run in ("dp_engine", "tp_encode", "fused16", "tail"):
            check(all(n > 0 for n in info[run]["launches"].values()),
                  f"{what} {run} launches {info[run]['launches']}")
        check(info["stream"]["launches"]["rvq_quantize"] > 0, f"{what}: no RVQ launch streaming")
        check(info["tp_encode"]["all_reduces"] == 2 * cfg.num_hidden_layers,
              f"{what}: {info['tp_encode']['all_reduces']} all-reduces")
        check(info["packed_unpacks_to_padded"], f"{what}: packed words differ from padded codes")
        for n, c in zip(MESH_TAIL_SAMPLES, got("tail", len(x["tail"]))):
            check(c.shape == (32, -(-n // SPF)), f"{what}: tail codes {c.shape} for {n} samples")
        ranks.append({
            "rank": r, "mesh": {"dp": info["dp_mesh"], "tp": info["tp_mesh"]},
            "runs": {k: info[k] for k in ("dp_engine", "tp_encode", "fused16", "tail", "stream")},
            "dp_engine_rtf": audio_seconds / info["dp_engine"]["seconds"],
            "dp_engine": match_within_ties(torch, params, cfg, audios, got("dp", len(audios)),
                                           solo_codes, f"{what} dp 2 engine"),
            "tp_encode": match_within_ties(torch, params, cfg, tp_audio, rows_of(z["tp"]),
                                           rows_of(replicated), f"{what} tp 2 encode"),
            "fused16": match_within_ties(torch, params, cfg, x["pcm16"],
                                         got("fused16", len(x["pcm16"])), ref16,
                                         f"{what} fused 16 kHz", sr=16_000),
            "tail": match_within_ties(torch, params, cfg, x["tail"], got("tail", len(x["tail"])),
                                      ref_tail, f"{what} tail", cap_seconds=0.4),
            "stream": match_within_ties(torch, params, cfg, [audios[-1]], got("stream", 1),
                                        ref_stream, f"{what} stream", cap_seconds=1e9),
        })
        launches[f"rank{r}"] = {k: info[k]["launches"] for k in
                                ("dp_engine", "tp_encode", "fused16", "tail", "stream")}
        if r == 0:
            shapes = collections.Counter({tuple(k): n for k, n in info["shapes"]})
            rvq_shapes = collections.Counter({tuple(k): n for k, n in info["rvq_shapes"]})
    emit({
        "phase": "mesh",
        "audio_seconds": audio_seconds,
        "solo_rtf": audio_seconds / solo_wall,
        "world1": {"backend": "nccl", "rtf": audio_seconds / wall1, "engine": w1_match,
                   "tp_encode": {**tp1_match, "all_reduces": len(reduces)}},
        "world2": {"backend": "gloo", "ranks": ranks, "seconds": world2_seconds},
        "launches": launches,
        "phase_seconds": time.perf_counter() - t_phase,
    })
    per_kernel = {name: {"world1": {run: n[name] for run, n in launches["world1"].items()},
                         **{f"rank{r}": {run: n[name] for run, n in launches[f"rank{r}"].items()}
                            for r in range(2)}}
                  for name in ("rvq_quantize", "resblock_elu")}
    return per_kernel, shapes, rvq_shapes


def start_extra_build(name: str, src: str, entry: str, argtypes):
    """Start ``nvcc`` on another version of a kernel's source into
    ``lib<name>.so``; returns a function that waits for it and returns its
    C entry ``entry`` and ptxas report."""
    from tokenize_audio_tpu_torch.ops.cuda import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{name}.so"
    proc = subprocess.Popen(_build.nvcc_command(Path(src).resolve(), out),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish():
        log, _ = proc.communicate()
        check(proc.returncode == 0, f"{name} build of {src} failed:\n{log}")
        fn = getattr(ctypes.CDLL(str(out)), entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn, [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]

    return finish


def phase_replay(torch, shapes, peak_flops, peak_bw, extras, path="main_path", reps=(2, 7, 5)):
    """The resblock kernel at every (B, C, T) a path (``path``: the main
    path's or the bench's) launched it with, on inputs drawn on the card:
    agreement with the plain version (1e-4 x max|plain|), CUDA-event times
    of the kernel and the plain version, and the FP32 bound; and the time
    and error of each of ``extras`` (name -> the C entry of another build:
    ``baseline`` takes HF-layout weights and must agree, the others take
    packed weights and their error is only reported). ``reps``: warm-ups,
    then the kernel's and the plain version's timed runs, per shape.
    Returns the sums per C, each shape weighted by its launch count."""
    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
    from tokenize_audio_tpu_torch.ops.cuda import seanet

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    weights, c = {}, cfg.num_filters
    for block in params["blocks"]:
        res = block["res"][0]
        w = [torch.from_numpy(res[a][p]).to(dev) for a in ("c1", "c2") for p in ("w", "b")]
        weights[c] = (*w, seanet.pack_weights(w[0], w[2]))
        c *= 2
    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    with ieee_fp32():
        for (b, c, t), count in sorted(shapes.items(), key=lambda kv: (kv[0][1], kv[0][0] * kv[0][2])):
            w3, b3, w1, b1, packed = weights[c]
            c2 = c // 2
            valid = rng.integers(t // 2, t + 1, b).astype(np.int32)
            valid[0] = t
            vt = torch.from_numpy(valid).to(dev)
            # drawn on the card: the bench's shapes hold up to ~3e8 elements
            xt = torch.randn((b, c, t), generator=gen, device=dev).mul_(0.5)
            xt.masked_fill_(torch.arange(t, device=dev)[None, None, :] >= vt[:, None, None], 0.0)
            args = (xt, vt, w3, b3, w1, b1)
            got = seanet.resblock_elu(*args, packed=packed)
            want = seanet.resblock_elu_reference(*args)
            torch.cuda.synchronize()
            err, scale = float((got - want).abs().max()), float(want.abs().max())
            check(err <= 1e-4 * scale, f"resblock {(b, c, t)}: max err {err} > 1e-4 * {scale}")
            flops = 2.0 * (3 * c * c2 + c * c2) * b * t
            nbytes = 4.0 * (2 * b * c * t + 4 * c * c2 + c2 + c + b)
            b_ms, b_by = bound_ms(flops, nbytes, peak_flops, peak_bw)
            row = {"B": b, "C": c, "T": t, "count": count, "max_abs_err": err,
                   "ms": cuda_ms(torch, lambda: seanet.resblock_elu(*args, packed=packed),
                                 warmup=reps[0], reps=reps[1]),
                   "plain_ms": cuda_ms(torch, lambda: seanet.resblock_elu_reference(*args),
                                       warmup=reps[0], reps=reps[2]),
                   "bound_ms": b_ms, "bound_by": b_by}
            out = torch.empty_like(xt)
            for name, fn in extras.items():
                ws = (w3, w1) if name == "baseline" else packed
                ptrs = [a.data_ptr() for a in (xt, vt, ws[0], b3, ws[1], b1, out)]

                def run_extra(fn=fn, ptrs=ptrs, name=name):
                    check(fn(*ptrs, b, c, c2, t, stream) == 0, f"{name} launch failed")

                run_extra()
                torch.cuda.synchronize()
                row[f"{name}_err"] = float((out - want).abs().max())
                if name == "baseline":
                    check(row[f"{name}_err"] <= 1e-4 * scale,
                          f"baseline {(b, c, t)}: max err {row[f'{name}_err']}")
                row[f"{name}_ms"] = cuda_ms(torch, run_extra, warmup=reps[0], reps=reps[1])
            rows.append(row)
            del got, want, out, xt, args
            torch.cuda.empty_cache()
    per_c = {}
    for c in sorted({r["C"] for r in rows}):
        rs = [r for r in rows if r["C"] == c]
        tot = {"launches": sum(r["count"] for r in rs), "shapes": len(rs),
               "columns": sum(r["count"] * r["B"] * r["T"] for r in rs)}
        for key in rs[0]:
            if key.endswith("ms"):
                tot[key] = sum(r["count"] * r[key] for r in rs)
            elif key.endswith("_err"):
                tot[key] = max(r[key] for r in rs)
        per_c[c] = tot
    total = {k: sum(p[k] for p in per_c.values())
             for k in per_c[min(per_c)] if k == "launches" or k.endswith("ms")}
    summary = {"per_C": per_c, "total": total, "max_abs_err": max(r["max_abs_err"] for r in rows),
               "timing": f"CUDA-event median of {reps[1]} (plain: {reps[2]}) after {reps[0]} "
                         f"warm-ups per shape, L2 not flushed",
               "seconds": time.perf_counter() - t0}
    emit({"phase": "replay", "path": path, **summary})
    return summary


def phase_rvq_replay(torch, rvq_shapes, peak_flops, peak_bw, extras, path="main_path",
                     heads=None):
    """The RVQ kernel at every (N, K) a path (``path``: the main path's or
    the bench's) launched it with, on
    the model's codebooks or ``heads`` (by head; K = 1: the semantic book,
    else the first K acoustic ones) and standard-normal rows: code agreement with the plain
    version (every first divergence a near-tie; >= 0.999 of the path's
    codes, counted by launch: one near-tie flip at an early book of a
    300-row shape changes over 0.1 % of that shape's codes), CUDA-event times of
    the kernel and the plain version, and the FP32 bound; and the time and
    agreement of each of ``extras`` (name -> the C entry of another build
    of csrc/rvq.cu; ``rvq_baseline`` must agree like the kernel). Returns
    the sums, each shape weighted by its launch count."""
    from tokenize_audio_tpu_torch.config import ieee_fp32
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
    from tokenize_audio_tpu_torch.ops.cuda import rvq

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    if heads is None:
        params = random_params(MimiConfig(), seed=SEED)
        heads = {h: torch.from_numpy(params["rvq"][h]["embed"]).to(dev)
                 for h in ("semantic", "acoustic")}
    rng = np.random.default_rng(SEED + 4)
    rows = []
    with ieee_fp32():
        for (n, k), count in sorted(rvq_shapes.items(), key=lambda kv: (kv[0][1], kv[0][0])):
            embeds = (heads["semantic"] if k == 1 else heads["acoustic"])[:k].contiguous()
            packed = rvq.pack_codebooks(embeds)
            v, d = embeds.shape[1:]
            x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
            got = rvq.rvq_quantize(x, embeds, packed=packed)
            want = rvq.rvq_quantize_reference(x, embeds)
            torch.cuda.synchronize()
            match, n_rows, margin, _ = rvq_agreement(x, embeds, got, want, f"rvq N={n} K={k}",
                                                     min_match=None)
            b_ms, b_by = bound_ms(2.0 * k * n * v * d, 4.0 * (k * v * d + n * d + n * k),
                                  peak_flops, peak_bw)
            row = {"N": n, "K": k, "count": count, "code_match": match, "diverging_rows": n_rows,
                   "max_rel_margin": margin,
                   "ms": cuda_ms(torch, lambda: rvq.rvq_quantize(x, embeds, packed=packed)),
                   "plain_ms": cuda_ms(torch, lambda: rvq.rvq_quantize_reference(x, embeds)),
                   "bound_ms": b_ms, "bound_by": b_by}
            time_rvq_extras(torch, row, extras, x, embeds, packed, want, f"N={n} K={k}")
            rows.append(row)
    total = {"launches": sum(r["count"] for r in rows), "shapes": len(rows),
             "rows": sum(r["count"] * r["N"] for r in rows)}
    for key in rows[0]:
        if key.endswith("ms"):
            total[key] = sum(r["count"] * r[key] for r in rows)
        elif key.endswith("code_match"):
            total[f"min_{key}"] = min(r[key] for r in rows)
    total["max_rel_margin"] = max(r["max_rel_margin"] for r in rows)
    codes = sum(r["count"] * r["N"] * r["K"] for r in rows)
    total["code_match"] = sum(r["count"] * r["N"] * r["K"] * r["code_match"] for r in rows) / codes
    check(total["code_match"] >= 0.999, f"rvq {path}: code match {total['code_match']} < 0.999")
    summary = {"total": total, "per_shape": rows,
               "timing": "CUDA-event median of 7 after 2 warm-ups per shape, L2 not flushed",
               "seconds": time.perf_counter() - t0}
    emit({"phase": "rvq_replay", "path": path, **summary})
    return summary


def phase_tie(torch):
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params

    cfg = MimiConfig()
    params = random_params(cfg, seed=SEED)
    rng = np.random.default_rng(SEED + 2)
    n = 3 * SR
    tt = np.arange(n) / SR
    audio = (0.3 * np.sin(2 * np.pi * 220 * tt) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    cpu = MimiEncoderEngine(params, cfg, num_codebooks=32, device="cpu").encode_chunk(audio)
    gpu = MimiEncoderEngine(params, cfg, num_codebooks=32).encode_chunk(audio)
    check(cpu.shape == gpu.shape, f"cpu {cpu.shape} vs card {gpu.shape}")
    frame_match = float((cpu == gpu).all(axis=0).mean())
    code_match = float((cpu == gpu).mean())
    emit({"phase": "tie", "frames": int(cpu.shape[1]), "card_vs_cpu_frame_match": frame_match,
          "card_vs_cpu_code_match": code_match})
    check(frame_match >= 0.999, f"card vs CPU frame match {frame_match} < 0.999")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline-cu",
                    help="an older seanet_resblock.cu (HF-layout weights) to time beside the kernel")
    ap.add_argument("--candidate-cu", action="append", default=[],
                    help="another seanet_resblock.cu (packed weights) to time beside the kernel")
    ap.add_argument("--rvq-baseline-cu",
                    help="an older rvq.cu ((K, V, D) codebooks and e2) to time beside the kernel")
    ap.add_argument("--rvq-candidate-cu", action="append", default=[],
                    help="another rvq.cu (packed codebooks) to time beside the kernel")
    ap.add_argument("--mesh-child", type=int, metavar="RANK",
                    help="run one rank of the mesh phase's two-process world (the phase starts it)")
    ap.add_argument("--mesh-dir", help="the mesh phase's directory (with --mesh-child)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.mesh_child is not None:
        return mesh_child(torch, args.mesh_child, args.mesh_dir)
    from tokenize_audio_tpu_torch.ops.cuda import _build, rvq, seanet

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    variant, peak_flops, peak_bw = peaks_for(name)
    emit({"phase": "device", "name": name, "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peaks": {"variant": variant, "fp32_flops": peak_flops, "hbm_bytes_per_s": peak_bw}})
    emit({"phase": "libraries", "imports": optional_libraries()})
    try:
        t0 = time.perf_counter()
        pending, rvq_pending = {}, {}
        rb = ("resblock_elu_launch", seanet._ARGTYPES)
        old_rvq = ("rvq_quantize_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
        if args.baseline_cu:
            pending["baseline"] = start_extra_build("baseline", args.baseline_cu, *rb)
        for src in args.candidate_cu:
            pending[Path(src).stem] = start_extra_build(Path(src).stem, src, *rb)
        if args.rvq_baseline_cu:
            rvq_pending["rvq_baseline"] = start_extra_build(
                "rvq_baseline", args.rvq_baseline_cu, *old_rvq)
        for src in args.rvq_candidate_cu:
            rvq_pending[Path(src).stem] = start_extra_build(
                Path(src).stem, src, "rvq_quantize_launch", rvq._ARGTYPES)
        seconds = _build.build([*_build.KERNELS, "lstm", "encodec_resblock"])
        ptxas = {
            k: [ln.strip() for ln in _build.build_log(k).splitlines()
                if "registers" in ln or "spill" in ln]
            for k in (*_build.KERNELS, "lstm", "encodec_resblock")
        }
        extras, rvq_extras = {}, {}
        for extra, done in pending.items():
            extras[extra], ptxas[extra] = done()
        for extra, done in rvq_pending.items():
            rvq_extras[extra], ptxas[extra] = done()
        emit({"phase": "build", "seconds": seconds, "wall_seconds": time.perf_counter() - t0,
              "ptxas": ptxas})
        times = {"build": time.perf_counter() - t0}

        def timed(name, fn, *a, **kw):
            t = time.perf_counter()
            out = fn(*a, **kw)
            times[name] = time.perf_counter() - t
            return out

        records = timed("kernels", phase_kernels, torch, peak_flops, peak_bw, rvq_extras)
        launches, shapes, rvq_shapes = timed("main", phase_main, torch)
        timed("dac", phase_dac, torch)
        torch.cuda.empty_cache()
        stream_launches, stream_rvq_shapes = timed("stream", phase_stream, torch)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_yodas2_") as tmp:
            yodas2_launches, yodas2_shapes, yodas2_rvq_shapes, mirror = timed(
                "yodas2", phase_yodas2, torch, tmp)
            modes_launches = timed("modes", phase_modes, torch, tmp, mirror)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_codec_") as tmp:
            codec_launches = timed("codec", phase_codec, torch, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_bench_") as tmp:
            bench_launches, bench_shapes, bench_rvq_shapes = timed(
                "bench", phase_bench, torch, tmp, smi)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_corpora_") as tmp:
            corpora_launches, corpus_shapes, corpus_rvq_shapes = timed(
                "corpora", phase_corpora, torch, tmp)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_qualify_") as tmp:
            qualify_launches, qualify_shapes, qualify_rvq_shapes, checkpoint = timed(
                "qualify", phase_qualify, torch, tmp)
            torch.cuda.empty_cache()  # the fleet's children share the card
            timed("fleet", phase_fleet, torch, tmp, checkpoint)
            timed("chaos", phase_chaos, torch, tmp, checkpoint)
        scripts_launches, scripts_per_script, scripts_shapes, scripts_rvq_shapes, kmeans_heads = (
            timed("scripts", phase_scripts, torch))
        torch.cuda.empty_cache()
        probes_launches, probes_per_script, probes_shapes, probes_rvq_shapes = timed(
            "probes", phase_probes, torch)
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_downstream_") as tmp:
            downstream_launches, downstream_shapes, downstream_rvq_shapes = timed(
                "downstream", phase_downstream, torch, tmp)
        torch.cuda.empty_cache()  # the mesh's children share the card
        with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
            mesh_launches, mesh_shapes, mesh_rvq_shapes = timed("mesh", phase_mesh, torch, tmp)
        for r in records:
            if r["name"] not in launches:
                continue  # EnCodec's LSTM: no Mimi phase launches it
            r["launches"] = launches[r["name"]]
            r["stream_launches"] = stream_launches[r["name"]]
            r["yodas2_launches"] = yodas2_launches[r["name"]]
            r["codec_launches"] = codec_launches[r["name"]]
            r["bench_launches"] = bench_launches[r["name"]]
            r["corpora_launches"] = corpora_launches[r["name"]]
            r["modes_launches"] = {m: n[r["name"]] for m, n in modes_launches.items()}
            r["qualify_launches"] = {e: n[r["name"]] for e, n in qualify_launches.items()}
            r["downstream_launches"] = downstream_launches[r["name"]]
            r["mesh_launches"] = mesh_launches[r["name"]]
            r["scripts_launches"] = {"total": scripts_launches[r["name"]],
                                     **{k: n[r["name"]] for k, n in scripts_per_script.items()}}
            r["probes_launches"] = {"total": probes_launches[r["name"]],
                                    **{k: n[r["name"]] for k, n in probes_per_script.items()}}
        t = time.perf_counter()
        rb = next(r for r in records if r["name"] == "resblock_elu")
        rb["main_path"] = phase_replay(torch, shapes, peak_flops, peak_bw, extras)
        rb["yodas2_path"] = phase_replay(torch, yodas2_shapes, peak_flops, peak_bw, {},
                                         path="yodas2_path")
        rb["bench_path"] = phase_replay(torch, bench_shapes, peak_flops, peak_bw, {},
                                        path="bench_path")
        rb["corpus_path"] = phase_replay(torch, corpus_shapes, peak_flops, peak_bw, {},
                                         path="corpus_path")
        rb["qualify_path"] = phase_replay(torch, qualify_shapes, peak_flops, peak_bw, {},
                                          path="qualify_path")
        rb["downstream_path"] = phase_replay(torch, downstream_shapes, peak_flops, peak_bw, {},
                                             path="downstream_path")
        rb["mesh_path"] = phase_replay(torch, mesh_shapes, peak_flops, peak_bw, {},
                                       path="mesh_path")
        rb["scripts_path"] = phase_replay(torch, scripts_shapes, peak_flops, peak_bw, {},
                                          path="scripts_path")
        # the probes launch well over a thousand shapes (the warmup
        # receipt's tail ladders): fewer runs each keep the smoke in its limit
        rb["probes_path"] = phase_replay(torch, probes_shapes, peak_flops, peak_bw, {},
                                         path="probes_path", reps=(1, 3, 3))
        times["replay"] = time.perf_counter() - t
        t = time.perf_counter()
        rq = next(r for r in records if r["name"] == "rvq_quantize")
        for path, found, ext in (("main_path", rvq_shapes, rvq_extras),
                                 ("stream_path", stream_rvq_shapes, {}),
                                 ("yodas2_path", yodas2_rvq_shapes, {}),
                                 ("bench_path", bench_rvq_shapes, {}),
                                 ("corpus_path", corpus_rvq_shapes, {}),
                                 ("qualify_path", qualify_rvq_shapes, {}),
                                 ("downstream_path", downstream_rvq_shapes, {}),
                                 ("mesh_path", mesh_rvq_shapes, {}),
                                 ("probes_path", probes_rvq_shapes, {})):
            rq[path] = phase_rvq_replay(torch, found, peak_flops, peak_bw, ext, path=path)["total"]
        # the scripts' RVQ launches replay on the k-means codebooks they trained
        rq["scripts_path"] = phase_rvq_replay(torch, scripts_rvq_shapes, peak_flops, peak_bw, {},
                                              path="scripts_path", heads=kmeans_heads)["total"]
        times["rvq_replay"] = time.perf_counter() - t
        timed("tie", phase_tie, torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    emit({"phase": "phase_seconds", **times, "total": time.perf_counter() - t0})
    print(smi, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
