"""The EnCodec cell, ``engine-web.encodec-8cb``: its entries in the manifest,
the plain reference against transformers' ``EncodecModel`` and the
program, the frozen operation counts against a hand count at the
published widths, whole runs at a tiny size on the CPU, and a run in a
fresh process loading no JAX."""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_testkit import BENCH, ROOT, cuda  # noqa: F401
from pbkit import encodec_flops, manifest, runner
from reference import encodec_ref, encodec_weights

CELL = "engine-web.encodec-8cb"
CPU = torch.device("cpu")
# two strides, narrow channels, the published two LSTM layers; bandwidths
# that give 1-12 books of 64 entries at 3000 frames a second
TINY = dict(num_filters=4, hidden_size=16, codebook_dim=16, upsampling_ratios=[4, 2],
            codebook_size=64, target_bandwidths=[18.0, 36.0, 72.0, 144.0, 216.0])
CFG = json.load(open(os.path.join(BENCH, "configs", "encodec-24k-8cb.json")))
SECOND = 24_000


def tiny_inputs():
    man = manifest.Manifest(ROOT)
    cell = man.cell(CELL)
    cfg = man.config(cell.config)
    cfg.update(TINY)
    cfg["run"].update(num_codebooks=8, bandwidth_kbps=144.0)
    mix = man.traffic(cell.traffic)
    mix["utterances"] = 6
    mix["lengths"]["max"] = 4.0
    params = man.cell_params(cell.name)
    params["trace_units"] = 1
    params["check"]["sample"] = 6
    return man, cell, cfg, mix, params


def run_tiny(tmp_path, trace=False, mode=None, seconds=0.3, seed=2**31 + 11):
    man, cell, cfg, mix, params = tiny_inputs()
    run = runner.Run(cell.name, cfg, mix, params, seed, seconds, CPU, str(tmp_path), mode)
    result = runner.execute(run, runner.driver(mix["driver"]), trace, time.perf_counter())
    return run, result, runner.result_line(man, run, result, trace)


def test_the_manifest_holds_the_cell():
    raw = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert manifest.problems(raw, ROOT) == []
    man = manifest.Manifest(ROOT, raw)
    assert man.cell(CELL).chips == 1
    assert [m["name"] for m in man.per_layer(CELL)] == [
        "lstm_roofline.encodec", "lstm_us_per_step.encodec", "conv_roofline.encodec",
        "rvq_roofline.encodec", "mfu.encodec"]
    assert {m["name"] for m in man.end_to_end(CELL)} == {"encode_rtf", "setup_s"}
    cfg = man.config("encodec-24k-8cb")
    assert cfg["reduced"] == [] and cfg["run"]["num_codebooks"] == 8
    assert man.traffic("web-speech-encodec")["driver"] == "encodec_engine"


# facebook/encodec_24khz's config.json, its shape keys (transformers 4.57's
# EncodecConfig() defaults, codebook_dim resolved to hidden_size)
CHECKPOINT = dict(
    target_bandwidths=[1.5, 3.0, 6.0, 12.0, 24.0], sampling_rate=24000, audio_channels=1,
    normalize=False, chunk_length_s=None, overlap=None, hidden_size=128, num_filters=32,
    num_residual_layers=1, upsampling_ratios=[8, 5, 4, 2], norm_type="weight_norm", kernel_size=7,
    last_kernel_size=7, residual_kernel_size=3, dilation_growth_rate=2, use_causal_conv=True,
    pad_mode="reflect", compress=2, num_lstm_layers=2, trim_right_ratio=1.0, codebook_size=1024,
    codebook_dim=128, use_conv_shortcut=True,
)


def test_the_config_is_the_checkpoint_s():
    shape = {k: v for k, v in CFG.items() if k not in ("source", "model_type", "run", "reduced")}
    assert shape == CHECKPOINT
    assert CFG["source"] == "https://huggingface.co/facebook/encodec_24khz"
    assert encodec_weights.books(CFG) == 32


@pytest.mark.parametrize("seconds", [0.0003, 0.001, 0.37, 1.0])
def test_reference_matches_transformers(seconds):
    transformers = pytest.importorskip("transformers")
    cfg = dict(CFG, **TINY)
    hf = transformers.EncodecModel(transformers.EncodecConfig(**TINY)).eval()
    sd = encodec_weights.state_dict(cfg, 77, CPU)
    _, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected
    n = max(1, int(seconds * SECOND))
    audio = torch.from_numpy((np.random.default_rng(3).standard_normal(n) * 0.2).astype(np.float32))
    with torch.no_grad():
        want = hf.encode(audio[None, None], bandwidth=216.0).audio_codes[0, 0]
    emb = encodec_ref.embeddings(sd, cfg, audio)
    assert emb.shape == (16, encodec_flops.frames(cfg, n))
    # transformers' codes are the reference's nearest codewords, to rounding
    assert float(encodec_ref.code_gaps(sd, cfg, emb, want).max()) < 1e-5


def test_reference_matches_the_program_on_the_cpu():
    from tokenize_audio_tpu_torch.encodec.weights import convert_hf_state_dict
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine

    sys.path.insert(0, os.path.join(BENCH, "drivers"))
    import encodec_engine

    cfg = dict(CFG, **TINY)
    sd = encodec_weights.state_dict(cfg, 1234, CPU)
    ecfg = encodec_engine.encodec_config(cfg, cfg["run"])
    engine = MimiEncoderEngine(convert_hf_state_dict(sd, ecfg), ecfg, num_codebooks=12, device="cpu")
    rng = np.random.default_rng(5)
    audios = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (3, 500, 9999, 24_001)]
    for a, got in zip(audios, engine.encode_batch(audios)):
        assert got.shape == (12, encodec_flops.frames(cfg, len(a)))
        emb = encodec_ref.embeddings(sd, cfg, torch.from_numpy(a).float() / 32768.0)
        assert float(encodec_ref.code_gaps(sd, cfg, emb, torch.from_numpy(got)).max()) < 1e-5


def test_code_gaps_read_a_wrong_code():
    cfg = dict(CFG, **TINY)
    sd = encodec_weights.state_dict(cfg, 5, CPU)
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(2400) * 0.3).astype(np.float32))
    emb = encodec_ref.embeddings(sd, cfg, x)
    e = encodec_ref.codebooks(sd, 4).double()
    r, codes = emb.T.double(), []
    for book in e:
        c = ((r[:, None, :] - book[None]) ** 2).sum(-1).argmin(dim=1)
        codes.append(c)
        r = r - book[c]
    codes = torch.stack(codes)
    assert float(encodec_ref.code_gaps(sd, cfg, emb, codes).max()) == 0.0
    codes[2, 7] = (codes[2, 7] + 1) % 64
    gaps = encodec_ref.code_gaps(sd, cfg, emb, codes)
    assert float(gaps[:2].max()) == 0.0 and float(gaps[2]) > 1e-3


@pytest.mark.parametrize("part,want", [
    ("seanet", 2.28e9), ("lstm", 0.63e9), ("project", 0.069e9), ("rvq", 0.157e9)])
def test_operations_per_audio_second(part, want):
    t = encodec_flops.frames(CFG, SECOND)
    assert t == 75
    got = {"seanet": encodec_flops.seanet_flops(CFG, SECOND),
           "lstm": encodec_flops.lstm_flops(CFG, t),
           "project": encodec_flops.project_flops(CFG, t),
           "rvq": encodec_flops.rvq_flops(CFG, t, 8)}[part]
    assert got == pytest.approx(want, rel=5e-3)


def test_hand_count_of_the_seanet_and_the_whole():
    # input conv, then per stage (C, s, L): k3 + k1 + k1 shortcut at L, strided conv at L / s
    total = 2.0 * 32 * 7 * SECOND
    c, n = 32, SECOND
    for s in (2, 4, 5, 8):
        total += 2.0 * n * (c // 2 * c * 3 + c * c // 2 + c * c)
        n = -(-n // s)
        total += 2.0 * 2 * c * c * 2 * s * n
        c *= 2
    assert encodec_flops.seanet_flops(CFG, SECOND) == total
    assert encodec_flops.lstm_flops(CFG, 75) == 2 * 75 * 2.0 * 4 * 512 * 1024
    assert encodec_flops.per_audio_second(CFG, 8) == pytest.approx(3.14e9, rel=5e-3)


@pytest.mark.parametrize("trace", [False, True])
def test_last_line(trace, tmp_path):
    man, _, _, _, _ = tiny_inputs()
    run, result, line = run_tiny(tmp_path, trace=trace)
    assert run.error is None
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    json.dumps(line)
    want = {m["name"] for m in (man.per_layer(CELL) if trace else man.end_to_end(CELL))}
    # the CPU has no peak and no device trace: those readings are left out
    device_only = {"lstm_roofline.encodec", "lstm_us_per_step.encodec", "conv_roofline.encodec",
                   "rvq_roofline.encodec", "mfu.encodec"}
    assert want - device_only <= set(line["metrics"]) <= want
    assert line["checks"]["code_gap_max"]["value"] < 1e-5
    if trace:
        notes = run.encodec_notes
        assert len(notes["seanet_encode"]) == len(notes["rvq_encode"]) > 0
        # the program's counter, over the traced segment: each call's padded
        # frames times the LSTM's layers
        spf = math.prod(run.cfg["upsampling_ratios"])
        frames = sum(t // spf for _, t, _ in notes["seanet_encode"])
        assert run.traced_lstm_steps == run.cfg["num_lstm_layers"] * frames > 0


def test_an_altered_code_is_not_correct(tmp_path, monkeypatch):
    from tokenize_audio_tpu_torch.encodec import model

    inner = model.rvq_encode

    def altered(params, x, k):
        codes = inner(params, x, k).clone()
        codes[:, -1, 0] = (codes[:, -1, 0] + 1) % params["embed"].shape[1]
        return codes

    monkeypatch.setattr(model, "rvq_encode", altered)
    _, _, line = run_tiny(tmp_path, seconds=0.1)
    gap = line["checks"]["code_gap_max"]
    assert line["correct"] is False and gap["value"] > gap["limit"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import test_bench_encodec as t\n"
        "import pathlib\n"
        "run, result, line = t.run_tiny(pathlib.Path(%r), seconds=0.1)\n"
        "from pbkit import runner\n"
        "print(line['correct'], runner.forbidden_modules())\n"
    ) % (os.path.join(BENCH, "tests"), BENCH, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"


def test_on_the_card_sound_is_correct_and_tf32_is_not(tmp_path, cuda):  # noqa: F811
    """The published widths on the card, a short window of tiny traffic:
    the control (the model's hold switched to TF32) has to fail the check."""
    man, cell, _, mix, params = tiny_inputs()
    cfg = man.config(cell.config)
    for mode, want in (({}, True), ({"matmul_precision": "high"}, False)):
        run = runner.Run(cell.name, cfg, mix, params, 2**31 + 99, 0.5, cuda, str(tmp_path), mode)
        result = runner.execute(run, runner.driver(mix["driver"]), False, 0.0)
        assert result["correct"] is want, result["checks"]
