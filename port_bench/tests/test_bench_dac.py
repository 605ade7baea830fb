"""The DAC cell, ``engine-web.dac-44k-9cb``: its entries in the manifest,
its configuration against transformers' ``DacConfig``, the frozen
operation counts against a hand count at the published widths, the plain
reference against transformers' ``DacModel`` and as a file that imports
nothing of the program, whole runs at a tiny size on the CPU, and a run in
a fresh process loading no JAX."""

import ast
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from bench_testkit import BENCH, ROOT, cuda  # noqa: F401
from pbkit import dac_flops, manifest, runner
from reference import dac_ref, dac_weights

CELL = "engine-web.dac-44k-9cb"
CPU = torch.device("cpu")
# two blocks (8 samples a frame), 4 channels, 3 books of 32 x 4
TINY = dict(encoder_hidden_size=4, downsampling_ratios=[2, 4], upsampling_ratios=[4, 2],
            hidden_size=16, hop_length=8, n_codebooks=3, codebook_size=32, codebook_dim=4)
CFG = json.load(open(os.path.join(BENCH, "configs", "dac-44k-9cb.json")))
SECOND = 44_100
LAYER_METRICS = ["conv_roofline.dac", "rvq_roofline.dac", "snake_ms_per_call.dac", "mfu.dac"]


def tiny_inputs():
    man = manifest.Manifest(ROOT)
    cell = man.cell(CELL)
    cfg = man.config(cell.config)
    cfg.update(TINY)
    cfg["run"]["num_codebooks"] = 3
    mix = man.traffic(cell.traffic)
    mix["utterances"] = 6
    mix["lengths"]["max"] = 2.0
    params = man.cell_params(cell.name)
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
    assert [m["name"] for m in man.per_layer(CELL)] == LAYER_METRICS
    assert {m["name"] for m in man.end_to_end(CELL)} == {"encode_rtf", "setup_s"}
    cfg = man.config("dac-44k-9cb")
    assert cfg["reduced"] == [] and cfg["run"]["num_codebooks"] == 9
    assert cfg["source"] == "https://huggingface.co/descript/dac_44khz"
    mix = man.traffic("web-speech-44k")
    assert (mix["driver"], mix["sample_rate"], mix["utterances"]) == ("dac_engine", 44_100, 256)
    params = man.cell_params(CELL)
    assert params["engine"]["samples_per_batch"] == 192 * SECOND
    assert (params["engine"]["code_transfer_format"], params["engine"]["code_transfer_dtype"]) == (
        "padded", "uint16")


def test_the_config_is_transformers_defaults_at_44_1_khz():
    transformers = pytest.importorskip("transformers")
    hf = transformers.DacConfig(sampling_rate=44_100).to_dict()
    shape = {k: v for k, v in CFG.items() if k not in ("source", "model_type", "run", "reduced",
                                                       "assumed")}
    assert set(shape) <= set(hf)
    assert {k: hf[k] for k in shape} == shape
    # every shape key transformers' configuration has is in the file
    drop = set(transformers.PretrainedConfig().to_dict()) | {"model_type", "transformers_version"}
    assert set(hf) - drop == set(shape)
    assert CFG["sampling_rate"] == 44_100 and transformers.DacConfig().sampling_rate == 16_000


def test_operations_per_sample_at_the_published_widths():
    n = 512 * 100
    assert dac_flops.encoder_flops(CFG, n) == 1_389_440 * n
    assert dac_flops.rvq_flops(CFG, dac_flops.frames(CFG, n), 9) == 864 * n
    # 61.3 GFLOP an audio second at 44.1 kHz (a second alone pads to 87 frames)
    assert dac_flops.per_audio_second(CFG, 9, seconds=100.0) == pytest.approx(61.3e9, rel=2e-3)
    # a row is counted at whole frames, as DAC pads it
    assert dac_flops.model_flops(CFG, n + 1, 9) == dac_flops.model_flops(CFG, n + 512, 9)


def test_hand_count_of_the_encoder():
    # the input conv, then per block (C, s) at L columns: three units of a
    # k7 and a k1 conv, C to C, and the strided conv to 2C at L / s
    n = 512
    total = 2.0 * 64 * 7 * n
    c, length = 64, n
    for s in (2, 4, 8, 8):
        total += 3 * 2.0 * length * (c * c * 7 + c * c)
        length //= s
        total += 2.0 * length * 2 * c * c * 2 * s
        c *= 2
    total += 2.0 * length * 1024 * 1024 * 3
    assert dac_flops.encoder_flops(CFG, n) == total
    assert dac_flops.rvq_flops(CFG, 1, 9) == 9 * 2.0 * (1024 * 8 * 2 + 8 * 1024)


@pytest.mark.parametrize("n", [8, 80, 1001])
def test_reference_matches_transformers(n):
    transformers = pytest.importorskip("transformers")
    cfg = dict(CFG, **TINY)
    hf_cfg = {k: v for k, v in TINY.items() if k not in ("upsampling_ratios", "hidden_size", "hop_length")}
    hf = transformers.DacModel(transformers.DacConfig(**hf_cfg)).eval()
    hf.apply_weight_norm()
    legacy = {k.replace("parametrizations.weight.original0", "weight_g")
              .replace("parametrizations.weight.original1", "weight_v"): v
              for k, v in hf.state_dict().items()}
    sd = dac_weights.state_dict(cfg, 77, CPU)
    assert set(sd) <= set(legacy)
    hf.load_state_dict({k.replace("weight_g", "parametrizations.weight.original0")
                        .replace("weight_v", "parametrizations.weight.original1"): v
                        for k, v in sd.items()}, strict=False)
    audio = torch.from_numpy((np.random.default_rng(3).standard_normal(n) * 0.3).astype(np.float32))
    padded = torch.nn.functional.pad(audio, (0, -n % 8))
    with torch.no_grad():
        want = hf.encode(padded[None, None]).audio_codes[0]
    emb = dac_ref.embeddings(sd, cfg, audio)
    assert emb.shape == (16, dac_flops.frames(cfg, n))
    # transformers' codes are the reference's best codewords, to rounding
    assert float(dac_ref.code_gaps(sd, cfg, emb, want).max()) < 1e-5


def test_the_reference_imports_nothing_of_the_program():
    for name in ("dac_ref.py", "dac_weights.py"):
        tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
        assert not any(m.split(".")[0] in ("tokenize_audio_tpu_torch", "jax") for m in mods), (name, mods)


def test_the_reference_runs_with_tf32_off(monkeypatch):
    """Every conv of the reference sees both TF32 switches off, whatever
    they were before, and they are restored after."""
    seen = []
    conv = torch.nn.functional.conv1d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return conv(*args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    cfg = dict(CFG, **TINY)
    dac_ref.embeddings(dac_weights.state_dict(cfg, 3, CPU), cfg, torch.zeros(100))
    assert len(seen) == 1 + 2 * (3 * 2 + 1) + 1 and not any(any(s) for s in seen)
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_code_gaps_read_a_wrong_code():
    cfg = dict(CFG, **TINY)
    sd = dac_weights.state_dict(cfg, 5, CPU)
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(2400) * 0.3).astype(np.float32))
    emb = dac_ref.embeddings(sd, cfg, x)
    r, codes = emb.double(), []
    for k in range(3):
        p = f"quantizer.quantizers.{k}"
        w_in = dac_ref.weight(sd, f"{p}.in_proj").double()[:, :, 0]
        w_out = dac_ref.weight(sd, f"{p}.out_proj").double()[:, :, 0]
        book = sd[f"{p}.codebook.weight"].double()
        e = torch.nn.functional.normalize((w_in @ r + sd[f"{p}.in_proj.bias"].double()[:, None]).T)
        c = (e @ torch.nn.functional.normalize(book).T).argmax(dim=1)
        codes.append(c)
        r = r - (w_out @ book[c].T + sd[f"{p}.out_proj.bias"].double()[:, None])
    codes = torch.stack(codes)
    assert float(dac_ref.code_gaps(sd, cfg, emb, codes).max()) < 1e-12
    codes[2, 7] = (codes[2, 7] + 1) % 32
    gaps = dac_ref.code_gaps(sd, cfg, emb, codes)
    assert float(gaps[:2].max()) < 1e-12 and float(gaps[2]) > 1e-3


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
    assert want - set(LAYER_METRICS) <= set(line["metrics"]) <= want
    assert line["checks"]["code_gap_max"]["value"] < 1e-6
    if trace:
        # a traced call's Snakes: 15 a batch at two blocks, each in a range,
        # and the program's counter agrees
        batches = len(run.dac_notes["encoder"])
        calls = dict(run.trace["range_calls"])
        assert batches > 0 and calls["port_bench::dac.encoder"] == batches
        assert calls["port_bench::dac.snake"] == run.traced_snakes == 15 * batches
        assert calls["port_bench::dac.rvq"] == batches


def test_an_altered_code_is_not_correct(tmp_path, monkeypatch):
    from tokenize_audio_tpu_torch.dac import model

    inner = model.rvq_encode

    def altered(books, x, k):
        codes = inner(books, x, k).clone()
        codes[:, -1, 0] = (codes[:, -1, 0] + 1) % books[0]["codebook"].shape[0]
        return codes

    monkeypatch.setattr(model, "rvq_encode", altered)
    _, _, line = run_tiny(tmp_path, seconds=0.1)
    gap = line["checks"]["code_gap_max"]
    assert line["correct"] is False and gap["value"] > gap["limit"]


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import test_bench_dac as t\n"
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
