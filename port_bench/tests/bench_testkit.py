"""Shared helpers of the benchmark's tests: a cell run on the CPU at a tiny
Mimi (the repository tests' tiny widths) and tiny traffic, skipping the
harness's look for a chip."""

from __future__ import annotations

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402
import torch  # noqa: E402

from pbkit import manifest, runner  # noqa: E402

TINY = dict(
    num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
    codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
    upsample_groups=32,
)


# cells whose files are in the benchmark but which BENCHMARK.json does not
# run (PERF.md, Open questions): (config, traffic, end-to-end and per-layer
# metrics)
READY = {
    "yodas2-shard.32cb": ("mimi-32cb", "yodas2-mirror", ["shard_rtf", "setup_s"],
                          ["processor_host_ms.shard", "mfu.shard", "device_idle.shard"]),
}


def tiny_inputs(cell_name: str):
    """(manifest, cell, config, mix, params) of a cell cut to the tiny
    model and a few seconds of traffic."""
    man = manifest.Manifest(ROOT)
    if cell_name in READY:
        cell = manifest.Cell(cell_name, READY[cell_name][0], READY[cell_name][1], 1)
    else:
        cell = man.cell(cell_name)
    cfg = man.config(cell.config)
    cfg.update(TINY)
    cfg["run"]["num_codebooks"] = min(cfg["run"]["num_codebooks"], TINY["num_quantizers"])
    mix = man.traffic(cell.traffic)
    if mix["driver"] == "engine":
        mix["utterances"] = 6
        mix["lengths"]["max"] = min(mix["lengths"]["max"], 400 if mix["lengths"]["unit"] == "cs" else 4.0)
    else:
        mix.update(subshards=2, files_per_subshard=2, file_seconds=8.0)
    params = man.cell_params(cell.name)
    params["trace_units"] = 1
    params["check"]["sample"] = 6
    return man, cell, cfg, mix, params


def run_tiny(cell_name: str, tmp_path, seed: int = 2**31 + 7, trace: bool = False,
             mode=None, seconds: float = 0.5, device: str = "cpu"):
    """One run of the cell at the tiny size: (run, result, last line)."""
    man, cell, cfg, mix, params = tiny_inputs(cell_name)
    run = runner.Run(cell.name, cfg, mix, params, seed, seconds, torch.device(device),
                     str(tmp_path), mode)
    result = runner.execute(run, runner.driver(mix["driver"]), trace, time.perf_counter())
    return run, result, runner.result_line(man, run, result, trace)


@pytest.fixture
def cuda():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
