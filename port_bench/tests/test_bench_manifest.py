"""BENCHMARK.json against the benchmark's contract, and the manifest's
own checks against broken copies of it."""

import copy
import json
import os

import pytest

from bench_testkit import ROOT
from pbkit import manifest


@pytest.fixture
def raw():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_the_benchmark_is_sound(raw):
    assert manifest.problems(raw, ROOT) == []


def test_the_benchmark_fits_its_file_limits(raw):
    text = open(os.path.join(ROOT, "BENCHMARK.json")).read()
    assert len(text.encode()) <= 64 * 1024
    assert 1 <= raw["run_seconds"] <= 51 and isinstance(raw["run_seconds"], int)
    assert raw["command"][:2] == ["python3", "port_bench/run.py"]
    assert all(not p.startswith("/") and ".." not in p for p in raw["paths"])
    cells = len(raw["workloads"])
    # a full check: 2 + 14 runs a cell at run_seconds + 60, 180 s of compile
    # a cell, 1200 s spare, within 43200 s for the full 24 cells
    assert (2 + 14 * 24) * (raw["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("name,ok", [
    ("engine-web.8cb", True), ("mfu.encode", True), ("_x", True), ("9a", True),
    ("a b", False), ("a,b", False), ("a/b", False), ("", False), ("é", False), ("a" * 65, False),
])
def test_name_characters(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("audio_s/s", True), ("%", True), ("ms/batch", True), ("ratio", True),
    ("tokens per second", False), ("us", True), ("µs", False), ("a" * 17, False),
])
def test_unit_characters(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_a_metric_in_a_cell_that_lacks_what_it_moves_is_refused(raw):
    bad = copy.deepcopy(raw)
    metric = next(m for m in bad["end_to_end"] if m["name"] == "encode_rtf")
    metric["workloads"] = ["engine-web.8cb"]
    assert any("cell engine-chunks.32cb does not report encode_rtf" in p
               for p in manifest.problems(bad, ROOT))


def test_too_many_four_chip_cells_are_refused(raw):
    bad = copy.deepcopy(raw)
    for w in bad["workloads"][:2]:
        w["chips"] = 4
    assert any("ask for 4 chips" in p for p in manifest.problems(bad, ROOT))


def test_a_metric_key_outside_the_contract_is_refused(raw):
    bad = copy.deepcopy(raw)
    bad["per_layer"][0]["why"] = "no such key"
    assert manifest.problems(bad, ROOT)


def test_every_cell_finds_its_files_by_name(raw):
    man = manifest.Manifest(ROOT, raw)
    for w in raw["workloads"]:
        cfg = man.config(w["config"])
        assert cfg["source"] == "https://huggingface.co/kyutai/mimi"
        assert man.traffic(w["traffic"])["driver"] in ("engine", "yodas2_shard")
        params = man.cell_params(w["name"])
        assert set(params["limits"]) == {"code_gap_max", "malformed", "missing"}
        for m in man.per_layer(w["name"]) + man.end_to_end(w["name"]):
            assert os.path.isfile(manifest.metric_path(m["name"]))


def test_configs_keep_the_published_widths(raw):
    man = manifest.Manifest(ROOT, raw)
    for c in raw["configs"]:
        cfg = man.config(c["name"])
        assert c["reduced"] == [] and cfg["reduced"] == []
        assert (cfg["hidden_size"], cfg["num_filters"], cfg["num_hidden_layers"]) == (512, 64, 8)
        assert (cfg["intermediate_size"], cfg["num_attention_heads"], cfg["head_dim"]) == (2048, 8, 64)
        assert (cfg["codebook_size"], cfg["codebook_dim"], cfg["num_quantizers"]) == (2048, 256, 32)
        assert cfg["upsampling_ratios"] == [8, 6, 5, 4]
        assert cfg["run"]["matmul_precision"] == "highest"
        assert cfg["run"]["compute_dtype"] == "float32"
