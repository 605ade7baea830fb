"""The general traffic generator: the same inputs for a seed, other inputs
for another seed, the same sizes for every seed."""

import json

import numpy as np
import pytest
import torch

from bench_testkit import tiny_inputs
from pbkit import traffic

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["engine-web.8cb", "engine-chunks.32cb"])
def test_engine_sets_repeat_for_a_seed_and_differ_across_seeds(cell):
    _, _, _, mix, _ = tiny_inputs(cell)
    a = traffic.engine_sets(mix, 2**31 + 11, CPU)
    b = traffic.engine_sets(mix, 2**31 + 11, CPU)
    c = traffic.engine_sets(mix, 12, CPU)
    assert len(a) == mix["distinct_sets"]
    for sa, sb in zip(a, b):
        assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    by_len = lambda s: sorted(s, key=len)
    assert not all(np.array_equal(x, y) for x, y in zip(by_len(a[0]), by_len(c[0])))
    sizes = sorted(len(x) for x in a[0])
    for s in a + c:
        assert sorted(len(x) for x in s) == sizes
        assert all(x.dtype == np.int16 for x in s)


def test_engine_lengths_follow_the_mix():
    _, _, _, mix, _ = tiny_inputs("engine-web.8cb")
    mix = dict(mix, utterances=4000)
    s = traffic.lengths(mix["lengths"], 4000, 0)
    assert s.min() >= 0.8 and s.max() <= 4.0
    full = traffic.lengths({"dist": "lognormal", "mean": 1.9, "sigma": 0.8, "min": 0.8, "max": 59.0}, 4000, 0)
    assert abs(np.median(full) - np.exp(1.9)) < 0.5


def test_mirror_repeats_for_a_seed_and_keeps_its_sizes(tmp_path):
    _, _, _, mix, _ = tiny_inputs("yodas2-shard.32cb")
    m1 = traffic.build_mirror(str(tmp_path / "a"), mix, 5, CPU)
    m2 = traffic.build_mirror(str(tmp_path / "b"), mix, 5, CPU)
    m3 = traffic.build_mirror(str(tmp_path / "c"), mix, 6, CPU)
    assert m1["layout"] == m2["layout"]
    assert all(np.array_equal(m1["audio"][k], m2["audio"][k]) for k in m1["audio"])
    assert any(not np.array_equal(m1["audio"][k], m3["audio"][k]) for k in m1["audio"])
    for s1, s3 in zip(m1["layout"], m3["layout"]):
        assert sorted(len(f["chunks"]) for f in s1) == sorted(len(f["chunks"]) for f in s3)
        assert [f["rate"] for f in s1] == [f["rate"] for f in s3]
    files = [f for s in m1["layout"] for f in s]
    assert {f["rate"] for f in files} == {24000, 16000}
    meta = json.load(open(tmp_path / "a" / mix["shard_id"] / "00000000.json"))
    assert [e["audio_id"] for e in meta] == [f["audio_id"] for f in m1["layout"][0]]


def test_mirror_wav_is_read_back_by_the_program(tmp_path):
    from tokenize_audio_tpu_torch.io.wav import read_wav

    x = (np.arange(-500, 500) * 31).astype(np.int16)
    path = tmp_path / "x.wav"
    path.write_bytes(traffic.wav_bytes(x, 16000))
    got, sr = read_wav(str(path), raw_int16=True)
    assert sr == 16000 and np.array_equal(got, x)
