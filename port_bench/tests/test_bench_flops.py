"""The frozen operation and byte counts against the hand counts at the
published widths."""

import json
import os

import pytest

from bench_testkit import BENCH
from pbkit import flops, peaks

CFG = json.load(open(os.path.join(BENCH, "configs", "mimi-8cb.json")))
SECOND = 24_000


def test_seanet_per_audio_second():
    assert flops.seanet_flops(CFG, SECOND) == pytest.approx(4.032e9, rel=1e-3)


@pytest.mark.parametrize("stage,want", [(0, 1179.6e6), (1, 1179.6e6), (2, 943.7e6), (3, 629.1e6)])
def test_seanet_stages(stage, want):
    # a stage's work is the difference of two configs that stop after it
    def upto(k):
        cfg = dict(CFG, upsampling_ratios=list(reversed(list(reversed(CFG["upsampling_ratios"]))[:k])))
        return flops.seanet_flops(cfg, SECOND)

    before = upto(stage) - _out_conv(stage)
    after = upto(stage + 1) - _out_conv(stage + 1)
    assert after - before == pytest.approx(want, rel=1e-3)


def _out_conv(k):
    c = CFG["num_filters"] * 2 ** k
    n = SECOND
    for s in list(reversed(CFG["upsampling_ratios"]))[:k]:
        n = -(-n // s)
    return 2.0 * CFG["hidden_size"] * c * CFG["last_kernel_size"] * n


def test_input_and_output_convs():
    assert 2.0 * 64 * 7 * SECOND == pytest.approx(21.5e6, rel=1e-2)
    assert _out_conv(4) == pytest.approx(78.6e6, rel=1e-3)


def test_transformer_downsample_and_rvq():
    # linear work only: the attention term grows with the length
    per_frame_linear = 8 * (2.0 * 512 * 512 * 4 + 2.0 * 512 * 2048 * 2)
    assert per_frame_linear * 25 == pytest.approx(1.258e9, rel=1e-3)
    assert flops.downsample_flops(CFG, 25) == pytest.approx(2.0 * 512 * 512 * 4 * 13)
    assert flops.rvq_flops(CFG, 1, 1) - 2.0 * 512 * 256 == pytest.approx(1.05e6, rel=1e-2)


@pytest.mark.parametrize("books,want", [(8, 5.42e9), (32, 5.74e9)])
def test_whole_model_per_audio_second(books, want):
    # a 1 s row: the attention term, which grows with the length, is 0.1 %
    assert flops.per_audio_second(CFG, books) == pytest.approx(want, rel=0.005)


def test_attention_counts_the_causal_pairs():
    t = 1000
    linear = flops.transformer_flops(CFG, t) - flops.transformer_flops(dict(CFG, num_attention_heads=0, head_dim=0), t)
    assert linear == pytest.approx(8 * (2.0 * 512 * 512 * 4 * t + 2.0 * 2 * 64 * 8 * t * (t + 1) / 2), rel=1e-9)


def test_calls_are_bound_by_operations_at_the_path_s_sizes():
    pk = peaks.peak("NVIDIA H100 80GB HBM3")
    f, b = flops.seanet_call(CFG, [16 * 48_000] * 16)
    assert f / pk["fp32_flops"] > b / pk["hbm_bytes"]
    f, b = flops.rvq_call(CFG, [1920 * 10], 32)
    assert peaks.bound_seconds(f, b, pk) == pytest.approx(b / pk["hbm_bytes"])
