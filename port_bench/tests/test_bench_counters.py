"""Readers of the program's counters: ``tfm_graph_share.encode`` is the
window's transformer graph replays over its batches, and reads nothing
where the program counts no batches, keeps no such counter (a program
without graphs), or runs off CUDA."""

from types import SimpleNamespace

import pytest
import torch

import bench_testkit  # noqa: F401  (puts the benchmark on the path)

from pbkit import runner

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")


def stats(**kw):
    return SimpleNamespace(**kw)


@pytest.mark.parametrize("device,counters,want", [
    (CUDA, stats(batches=40, transformer_graph_replays=40), 1.0),
    (CUDA, stats(batches=40, transformer_graph_replays=30), 0.75),
    (CUDA, stats(batches=40, transformer_graph_replays=0), 0.0),
    (CUDA, stats(batches=0, transformer_graph_replays=0), None),
    (CUDA, stats(batches=40), None),
    (CUDA, None, None),
    (CPU, stats(batches=40, transformer_graph_replays=0), None),
])
def test_tfm_graph_share_reads_replays_over_batches(device, counters, want):
    run = SimpleNamespace(stats=counters, device=device)
    assert runner.reader("tfm_graph_share.encode").read(run) == want
