"""PyTorch port, the transformer stack's CUDA graphs (``mimi/graphs.py``):
off the card a cache changes nothing; the cache's policy (eager and then
captured at a key's first sight, replayed from its second, one key per
shape, dtype and matmul precision; never under a tensor-parallel group or
with a gradient), driven on the CPU through a stand-in capture; the
engine's two counters; and on the card, the engine's codes with graphs
bitwise equal to its codes without. The file imports no JAX, so the
card's case runs with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_graphs.py

where ``test_engine_codes_with_graphs_equal_eager_on_the_card`` asks for
the ``cuda`` fixture, which skips it without a CUDA device."""

import gc
import weakref

import numpy as np
import pytest
import torch

from tokenize_audio_tpu_torch.config import EngineConfig, fp32_precision
from tokenize_audio_tpu_torch.core.audio import bucket_for_length
from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
from tokenize_audio_tpu_torch.engine import encoder as enc_mod
from tokenize_audio_tpu_torch.mimi import MimiConfig, params_to_torch, random_params
from tokenize_audio_tpu_torch.mimi.graphs import TransformerGraphs
from tokenize_audio_tpu_torch.mimi.model import transformer_apply

TINY = MimiConfig(
    num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
    codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
    upsample_groups=32,
)
KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=4.0)
LENGTHS = [1000, 5000, 19200, 26000, 7777, 600, 3333, 4800]


@pytest.fixture(scope="module")
def params():
    return random_params(TINY, seed=0)


@pytest.fixture(scope="module")
def tfm(params):
    return params_to_torch(params, "cpu")["tfm"]


@pytest.fixture(autouse=True)
def no_grad():
    """Every call as ``encode`` makes it, with no gradient recorded."""
    with torch.no_grad():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def hidden(rows, frames, seed=0, dtype=torch.float32):
    """A (rows, frames, C) transformer input laid out as the encoder hands
    it over: the transpose of a (rows, C, frames) conv output."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(rows, TINY.hidden_size, frames, generator=g).to(dtype).transpose(1, 2)


class StandIn:
    """A capture that records its calls and whose replay runs the captured
    body on the static input into the static output, as a graph does."""

    def __init__(self):
        self.captured = []

    def __call__(self, body, static_in):
        self.captured.append((tuple(static_in.shape), static_in.dtype))
        static_out = torch.empty_like(body(torch.zeros_like(static_in)))
        return (lambda: static_out.copy_(body(static_in))), static_out


def counting(events):
    return lambda kind: events.append(kind)


@pytest.mark.parametrize("device", ["cpu", "cuda:0"])
def test_a_cache_off_the_card_changes_nothing(tfm, device):
    events = []
    graphs = TransformerGraphs(device, on_event=counting(events))
    for seed in (0, 1, 1):
        h = hidden(2, 9, seed)
        want = transformer_apply(tfm, TINY, h)
        got = transformer_apply(tfm, TINY, h, graphs=graphs)
        assert torch.equal(got, want)
    assert events == [] and not graphs.engages(h, None)


def test_eager_and_captured_at_first_sight_replayed_after(tfm):
    events, capture = [], StandIn()
    graphs = TransformerGraphs("cpu", on_event=counting(events), capture=capture)
    h0, h1 = hidden(2, 9, 0), hidden(2, 9, 1)
    first = transformer_apply(tfm, TINY, h0, graphs=graphs)
    assert events == ["capture"] and capture.captured == [((2, 9, 32), torch.float32)]
    assert torch.equal(first, transformer_apply(tfm, TINY, h0))
    second = transformer_apply(tfm, TINY, h1, graphs=graphs)
    third = transformer_apply(tfm, TINY, h0, graphs=graphs)
    assert events == ["capture", "replay", "replay"] and len(capture.captured) == 1
    # each replay's result is the input's and a copy: a later replay of
    # the same shape leaves an earlier result as it was
    assert torch.equal(second, transformer_apply(tfm, TINY, h1))
    assert torch.equal(third, first)


def test_every_shape_dtype_and_precision_is_its_own_key():
    events, capture = [], StandIn()
    graphs = TransformerGraphs("cpu", on_event=counting(events), capture=capture)
    body = lambda x: x * 2.0 + 1.0  # noqa: E731
    keys = [hidden(2, 9), hidden(3, 9), hidden(2, 10), hidden(2, 9, dtype=torch.bfloat16)]
    for h in keys:
        graphs(body, h)
    with fp32_precision("tf32"):
        graphs(body, keys[0])
    assert events == ["capture"] * 5 and len(capture.captured) == 5
    for h in keys:
        assert torch.equal(graphs(body, h), body(h))
    with fp32_precision("tf32"):
        graphs(body, keys[0])
    assert events == ["capture"] * 5 + ["replay"] * 5 and len(capture.captured) == 5


def test_a_group_or_a_gradient_is_always_eager(tfm):
    events, capture = [], StandIn()
    graphs = TransformerGraphs("cpu", on_event=counting(events), capture=capture)
    h = hidden(2, 9)
    assert graphs.engages(h, None)
    assert not graphs.engages(h, object())  # a mesh's model group sums inside
    with torch.enable_grad():
        assert not graphs.engages(h, None)
        for _ in range(2):
            assert torch.equal(transformer_apply(tfm, TINY, h, graphs=graphs),
                               transformer_apply(tfm, TINY, h))
    assert events == [] and capture.captured == []


def test_engine_stats_count_and_reset_the_graph_counters(params):
    eng = MimiEncoderEngine(params, TINY, EngineConfig(**KW), num_codebooks=4, device="cpu")
    assert eng._graphs is None  # no graphs off the card
    eng._count_graph("capture")
    eng._count_graph("replay")
    eng._count_graph("replay")
    got = eng.stats.as_dict()
    assert (got["transformer_graph_captures"], got["transformer_graph_replays"]) == (1, 2)
    eng.stats = EngineStats()  # the counters start over with the stats
    eng._count_graph("replay")
    assert (eng.stats.transformer_graph_captures, eng.stats.transformer_graph_replays) == (0, 1)
    fresh = EngineStats().as_dict()
    assert fresh["transformer_graph_captures"] == fresh["transformer_graph_replays"] == 0


def test_a_dropped_engine_is_freed_with_its_graphs(params):
    """The cache counts into its engine without keeping it alive: dropping
    the engine frees it, its params and its graphs at once, with no wait
    for the cycle collector."""
    eng = MimiEncoderEngine(params, TINY, EngineConfig(**KW), num_codebooks=4, device="cpu")
    eng.device = torch.device("cuda", 0)  # a cache is built, and never captures here
    eng._graphs = eng._new_graphs()
    eng.device = torch.device("cpu")
    assert eng._graphs is not None
    eng._graphs._on_event("replay")
    assert eng.stats.transformer_graph_replays == 1
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def plan_shapes(eng, lengths):
    """(batches, distinct batch shapes) of the engine's plan of ``lengths``
    (24 kHz, none over the cap)."""
    by_bucket = {}
    for n in lengths:
        b = bucket_for_length(n, eng.buckets)
        by_bucket[b] = by_bucket.get(b, 0) + 1
    batches, shapes = 0, set()
    for b, n in by_bucket.items():
        full = eng.engine_cfg.batch_size_for_bucket(b)
        for s in range(0, n, full):
            shapes.add((b, eng.engine_cfg.batch_size_for_group(b, min(full, n - s))))
            batches += 1
    return batches, len(shapes)


def test_engine_passes_its_cache_and_counts_what_it_did(params):
    rng = np.random.default_rng(3)
    audios = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in LENGTHS]
    want = MimiEncoderEngine(params, TINY, EngineConfig(**KW), num_codebooks=4,
                             pipeline_depth=3, device="cpu").encode_batch(audios)
    eng = MimiEncoderEngine(params, TINY, EngineConfig(**KW), num_codebooks=4,
                            pipeline_depth=3, device="cpu")
    capture = StandIn()
    eng._graphs = TransformerGraphs("cpu", on_event=eng._count_graph, capture=capture)
    batches, shapes = plan_shapes(eng, LENGTHS)
    for call in range(2):
        eng.stats = EngineStats()
        got = eng.encode_batch(audios)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        s = eng.stats
        assert s.batches == batches
        assert s.transformer_graph_captures == (shapes if call == 0 else 0)
        assert s.transformer_graph_replays == batches - s.transformer_graph_captures
    assert len(capture.captured) == shapes


def test_a_transient_fault_starts_the_graphs_afresh(params, monkeypatch):
    eng = MimiEncoderEngine(params, TINY, EngineConfig(**KW), num_codebooks=4, device="cpu")
    old = eng._graphs = TransformerGraphs("cpu", capture=StandIn())
    real, fails = enc_mod.mimi_encode, {"n": 1}

    def flaky(*a, **k):
        if fails["n"]:
            fails["n"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(*a, **k)

    monkeypatch.setattr(enc_mod, "mimi_encode", flaky)
    eng.encode_batch([np.zeros(4000, np.float32)])
    assert eng.stats.transient_retries == 1 and eng._graphs is not old


def test_engine_codes_with_graphs_equal_eager_on_the_card(cuda):
    """The published widths on the card, a chunks-like mix at batch 4:
    eight utterances of one bucket (two full batches of one shape in flight
    at once, the second replaying the first's graph), four of another, and
    a tail batch of three rows in a third.
    Codes with graphs, at their capture and at their replays, bitwise equal
    the same engine's with no cache."""
    cfg = MimiConfig()
    eng = MimiEncoderEngine(random_params(cfg, seed=0), cfg,
                            EngineConfig(batch_size=4, min_bucket_seconds=1.0,
                                         bucket_growth=1.15),
                            num_codebooks=32, device=cuda)
    assert eng._graphs is not None
    rng = np.random.default_rng(5)
    # 1.52, 3.06 and 5.35 s buckets (1 s growing by 1.15), every length inside
    tops = [eng.buckets[i] for i in (3, 8, 12)]
    lengths = [n - int(rng.integers(0, 2400)) for n, k in zip(tops, (8, 4, 3)) for _ in range(k)]
    audios = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in lengths]
    batches, shapes = plan_shapes(eng, [len(a) for a in audios])
    assert (batches, shapes) == (4, 3)
    graphs = eng._graphs
    eng._graphs = None
    want = eng.encode_batch(audios)
    eng._graphs = graphs
    for call in range(2):
        eng.stats = EngineStats()
        got = eng.encode_batch(audios)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        s = eng.stats
        assert s.transformer_graph_captures == (shapes if call == 0 else 0)
        assert s.transformer_graph_replays == batches - s.transformer_graph_captures
