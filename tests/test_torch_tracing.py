"""PyTorch port, the program's own instruments at the tiny config: the
engine's batch counter and sub-stages in every drain and under retries,
the ``tokenize_audio::`` profiler ranges (entered only while a profiler
records, nested, once per batch, a batch's dispatch and collect linked by
its id),
the stream's timeline (intervals that overlap counted once; the host's
clock on the CPU) and the realtime window. The file imports no JAX, so the
card's case runs with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py

where ``test_stream_events_chain_the_batches_on_the_card`` asks for the
``cuda`` fixture, which skips it without a CUDA device."""

import json
import time
from collections import Counter, defaultdict

import numpy as np
import pytest
import torch

from tokenize_audio_tpu_torch import ranges
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.core.audio import bucket_for_length
from tokenize_audio_tpu_torch.engine import EngineStats, MimiEncoderEngine
from tokenize_audio_tpu_torch.engine import encoder as enc_mod
from tokenize_audio_tpu_torch.engine import metrics as metrics_mod
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params

TINY = MimiConfig(
    num_filters=8, hidden_size=32, num_hidden_layers=2, intermediate_size=64,
    num_attention_heads=4, num_key_value_heads=4, head_dim=8, codebook_size=64,
    codebook_dim=16, vector_quantization_hidden_dimension=16, num_quantizers=12,
    upsample_groups=32,
)
KW = dict(batch_size=2, min_bucket_seconds=0.25, max_chunk_seconds=4.0)
LENGTHS = [1000, 5000, 19200, 26000, 7777, 600, 3333]
MODEL_RANGES = ["mimi.seanet_encode", "mimi.transformer", "mimi.downsample",
                "mimi.split_rvq", "mimi.pack"]
# each range inside the one after it, once per batch
NESTING = {
    "pad": "engine.dispatch", "dispatch": "engine.dispatch",
    "dispatch.upload": "dispatch", "dispatch.launch": "dispatch",
    **{m: "dispatch.launch" for m in MODEL_RANGES},
    "fetch": "engine.collect", "fetch.wait": "fetch",
}


@pytest.fixture(scope="module")
def params():
    return random_params(TINY, seed=0)


@pytest.fixture(scope="module")
def audios():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in LENGTHS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def engine(params, device="cpu", masked=True, **kw):
    return MimiEncoderEngine(params, TINY, EngineConfig(**{**KW, **kw}), num_codebooks=4,
                             pipeline_depth=2, device=device, masked=masked)


def plan_batches(eng, lengths) -> int:
    """The device batches the engine's plan makes of ``lengths`` (24 kHz,
    none over the cap): by bucket, the bucket's batch size at a time."""
    per_bucket = Counter(bucket_for_length(n, eng.buckets) for n in lengths)
    return sum(-(-n // eng.engine_cfg.batch_size_for_bucket(b)) for b, n in per_bucket.items())


def flaky(real, fails):
    def call(*a, **k):
        if fails["n"]:
            fails["n"] -= 1
            raise torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return real(*a, **k)

    return call


@pytest.mark.parametrize("policy,fault,extra", [
    ("fifo", None, 0), ("ready", None, 0), ("threaded", None, 0),
    # a fault at collect re-dispatches the batch: the device runs it twice
    ("fifo", "collect", 1), ("threaded", "collect", 1),
    # a fault raised inside the dispatch's launch: the retry is its one launch
    ("fifo", "dispatch", 0),
])
def test_batches_and_sub_stages_in_every_drain(params, audios, policy, fault, extra,
                                              monkeypatch):
    eng = engine(params, drain_policy=policy)
    if fault == "collect":
        monkeypatch.setattr(eng, "_collect", flaky(eng._collect, {"n": 1}))
    elif fault == "dispatch":
        monkeypatch.setattr(enc_mod, "mimi_encode", flaky(enc_mod.mimi_encode, {"n": 1}))
    t0 = time.perf_counter()
    eng.encode_batch(audios)
    t1 = time.perf_counter()
    s = eng.stats
    assert s.transient_retries == (fault is not None)
    assert s.batches == plan_batches(eng, LENGTHS) + extra
    st = s.stage_seconds
    assert 0 < st["dispatch.upload"] + st["dispatch.launch"] <= st["dispatch"]
    assert 0 < st["fetch.wait"] <= st["fetch"]
    # the CPU's timeline is the host's clock: the batches' work, the host's
    # work between them, and no more than the call
    assert s.stream_seconds > 0 and s.stream_idle_seconds > 0
    assert s.stream_seconds + s.stream_idle_seconds <= t1 - t0
    if policy != "threaded":  # a fetch thread's re-dispatch overlaps the main thread's
        assert s.stream_seconds >= st["dispatch.launch"]
    d = s.as_dict()
    assert d["batches"] == s.batches and d["stream_seconds"] == round(s.stream_seconds, 3)
    assert {"stage_dispatch.upload", "stage_dispatch.launch", "stage_fetch.wait"} <= set(d)


def _ranges(trace_path):
    """The host events of a Chrome trace: the ``tokenize_audio::`` ones by
    name (without the prefix) -> list of (tid, start, end), and all of
    them as such a list."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    out, every = defaultdict(list), []
    for e in events:
        if e.get("ph") == "X":
            span = (e["tid"], e["ts"], e["ts"] + e["dur"])
            every.append(span)
            if e.get("name", "").startswith(ranges.PREFIX):
                out[e["name"][len(ranges.PREFIX):]].append(span)
    return out, every


def _inside(span, spans) -> bool:
    tid, a, b = span
    return any(t == tid and pa <= a and b <= pb for t, pa, pb in spans)


def test_profiler_ranges_nest_once_per_batch_linked_by_id(params, tmp_path):
    """Under ``torch.profiler`` every engine, stage and model range appears
    once per batch, inside its parent, and each batch's dispatch and
    collect ranges sit in the same ``batch.<id>`` range, the engine-wide id
    counting on across calls; the fused resample's range appears with a
    16 kHz call. A ``batch.<id>`` range holds its engine range and nothing
    beside it, so the fixed name is the innermost range around any host
    work, and a trace's gaps are labelled by it."""
    from torch.profiler import ProfilerActivity, profile

    eng = engine(params)
    eng.encode_batch([np.zeros(700, np.int16)])  # batch 0
    rng = np.random.default_rng(1)
    pcm = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (4000, 9000, 12000)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.encode_batch(pcm, sr=16_000)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    got, every = _ranges(path)
    n = eng.stats.batches - 1
    assert n >= 2
    for name in ["engine.dispatch", "engine.collect", "mimi.resample", *NESTING]:
        assert len(got[name]) == n, (name, len(got[name]))
    for child, parent in NESTING.items():
        assert all(_inside(s, got[parent]) for s in got[child]), child
    engine_ranges = got["engine.dispatch"] + got["engine.collect"]
    for i in range(1, n + 1):
        tags = got.pop(f"batch.{i}")
        assert len(tags) == 2
        assert sum(_inside(s, tags) for s in got["engine.dispatch"]) == 1
        assert sum(_inside(s, tags) for s in got["engine.collect"]) == 1
        for tag in tags:
            (inner,) = [s for s in engine_ranges if _inside(s, [tag])]
            held = [s for s in every if s != tag and _inside(s, [tag])]
            assert held and all(_inside(s, [inner]) for s in held)
    assert not [k for k in got if k.startswith("batch.")]


def test_no_range_is_entered_without_a_profiler(params, audios, monkeypatch):
    """With no profiler recording, the engine and the model enter no range:
    the range constructors are never called. Told that one records, they
    are, so the count is of the constructors the program uses."""
    entered = Counter()

    class Counted:
        def __init__(self, name, *args):
            entered[name] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(ranges, "record_function", Counted)
    eng = engine(params)
    eng.encode_batch(audios)
    assert not entered
    monkeypatch.setattr(ranges, "recording", lambda: True)
    eng.encode_batch(audios)
    batches = plan_batches(eng, LENGTHS)
    for name in ["engine.dispatch", "engine.collect", *NESTING]:
        assert entered[ranges.PREFIX + name] == batches, name
    for i in range(batches, 2 * batches):  # the second call's ids
        assert entered[f"{ranges.PREFIX}batch.{i}"] == 2


def test_realtime_window_opens_at_the_first_audio(params, audios):
    """Construction, warm-up and an autotune probe leave the clock closed
    (realtime_factor 0); the first encode call opens it, so the wall
    seconds are the call's, and ``as_dict`` keeps every key it had."""
    eng = engine(params)
    eng.warmup()
    eng.autotune_transfer(seconds=0.5, rounds=1, samples=audios[:2])
    assert eng.stats.started_at is None
    assert eng.stats.wall_seconds == 0.0 and eng.stats.realtime_factor == 0.0
    time.sleep(0.2)
    t0 = time.perf_counter()
    eng.encode_batch(audios)
    t1 = time.perf_counter()
    s = eng.stats
    assert t0 <= s.started_at <= t1
    assert s.wall_seconds < time.perf_counter() - t0 + 1e-3
    assert s.realtime_factor == pytest.approx(s.audio_seconds / s.wall_seconds, rel=0.05)
    assert {"audio_seconds", "utterances", "frames", "wall_seconds", "realtime_factor",
            "bucket_efficiency", "transient_retries"} <= set(s.as_dict())
    assert EngineStats(started_at=1.0).started_at == 1.0  # a caller may open it


def test_overlapping_intervals_count_once(monkeypatch):
    """Two intervals open at once (a worker's streaming group beside a
    batch) count as busy once, the gaps with none open as idle, and the
    two add up to the time from the first mark to the last; a segment
    whose end the stream has not passed waits for a later read."""
    clock = iter([0.0, 1.0, 3.0, 4.0, 6.0, 7.0])
    monkeypatch.setattr(metrics_mod.time, "perf_counter", lambda: next(clock))
    line = metrics_mod.StreamTimeline(torch.device("cpu"))
    stats = EngineStats(started_at=0.0)
    line.open()   # 0: A
    line.open()   # 1: B, beside A
    line.close()  # 3: A ends
    line.read(stats)
    assert (stats.stream_seconds, stats.stream_idle_seconds) == (3.0, 0.0)
    line.close()  # 4: B ends
    line.open()   # 6: C, after 2 s with nothing open
    reached = {"t": 6.0}  # the stream has not passed the mark at 7 yet
    monkeypatch.setattr(metrics_mod._HostMark, "query", lambda mark: mark.t <= reached["t"])
    line.close()  # 7
    line.read(stats)
    assert (stats.stream_seconds, stats.stream_idle_seconds) == (4.0, 2.0)
    reached["t"] = 7.0
    line.read(stats)
    assert (stats.stream_seconds, stats.stream_idle_seconds) == (5.0, 2.0)


def _spy_marks(eng):
    """Record each mark the engine puts on its timeline: (open +1 or
    close -1, host time)."""
    marks = []
    step = eng._timeline._step

    def spy(delta):
        mark = step(delta)
        marks.append((delta, mark.t))
        return mark

    eng._timeline._step = spy
    return marks


@pytest.mark.parametrize("case", ["resample_many", "stream_group_beside_a_call"])
def test_work_outside_batches_is_on_the_timeline(params, audios, case):
    """The engine's device work outside ``_dispatch`` is an interval on its
    timeline, as a batch is: the unfused resample of a whole call, and a
    streaming group that a ``finish()`` worker runs while the main thread
    encodes the next call. Every interval is opened and closed, and the
    busy and idle seconds add up to the time from the first mark to the
    last, so an overlap is counted once."""
    import threading

    if case == "resample_many":
        # unmasked semantics: a 16 kHz call is resampled whole, then encoded
        eng = engine(params, masked=False)
        marks = _spy_marks(eng)
        eng.encode_batch(audios[:4], sr=16_000)
        want_opens = eng.stats.batches + 1
    else:
        eng = engine(params, max_chunk_seconds=0.5, long_audio_policy="stream")
        marks = _spy_marks(eng)
        rng = np.random.default_rng(2)
        long = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (15000, 20000)]
        finish = eng.encode_batch(long + audios[5:], defer=True)
        worker = threading.Thread(target=finish)
        worker.start()
        eng.encode_batch([a[:9000] for a in audios])
        worker.join()
        want_opens = eng.stats.batches + 1  # one group of two streams
        assert eng.stats.stage_seconds["stream"] > 0
    s = eng.stats
    assert [d for d, _ in marks].count(1) == [d for d, _ in marks].count(-1) == want_opens
    times = [t for _, t in marks]
    assert times == sorted(times)
    assert s.stream_seconds + s.stream_idle_seconds == pytest.approx(times[-1] - times[0],
                                                                     rel=1e-9, abs=1e-9)
    assert s.stream_seconds > 0 and s.stream_idle_seconds >= 0


def test_stream_events_chain_the_batches_on_the_card(params, audios, cuda):
    """On the card every batch's interval and the gaps between them come
    from the engine's stream events: both counters positive, no batch
    counted twice, and interval plus gaps no longer than the time from the
    previous call's end to this call's end (the chain starts at the last
    batch the engine queued before it)."""
    eng = engine(params, device=cuda)
    eng.encode_batch(audios)  # builds the kernels
    torch.cuda.synchronize()
    t_prev = time.perf_counter()
    eng.stats = EngineStats()
    t0 = time.perf_counter()
    eng.encode_batch(audios)
    t1 = time.perf_counter()
    s = eng.stats
    assert s.batches == plan_batches(eng, LENGTHS)
    assert s.stream_seconds > 0 and s.stream_idle_seconds > 0
    assert s.stream_seconds + s.stream_idle_seconds <= t1 - t_prev + 1e-3
    assert s.stream_seconds <= t1 - t0 + 1e-3
    st = s.stage_seconds
    assert st["dispatch.upload"] + st["dispatch.launch"] <= st["dispatch"]
    assert st["fetch.wait"] <= st["fetch"]
    print(json.dumps({"device": torch.cuda.get_device_name(cuda), **s.as_dict(),
                      "call_s": t1 - t0, "since_previous_call_s": t1 - t_prev}))
