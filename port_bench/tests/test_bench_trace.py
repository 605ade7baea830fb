"""The reduction of a Chrome trace: busy and idle seconds, device time by
range through the launch's correlation id, and the labels of idle gaps."""

import pytest

import bench_testkit  # noqa: F401  (puts the benchmark on the path)

from pbkit import trace


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


EVENTS = [
    X("user_annotation", trace.WINDOW, 0, 1000),
    X("user_annotation", "port_bench::seanet_encode", 10, 100),
    X("cpu_op", "aten::conv1d", 20, 30),
    X("cuda_runtime", "cudaLaunchKernel", 25, 5, correlation=1),
    X("cuda_driver", "cuLaunchKernel", 60, 5, correlation=2),
    X("user_annotation", "port_bench::split_rvq_encode", 200, 50),
    X("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=3),
    X("cuda_runtime", "cudaLaunchKernel", 300, 5, tid=2, correlation=4),
    X("user_annotation", "port_bench::engine.collect", 400, 500),
    X("cpu_op", "aten::item", 410, 400),
    X("kernel", "conv_kernel", 100, 200, tid=7, correlation=1),
    X("kernel", "resblock", 300, 100, tid=7, correlation=2),
    X("kernel", "rvq", 400, 50, tid=7, correlation=3),
    X("gpu_memcpy", "Memcpy DtoH", 600, 100, tid=7, correlation=4),
    X("kernel", "orphan", 950, 100, tid=7, correlation=99),
]


def test_busy_window_and_range_device_time():
    s = trace.summarize(EVENTS)
    assert s["window_s"] == pytest.approx(1000e-6)
    # 100-450 and 600-700 and 950-1000 (clipped at the window's end)
    assert s["busy_s"] == pytest.approx((350 + 100 + 50) * 1e-6)
    assert trace.lookup(s["range_device_s"], "port_bench::seanet_encode") == pytest.approx(300e-6)
    assert trace.lookup(s["range_device_s"], "port_bench::split_rvq_encode") == pytest.approx(50e-6)
    assert s["range_device_s"][0][0] == "port_bench::seanet_encode"  # the largest first
    # launched from another thread: not inside this thread's collect range
    assert trace.lookup(s["range_device_s"], "port_bench::engine.collect") is None
    assert trace.lookup(s["range_calls"], "port_bench::seanet_encode") == 1
    assert s["unattributed_s"] == pytest.approx(100e-6)
    assert s["device_ops"][0] == ["resblock", pytest.approx(100e-6)] or s["device_ops"][0][0] == "conv_kernel"


def test_idle_gaps_are_labelled_by_the_main_thread():
    gaps = dict((k, v) for k, v in trace.summarize(EVENTS)["idle_gaps"])
    assert gaps["(between calls)"] == pytest.approx(100e-6)  # 0-100
    assert gaps["port_bench::engine.collect / aten::item"] == pytest.approx((600 - 450 + 950 - 700) * 1e-6)


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.summarize(EVENTS[1:])


def test_the_breakdown_is_lists_of_named_numbers():
    s = trace.summarize(EVENTS)
    for key in trace.BREAKDOWN:
        assert len(s[key]) <= 10
        assert all(isinstance(k, str) and isinstance(v, (int, float)) for k, v in s[key])


def test_the_idle_share_is_the_window_s_not_the_traced_segment_s():
    from types import SimpleNamespace

    # 2 traced units kept the card busy 0.6 s in a 1.0 s segment slowed by
    # the profiler; 10 window units took 4.0 s: 3.0 s of it busy
    run = SimpleNamespace(trace={"busy_s": 0.6, "window_s": 1.0}, traced_units=[{}] * 2,
                          units=[{}] * 10, window_s=4.0)
    assert trace.window_idle(run) == pytest.approx(25.0)
    run.trace = None
    assert trace.window_idle(run) is None
