"""The traced segment: ``torch.profiler`` over CPU and CUDA activity, its
Chrome trace reduced to what the per-layer metrics and the result line's
``device`` and ``breakdown`` read.

Spans are ``record_function`` ranges named ``port_bench::<what>`` that the
benchmark's own files put around the program's functions
(``pbkit/spans.py``). A device operation belongs to a range when the host
call that launched it (the ``cuda_runtime`` or ``cuda_driver`` event with
the same correlation id) ran inside that range on the same thread.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List

WINDOW = "port_bench::traced_window"
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
# what the result line's ``breakdown`` carries, each a list of [name, number]
BREAKDOWN = ("device_ops", "idle_gaps", "range_device_s", "range_calls")


def profile(fn: Callable[[], None], workdir: str) -> Dict:
    """Run ``fn`` under the profiler, in one ``WINDOW`` range that ends
    after the device has finished, and return ``summarize`` of its trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(WINDOW):
            fn()
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events)


def _merge(intervals: List[tuple]) -> List[list]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: List[Dict]) -> Dict:
    """Seconds of the traced window, of device activity in it, of device
    time launched inside each ``port_bench::`` range and the range's call
    count (each a list of [range, number], the largest first), the device
    operations that took most time, and the idle gaps of the device summed
    by what the host's main thread was doing."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} {WINDOW} ranges, not one")
    w0, w1, main = win[0]["ts"], win[0]["ts"] + win[0]["dur"], win[0]["tid"]
    gpu = [e for e in xs if e.get("cat") in GPU_CATS]
    launch = {
        e["args"]["correlation"]: (e["tid"], e["ts"])
        for e in xs if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})
    }
    spans: Dict[str, Dict] = defaultdict(lambda: defaultdict(list))
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"].startswith("port_bench::") and e is not win[0]:
            spans[e["name"]][e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    for by_tid in spans.values():
        for k in by_tid:
            by_tid[k].sort()

    def inside(name: str, tid, ts) -> bool:
        iv = spans[name].get(tid)
        if not iv:
            return False
        i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
        return i >= 0 and iv[i][0] <= ts <= iv[i][1]

    range_us: Dict[str, float] = defaultdict(float)
    ops: Dict[str, float] = defaultdict(float)
    unattributed = 0.0
    for e in gpu:
        ops[e["name"]] += e["dur"]
        src = launch.get(e.get("args", {}).get("correlation"))
        if src is None:
            unattributed += e["dur"]
            continue
        for name in spans:
            if inside(name, *src):
                range_us[name] += e["dur"]
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in gpu
                   if e["ts"] + e["dur"] > w0 and e["ts"] < w1])
    busy_us = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "range_device_s": _largest({k: v / 1e6 for k, v in range_us.items()}),
        "range_calls": _largest({k: sum(len(v) for v in by_tid.values()) for k, by_tid in spans.items()}),
        "device_ops": _largest({k: v / 1e6 for k, v in ops.items()}),
        "idle_gaps": _label_gaps(gaps, [e for e in xs if e.get("tid") == main and e.get("cat") in HOST_CATS]),
        "device_events": len(gpu),
        "unattributed_s": unattributed / 1e6,
    }


def window_idle(run):
    """Percent of the window's wall seconds in which no kernel, copy or
    memset ran on the card: one less the traced segment's device busy
    seconds per unit (the profiler's device timeline), times the window's
    units, over the window's wall seconds; None without a trace.

    Every unit of a cell launches the same device work, so its busy seconds
    per unit do not depend on the host's pace. The traced segment's own
    length does: the profiler's cost on every host operation slows a
    launch-bound host by a quarter or more, by a share that changes from
    run to run with the host's load. The window carries none of that."""
    t = run.trace
    if t is None or not t["busy_s"] or not run.traced_units or not run.units:
        return None
    busy = t["busy_s"] / len(run.traced_units) * len(run.units)
    return 100.0 * (1.0 - busy / run.window_s)


def _largest(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def lookup(pairs: List[list], name: str):
    """The number under ``name`` in a list of [name, number], or None."""
    return next((v for k, v in pairs if k == name), None)


def _label_gaps(gaps: List[tuple], host: List[Dict]) -> List[list]:
    """Idle seconds summed by the main thread's innermost benchmark range
    and innermost operation at each gap's start; the 10 largest."""
    evs = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host)
    stack: List[tuple] = []
    j = 0
    total: Dict[str, float] = defaultdict(float)
    for g0, g1 in sorted(gaps):
        while j < len(evs) and evs[j][0] <= g0:
            while stack and stack[-1][1] <= evs[j][0]:
                stack.pop()
            stack.append(evs[j])
            j += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        ranges = [s[2] for s in stack if s[2].startswith("port_bench::") and s[2] != WINDOW]
        inner = stack[-1][2] if stack and stack[-1][2] != WINDOW else "(between calls)"
        label = f"{ranges[-1]} / {inner}" if ranges and ranges[-1] != inner else inner
        total[label] += (g1 - g0) / 1e6
    return _largest(total)
