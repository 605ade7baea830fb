"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result line.

A run loads the cell's configuration, traffic and parameters by name,
builds the program and its inputs from ``--seed`` and warms up on one
unit of the cell's own traffic: that is ``setup_s``, counted from the
process's start. The window is a closed loop: units of work run back to
back until the first one that ends after ``--seconds``; rates divide all
the work of the window by all its time. With ``--trace 1`` a traced
segment of ``trace_units`` more units follows the window under the
profiler, with the benchmark's ranges around the program's functions; the
per-layer metrics read the window's counters and the segment's trace.
Then the peak memory is read, the program's state freed, and the plain
reference judges what the timed path produced.
"""

from __future__ import annotations

import argparse
import copy
import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Dict, Optional

from pbkit import manifest, peaks, spans, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "tokenize_audio_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    JAX or the JAX package, each compared whole: ``tokenize_audio_tpu_torch``
    is not ``tokenize_audio_tpu``."""
    names = sys.modules if names is None else names
    return sorted({str(n).split(".")[0] for n in names} & set(FORBIDDEN))


def process_start(fallback: float) -> float:
    """``time.perf_counter()``'s reading at this process's start, from its
    start time in ``/proc`` (10 ms ticks); ``fallback`` where that is not
    readable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return fallback
    return time.perf_counter() - age if 0 <= age < 3600 else fallback


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _load(os.path.join(manifest.BENCH_DIR, "drivers", f"{name}.py"), f"port_bench_driver_{name}")


def reader(metric: str):
    return _load(manifest.metric_path(metric), f"port_bench_metric_{metric.replace('.', '_')}")


class Run:
    """What one run of a cell holds: its inputs, the program under test,
    and what the window and the traced segment left for the readers."""

    def __init__(self, cell: str, cfg: Dict, mix: Dict, params: Dict, seed: int,
                 seconds: float, device, workdir: str, mode: Optional[Dict] = None):
        self.cell, self.cfg, self.mix, self.params = cell, cfg, mix, params
        self.seed, self.seconds, self.device, self.workdir = seed, seconds, device, workdir
        self.mode = dict(cfg["run"], **(mode or {}))
        self.books = cfg["run"]["num_codebooks"]
        self.units: list = []  # each with the valid 24 kHz samples of its rows
        self.traced_units: list = []
        self.missing = 0
        self.error: Optional[str] = None
        self.setup_s = self.window_s = 0.0
        self.traced_rows: list = []  # valid samples per row of each traced SEANet call
        self.stats = None
        self.trace: Optional[Dict] = None
        self.peak: Optional[Dict] = None


def execute(run: Run, drv, trace_on: bool, t_start: float) -> Dict:
    """Set up, measure, trace and check ``run``; returns the check's
    result with the device's readings."""
    import torch

    cuda = run.device.type == "cuda"
    torch.set_num_threads(run.params["host_threads"])
    if cuda:
        run.peak = peaks.peak(torch.cuda.get_device_name(run.device))
    drv.setup(run)
    if cuda:
        torch.cuda.synchronize()
    drv.reset_stats(run)
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    try:
        while True:
            run.units.append(drv.unit(run, len(run.units)))
            run.units[-1]["t_end"] = time.perf_counter() - t0
            if run.units[-1]["t_end"] >= run.seconds:
                break
    except Exception:  # the timed path failed: report it, not a rate
        run.error = traceback.format_exc()
        run.missing += 1
    run.window_s = time.perf_counter() - t0
    run.stats = _window_stats(drv.stats(run))
    if trace_on and run.error is None:
        units = lambda: run.traced_units.extend(
            drv.unit(run, len(run.units) + k) for k in range(run.params["trace_units"])
        )
        notes: Dict[str, list] = {}
        with spans.installed(spans.model_targets(notes) + drv.span_targets(run)):
            run.trace = trace.profile(units, run.workdir)
        run.traced_rows = [spans.rows_of(n) for n in notes["seanet_encode"]]
    device = {"platform": run.device.type if not cuda else "gpu", "count": 1}
    if cuda:
        device.update(kind=torch.cuda.get_device_name(run.device),
                      memory_peak_bytes=int(torch.cuda.max_memory_allocated(run.device)))
    drv.release(run)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result = drv.check(run)
    if run.trace is not None:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {k: run.trace[k] for k in trace.BREAKDOWN}
    result["device"] = device
    return result


def _window_stats(stats):
    """A copy of the program's counters as the window left them: the traced
    segment goes on counting into the program's own."""
    if stats is None:
        return None
    out = copy.copy(stats)
    out.stage_seconds = dict(stats.stage_seconds)
    return out


def metrics(man: manifest.Manifest, run: Run, trace_on: bool) -> Dict:
    """The cell's end-to-end metrics (``trace_on`` False) or per-layer
    metrics, each read by its own reader; a reader that finds nothing
    leaves its metric out."""
    wanted = man.per_layer(run.cell) if trace_on else man.end_to_end(run.cell)
    out = {}
    for m in wanted:
        value = reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, root: str = "", t_import: float = 0.0) -> int:
    t_start = process_start(t_import)
    ap = argparse.ArgumentParser(prog="port_bench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest.Manifest(root)
    cell = man.cell(args.workload)
    import tokenize_audio_tpu_torch as program
    import torch

    if not os.path.abspath(program.__file__).startswith(os.path.join(os.path.abspath(root), "")):
        print(f"port_bench: the program is not in this checkout ({program.__file__})", file=sys.stderr)
        return 2

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"port_bench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    mix = man.traffic(cell.traffic)
    workdir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        run = Run(cell.name, man.config(cell.config), mix, man.cell_params(cell.name),
                  args.seed, args.seconds, torch.device("cuda", 0), workdir)
        result = execute(run, driver(mix["driver"]), bool(args.trace), t_start)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if run.error:
        print(run.error, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"port_bench: {', '.join(found)} loaded in the measuring process", file=sys.stderr)
        return 3
    line = result_line(man, run, result, bool(args.trace))
    print(f"port_bench: card {peaks.card_label(run.device.index or 0)}", file=sys.stderr)
    print(f"port_bench: setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, "
          f"{len(run.units)} units, "
          f"{result['sampled']} items compared; {_io()}", file=sys.stderr)
    ends = [0.0] + [u["t_end"] for u in run.units if "t_end" in u]
    print("port_bench: unit seconds " + " ".join(f"{b - a:.3f}" for a, b in zip(ends, ends[1:])),
          file=sys.stderr)
    if run.stats is not None:
        print("port_bench: stage seconds " + json.dumps(
            {k: round(v, 3) for k, v in sorted(run.stats.stage_seconds.items())}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _io() -> str:
    """Bytes this process wrote (``/proc/self/io``) and its child
    processes sent to storage."""
    import resource

    children = resource.getrusage(resource.RUSAGE_CHILDREN).ru_oublock * 512
    try:
        with open("/proc/self/io") as f:
            io = dict(line.split(": ") for line in f.read().split("\n") if ": " in line)
        return (f"wrote {int(io['wchar'])} bytes, {int(io['write_bytes'])} to storage, "
                f"{children} to storage by child processes")
    except (OSError, KeyError, ValueError):
        return f"{children} bytes to storage by child processes"


def result_line(man: manifest.Manifest, run: Run, result: Dict, trace_on: bool) -> Dict:
    """The last line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, with a trace ``breakdown``, and last the compared numbers
    each beside its limit."""
    line = {
        "correct": result["correct"],
        "attempted": result["attempted"],
        "failed": result["failed"],
        "metrics": metrics(man, run, trace_on),
        "device": result["device"],
    }
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checks"] = result["checks"]
    return line
