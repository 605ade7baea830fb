"""One crash window of a port processor, for the tier-1 cases of
tests/test_torch_crash_windows_*.py: a chaos child (tests/torch_*_chaos_child.py)
run with ``--kill-at`` must die by SIGKILL inside the window (its KILL marker
printed, no DONE); rerun unchanged, it must leave the hub and the progress
state of an uninterrupted run, encoding only what the kill lost; a second
rerun must encode nothing and change nothing. Imports nothing of JAX or the
JAX package."""

import json
import os
import signal

from tests.chaos_utils import run_child


def child(name: str) -> str:
    """The path of ``tests/<name>``."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def report_of(out: str) -> dict:
    """The DONE line's ``{"report", "utterances"}``."""
    [line] = [ln for ln in out.splitlines() if ln.startswith("DONE ")]
    return json.loads(line[len("DONE "):])


def clean_run(argv) -> dict:
    """An uninterrupted run of the child: its DONE report."""
    rc, out, _ = run_child(argv, timeout=300)
    assert rc == 0 and "DONE" in out, out[-3000:]
    return report_of(out)


def crash_window(argv, kill_at, marker, state, want, rerun_utterances, killed=None):
    """Kill ``argv``'s child at ``kill_at``, then rerun it twice.

    ``marker`` must appear on the KILL line (the path the window's call
    took); ``killed()``, if given, checks what the kill left; ``state()``
    reads the hub and progress state, which must equal ``want`` after each
    rerun; the first rerun must encode exactly ``rerun_utterances``
    utterances, the second none. Returns the first rerun's report."""
    rc, out, _ = run_child([*argv, "--kill-at", kill_at], timeout=300)
    kill_lines = [ln for ln in out.splitlines() if ln.startswith(f"KILL {kill_at}")]
    assert rc == -signal.SIGKILL, f"the kill never landed (rc {rc}):\n{out[-3000:]}"
    assert kill_lines and "DONE" not in out, out[-3000:]
    assert marker in kill_lines[0], kill_lines[0]
    if killed is not None:
        killed()
    first = clean_run(argv)
    assert state() == want
    assert first["utterances"] == rerun_utterances, first
    second = clean_run(argv)
    assert second["utterances"] == 0, second
    assert state() == want
    return first
