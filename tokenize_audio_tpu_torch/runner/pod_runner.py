"""Shard job fan-out runner — the GPU-node replacement for the reference's
Slurm submit layer (SURVEY §2.1 #22-23: submit_shard.sh /
submit_all_shards*.sh / cancel_all_jobs.sh / job templates).

One shard per worker process (in production: one shard per GPU; the
coordination plane stays shared-nothing — progress files + the artifact
hub, exactly like the reference's Slurm jobs). Provides:

  - ``run``: read a shard list, launch ``--cmd`` per shard with ``{shard}``
    substitution, throttle to ``--max-concurrent`` (submit_all_shards.sh
    polling loop, emilia-mimi/submit_all_shards.sh:104-143), skip shards
    whose progress ledger says completed or that are already running
    (skip-if-queued, :82-97), per-shard log files, pidfile registry;
  - per-GPU job isolation on multi-GPU hosts: every launched job gets an
    exclusive GPU injected via env (``CUDA_VISIBLE_DEVICES``, ``--chip-env``
    to customize; the chip-th entry of the runner's own
    ``CUDA_VISIBLE_DEVICES`` where that is set), the throttle is capped at the free-GPU
    count, and GPUs release when jobs exit — what the reference's
    one-GPU-per-job Slurm isolation sets for each job
    (yodas2-mimi/submit/job_template.sh:3-15, ``--gres=gpu:1``);
  - per-job walltime: ``--walltime SECONDS`` SIGTERMs (then, after
    ``--kill-grace``, SIGKILLs) any job exceeding its budget so a hung
    job — e.g. a wedged device claim — releases its GPU instead of
    holding it forever. The Slurm equivalent is the job template's
    ``#SBATCH --time=14-00:00:00`` (yodas2-mimi/submit/job_template.sh:5);
  - ``cancel``: kill every live job in the pidfile registry
    (cancel_all_jobs.sh).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from tokenize_audio_tpu_torch.runner.progress import read_json


def _pidfile(run_dir: str) -> str:
    return os.path.join(run_dir, "jobs.json")


def _load_jobs(run_dir: str) -> Dict[str, dict]:
    jobs = read_json(_pidfile(run_dir), {}) or {}
    # registry v1 stored a bare pid; adopt it with an unknown chip
    out = {
        s: (v if isinstance(v, dict) else {"pid": int(v), "chip": None})
        for s, v in jobs.items()
    }
    for v in out.values():
        # pre-walltime registry entries carry no launch time; start their
        # clock at adoption (the original start is unknowable here)
        v.setdefault("t0", time.time())
    return out


def _save_jobs(run_dir: str, jobs: Dict[str, dict]) -> None:
    os.makedirs(run_dir, exist_ok=True)
    with open(_pidfile(run_dir), "w") as f:
        json.dump(jobs, f)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def shard_completed(progress_dir: str, shard: str, expected_units: int | None = None) -> bool:
    state = read_json(os.path.join(progress_dir, f"{shard}_progress.json"), None)
    if not state:
        return False
    completed = len(state.get("completed", []))
    if expected_units is not None:
        return completed >= expected_units
    return bool(state.get("meta", {}).get("done"))


def _gpu_nodes():
    """The GPU device nodes /dev/nvidia<N> this process may open (not
    nvidiactl, nvidia-uvm or nvidia-modeset, which every NVIDIA install
    has). A container can hold the nodes of GPUs it was not given, whose
    open the runtime refuses; opening a node creates no CUDA context."""
    nodes = []
    for p in glob.glob("/dev/nvidia*"):
        if not re.fullmatch(r"/dev/nvidia\d+", p):
            continue
        try:
            os.close(os.open(p, os.O_RDWR))
        except OSError:
            continue
        nodes.append(p)
    return nodes


def _allocation(n_nodes: int) -> Optional[List[str]]:
    """The entries of this process's ``CUDA_VISIBLE_DEVICES`` that CUDA
    honours (an index below ``n_nodes``, a ``GPU-`` UUID or a ``MIG-`` id;
    CUDA ignores the list from its first invalid entry on), or None when the
    variable is unset. With no node found (``n_nodes`` 0), indices are not
    bounded."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return None
    entries = []
    for v in visible.split(","):
        v = v.strip()
        if not ((v.isdigit() and (not n_nodes or int(v) < n_nodes))
                or v.startswith(("GPU-", "MIG-"))):
            break
        entries.append(v)
    return entries


def _visible_gpu_devices():
    """GPU count without creating a CUDA context in the runner process
    (which would hold memory on GPU 0 for the whole run): trust an explicit
    env override, else count the /dev/nvidia<N> device nodes, narrowed by
    ``CUDA_VISIBLE_DEVICES`` when it is set. None = unknown."""
    env = os.environ.get("TOKENIZE_AUDIO_TPU_DEVICES")
    if env:
        try:
            return int(env)
        except ValueError:
            return None
    n = len(_gpu_nodes())
    allocation = _allocation(n)
    if n and allocation is not None:
        n = len(allocation)
    return n or None


# single-GPU visibility: each job sees exactly one GPU of the host, what
# the reference's `#SBATCH --gres=gpu:1` sets for each job
# (yodas2-mimi/submit/job_template.sh:3). Override with --chip-env
# VAR={chip} (repeatable; replaces the defaults).
DEFAULT_CHIP_ENV = ("CUDA_VISIBLE_DEVICES={chip}",)


def _chip_env(templates, chip: int) -> Dict[str, str]:
    """The env of job ``chip``. Where this process's ``CUDA_VISIBLE_DEVICES``
    is set, ``{chip}`` in a ``CUDA_VISIBLE_DEVICES`` template is the chip-th
    GPU of that allocation, as a Slurm job's ``--gres=gpu:1`` stays inside
    the allocation (an index past it gives an empty value: no GPU), not
    physical GPU ``chip``; unset, it is ``chip``."""
    env = {}
    for t in templates:
        var, _, val = t.partition("=")
        value = chip
        if var == "CUDA_VISIBLE_DEVICES" and var in os.environ:
            allocation = _allocation(len(_gpu_nodes()))
            value = allocation[chip] if chip < len(allocation) else ""
        env[var] = val.format(chip=value)
    return env


def run(args) -> int:
    n_chips = args.chips if args.chips is not None else _visible_gpu_devices()
    isolate = n_chips is not None and n_chips >= 2
    if isolate and args.max_concurrent > n_chips:
        print(
            f"[pod-runner] capping --max-concurrent={args.max_concurrent} to "
            f"{n_chips} (one job per GPU, each given exactly one)"
        )
        args.max_concurrent = n_chips
    elif not isolate and args.max_concurrent > 1:
        # CUDA processes can share a card, but concurrent encoders on one
        # device contend for its SMs and memory and serialize
        # unpredictably. Warn unless the host clearly has enough devices.
        if n_chips is not None and n_chips < args.max_concurrent:
            print(
                f"[pod-runner] WARNING: --max-concurrent={args.max_concurrent} "
                f"but only {n_chips} GPU(s) visible; concurrent shard "
                "processes will contend for the same chip and serialize. "
                "Use 1 process per chip (or CPU-only stages) instead."
            )
    with open(args.shard_list) as f:
        shards = [line.strip() for line in f if line.strip() and not line.startswith("#")]
    os.makedirs(args.log_dir, exist_ok=True)
    jobs = {s: j for s, j in _load_jobs(args.run_dir).items() if _alive(j["pid"])}
    launched = skipped = 0
    procs: Dict[str, subprocess.Popen] = {}

    log_handles = {}

    def poll():
        if args.walltime is not None:
            now = time.time()
            for s, j in list(jobs.items()):
                if not _alive(j["pid"]):
                    continue
                if "term_t" in j:
                    if now - j["term_t"] >= args.kill_grace:
                        print(
                            f"[pod-runner] shard {s} (pid {j['pid']}) ignored "
                            "SIGTERM; sending SIGKILL"
                        )
                        try:
                            os.kill(j["pid"], signal.SIGKILL)
                        except ProcessLookupError:
                            pass
                elif now - j.get("t0", now) > args.walltime:
                    print(
                        f"[pod-runner] shard {s} (pid {j['pid']}) exceeded "
                        f"walltime {args.walltime:.0f}s; sending SIGTERM"
                    )
                    try:
                        os.kill(j["pid"], signal.SIGTERM)
                    except ProcessLookupError:
                        pass
                    j["term_t"] = now
                    _save_jobs(args.run_dir, jobs)
        for s, p in list(procs.items()):
            if p.poll() is not None:
                print(f"[pod-runner] shard {s} exited with {p.returncode}")
                del procs[s]
                h = log_handles.pop(s, None)
                if h is not None:
                    h.close()  # one fd per launched shard otherwise leaks
                jobs.pop(s, None)
                _save_jobs(args.run_dir, jobs)
        # adopted jobs (still-alive pids from a previous run) count toward
        # the concurrency cap too — a rerun must not oversubscribe the chip
        for s, j in list(jobs.items()):
            if s not in procs and not _alive(j["pid"]):
                jobs.pop(s, None)
                _save_jobs(args.run_dir, jobs)

    def active() -> int:
        return len(procs) + sum(1 for s in jobs if s not in procs)

    warned_unknown = set()

    def free_chip():
        # lowest chip index not held by a live or adopted job. An adopted
        # job with an UNKNOWN chip (v1 registry, or launched without
        # isolation) was started with no CUDA_VISIBLE_DEVICES restriction —
        # it sees every GPU and may use any — so it must block ALL launches
        # until it exits, not zero of them.
        unknown = [s for s, j in jobs.items() if j["chip"] is None]
        if unknown:
            if tuple(unknown) not in warned_unknown:
                warned_unknown.add(tuple(unknown))
                print(
                    f"[pod-runner] adopted job(s) {unknown} hold an unknown "
                    "chip set (pre-isolation launch sees every GPU); "
                    "waiting for them to exit before launching isolated jobs"
                )
            return None
        used = {j["chip"] for j in jobs.values()}
        for c in range(n_chips):
            if c not in used:
                return c
        return None  # all chips busy (adopted jobs can exceed the cap)

    for shard in shards:
        if shard in jobs:  # skip-if-queued
            print(f"[pod-runner] {shard}: already running (pid {jobs[shard]['pid']})")
            skipped += 1
            continue
        if args.progress_dir and shard_completed(args.progress_dir, shard):
            print(f"[pod-runner] {shard}: already completed")
            skipped += 1
            continue
        chip = None
        while True:
            poll()
            if active() < args.max_concurrent:
                if not isolate:
                    break
                chip = free_chip()
                if chip is not None:
                    break
            time.sleep(args.poll_seconds)
        cmd = [c.replace("{shard}", shard) for c in args.cmd]
        log_path = os.path.join(args.log_dir, f"{shard}.log")
        log_f = open(log_path, "a")
        env = None
        if isolate:
            env = {**os.environ, **_chip_env(args.chip_env, chip)}
        p = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT, env=env)
        log_handles[shard] = log_f
        procs[shard] = p
        jobs[shard] = {"pid": p.pid, "chip": chip, "t0": time.time()}
        _save_jobs(args.run_dir, jobs)
        where = f" on chip {chip}" if chip is not None else ""
        print(f"[pod-runner] launched {shard} (pid {p.pid}){where} -> {log_path}")
        launched += 1

    rc = 0
    if args.wait:
        # wait for this runner's own children — and, when a walltime is
        # set, keep policing ADOPTED jobs until they exit too: the budget
        # is documented to survive runner restarts, and after a restart
        # every shard is adopted (procs is empty), so a `while procs` loop
        # would return immediately and a wedged adopted job would hold its
        # chip forever.
        def outstanding() -> bool:
            if procs:
                return True
            return args.walltime is not None and bool(jobs)

        while outstanding():
            poll()
            time.sleep(args.poll_seconds)
    print(f"[pod-runner] launched={launched} skipped={skipped}")
    return rc


def status(args) -> int:
    """Print the job registry: shard, pid, chip, liveness (squeue's role
    for the reference's Slurm jobs, over the pidfile registry)."""
    jobs = _load_jobs(args.run_dir)
    if not jobs:
        print("[pod-runner] no registered jobs")
        return 0
    for shard, j in sorted(jobs.items()):
        chip = j["chip"] if j["chip"] is not None else "-"
        state = "running" if _alive(j["pid"]) else "dead"
        age = time.time() - j["t0"]
        print(f"{shard}\tpid={j['pid']}\tchip={chip}\tage={age:.0f}s\t{state}")
    return 0


def cancel(args) -> int:
    jobs = _load_jobs(args.run_dir)
    killed = 0
    for shard, j in jobs.items():
        if _alive(j["pid"]):
            print(f"[pod-runner] killing {shard} (pid {j['pid']})")
            try:
                os.kill(j["pid"], signal.SIGTERM)
                killed += 1
            except ProcessLookupError:
                pass
    # keep registry entries for pids that are still shutting down: wiping
    # them immediately would let a concurrent `run` miss skip-if-queued and
    # launch a duplicate onto the same progress file/chip
    deadline = time.time() + 10.0
    while time.time() < deadline and any(_alive(j["pid"]) for j in jobs.values()):
        time.sleep(0.2)
    _save_jobs(args.run_dir, {s: j for s, j in jobs.items() if _alive(j["pid"])})
    still = sum(1 for j in jobs.values() if _alive(j["pid"]))
    print(f"[pod-runner] killed {killed} jobs" + (f" ({still} still exiting, kept in registry)" if still else ""))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="action", required=True)

    r = sub.add_parser("run")
    r.add_argument("--shard-list", required=True)
    r.add_argument("--max-concurrent", type=int, default=1)
    r.add_argument("--poll-seconds", type=float, default=5.0)
    r.add_argument("--run-dir", default="/tmp/ta_pod")
    r.add_argument("--log-dir", default="/tmp/ta_pod/logs")
    r.add_argument("--progress-dir", default=None)
    r.add_argument(
        "--chips",
        type=int,
        default=None,
        help="GPUs on this host (default: auto-detect via "
        "TOKENIZE_AUDIO_TPU_DEVICES or the /dev/nvidia<N> nodes, narrowed by "
        "CUDA_VISIBLE_DEVICES; 0/1 disables per-GPU isolation). With >=2 "
        "GPUs every job gets an exclusive GPU via --chip-env and the "
        "throttle is capped at the GPU count.",
    )
    r.add_argument(
        "--chip-env",
        action="append",
        default=None,
        help="VAR={chip} env template injected per job (repeatable; "
        f"default: {' '.join(DEFAULT_CHIP_ENV)})",
    )
    r.add_argument(
        "--walltime",
        type=float,
        default=None,
        help="per-job wall-clock budget in seconds; jobs exceeding it get "
        "SIGTERM, then SIGKILL after --kill-grace, and their GPU is freed "
        "(the reference's `#SBATCH --time=14-00:00:00`, "
        "yodas2-mimi/submit/job_template.sh:5). Default: unlimited. "
        "Enforced while this runner polls; the budget survives runner "
        "restarts via the job registry.",
    )
    r.add_argument(
        "--kill-grace",
        type=float,
        default=30.0,
        help="seconds between walltime SIGTERM and SIGKILL escalation",
    )
    r.add_argument("--wait", action="store_true")
    r.add_argument("cmd", nargs=argparse.REMAINDER,
                   help="command template after '--'; {shard} is substituted")

    c = sub.add_parser("cancel")
    c.add_argument("--run-dir", default="/tmp/ta_pod")

    st = sub.add_parser("status")
    st.add_argument("--run-dir", default="/tmp/ta_pod")

    args = ap.parse_args(argv)
    if args.action == "run":
        if args.cmd and args.cmd[0] == "--":
            args.cmd = args.cmd[1:]
        if args.chip_env is None:
            args.chip_env = list(DEFAULT_CHIP_ENV)
        return run(args)
    if args.action == "status":
        return status(args)
    return cancel(args)


if __name__ == "__main__":
    sys.exit(main())
