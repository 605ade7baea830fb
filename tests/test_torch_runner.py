"""PyTorch port, shard fleet: the port's monitor, manifests, pod runner and
chip check run side by side with the JAX package's on the same progress
dirs, hubs, shard lists and registries (the cases of
tests/test_monitor_podrunner.py), and must return the same rows, reports and
counts and print the same output once the JAX runner's TPU wording is the
port's and ``TPU_VISIBLE_DEVICES`` is ``CUDA_VISIBLE_DEVICES``. Also: GPU
counting without a CUDA context, and the pod runner driving the port's
YODAS2 command line over two shards on the CPU."""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from tokenize_audio_tpu import hub as jax_hub
from tokenize_audio_tpu.runner import chip_check as jax_chip_check
from tokenize_audio_tpu.runner import manifests as jax_manifests
from tokenize_audio_tpu.runner import monitor as jax_monitor
from tokenize_audio_tpu.runner import pod_runner as jax_pod_runner
from tokenize_audio_tpu.runner import progress as jax_progress
from tokenize_audio_tpu_torch import hub as port_hub
from tokenize_audio_tpu_torch.runner import chip_check, manifests, monitor, pod_runner, progress

PORT = SimpleNamespace(hub=port_hub, monitor=monitor, manifests=manifests,
                       pod_runner=pod_runner, progress=progress, chip_var="CUDA_VISIBLE_DEVICES")
JAX = SimpleNamespace(hub=jax_hub, monitor=jax_monitor, manifests=jax_manifests,
                      pod_runner=jax_pod_runner, progress=jax_progress,
                      chip_var="TPU_VISIBLE_DEVICES")

# the JAX runner's messages that speak of a TPU, and the port's in their place
TPU_TO_GPU = (
    ("(one job per chip; TPU processes cannot share a chip)",
     "(one job per GPU, each given exactly one)"),
    ("TPU device(s) visible", "GPU(s) visible"),
    ("(pre-isolation launch claims every chip)", "(pre-isolation launch sees every GPU)"),
)


def _normalize(out, root, chips=True):
    """One run's stdout as sorted lines, with its directory, pids and (when
    ``chips`` is False) chip indices replaced, and TPU wording mapped."""
    out = re.sub(r"(pid[ =])\d+", r"\1<pid>", out.replace(str(root), "<dir>"))
    if not chips:
        out = re.sub(r"on chip \d+", "on chip <n>", out)
    for tpu, gpu in TPU_TO_GPU:
        out = out.replace(tpu, gpu)
    return sorted(out.splitlines())


def _both(tmp_path, capsys, scenario, chips=True):
    """Run ``scenario(package, root)`` for the port and then the JAX package,
    each in a directory of its own; returns ``(port, jax)`` pairs of
    (result, normalized stdout)."""
    runs = []
    for name, pkg in (("port", PORT), ("jax", JAX)):
        root = tmp_path / name
        root.mkdir()
        capsys.readouterr()
        result = scenario(pkg, root)
        runs.append((result, _normalize(capsys.readouterr().out, root, chips)))
    return runs


def _adopted_sleeper(seconds):
    """A process the registry adopts, reaped from a thread the moment it
    exits: as the test's child it would otherwise linger as a zombie that
    os.kill(pid, 0) still sees as alive (production adopted pids are not
    the pod runner's children)."""
    p = subprocess.Popen([sys.executable, "-c", f"import time; time.sleep({seconds})"])
    threading.Thread(target=p.wait, daemon=True).start()
    return p


def test_shard_status_taxonomy():
    shard_status = monitor.shard_status
    assert shard_status({"completed": [], "failed": []}, 10)["status"] == "not_started"
    s = shard_status({"completed": ["a"], "failed": []}, 4)
    assert s["status"] == "in_progress (1/4, 25.0%)"
    assert shard_status({"completed": list("abcd"), "failed": []}, 4)["status"] == "completed"
    cases = [
        ({"completed": [], "failed": []}, 10),
        ({"completed": ["a"], "failed": []}, 4),
        ({"completed": list("abcd"), "failed": []}, 4),
        ({"completed": list("abcde"), "failed": ["f"]}, 4),
        ({"completed": [], "failed": ["x"]}, 3),
        ({"completed": ["a", "b"], "failed": [], "shard_id": "en007"}, 3),
        ({"completed": ["a"], "failed": [], "meta": {"done": True}}, None),
        ({"completed": ["a"], "failed": ["b"]}, None),
        ({"completed": [], "failed": [], "updated_at": 12.5}, None),
        ({}, 0),
    ]
    for state, expected in cases:
        assert shard_status(state, expected) == jax_monitor.shard_status(state, expected)


def test_scan_verify_missing(tmp_path, capsys):
    def scenario(m, root):
        prog_dir = str(root / "prog")
        p = m.progress.ShardProgress(prog_dir, "en000")
        p.mark_completed("00000000")
        p.mark_completed("00000001")
        p.mark_failed("00000002")
        m.progress.ShardProgress(prog_dir, "en001").mark_completed("00000000")
        hub = m.hub.LocalHub(str(root / "hub"))
        src = root / "f.json"
        src.write_text("{}")
        hub.upload_file(str(src), "data/en000/00000000.json")
        rows = m.monitor.scan_progress_dir(prog_dir, {"en000": 3})
        for r in rows:
            r.pop("updated_at")  # the ledger's write time
        problems = m.monitor.verify_against_hub(prog_dir, hub, "data/{shard}/{unit}.json")
        missing = m.monitor.missing_report(
            {"en000": ["00000000", "00000005"], "en001": ["00000000"]}, hub,
            "data/{shard}/{unit}.json",
        )
        return rows, problems, missing

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    rows, problems, missing = port
    assert rows[0]["shard_id"] == "en000"
    assert rows[0]["completed"] == 2 and rows[0]["failed"] == 1
    assert [pr["unit"] for pr in problems if pr["shard"] == "en000"] == ["00000001"]
    assert missing["en000"] == ["00000005"]


def test_monitor_cli_status_and_list_incomplete(tmp_path, capsys):
    def scenario(m, root):
        prog_dir = str(root / "prog")
        m.progress.ShardProgress(prog_dir, "s1").mark_completed("u0")
        m.progress.ShardProgress(prog_dir, "s2").save()
        exp = root / "exp.json"
        exp.write_text(json.dumps({"s1": 1, "s2": 5}))
        inc = str(root / "inc.txt")
        m.monitor.main(
            ["status", "--progress-dir", prog_dir, "--expected", str(exp),
             "--list-incomplete", inc]
        )
        return open(inc).read()

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    assert "-- 1/2 shards completed" in port_out
    assert port.strip() == "s2"


def test_monitor_cli_verify_and_missing(tmp_path, capsys):
    """The verify and missing subcommands (with --save-missing) print, save
    and exit the same in both packages, on a hub missing one unit."""
    def scenario(m, root):
        prog_dir = str(root / "prog")
        p = m.progress.ShardProgress(prog_dir, "en000")
        p.mark_completed("u0")
        p.mark_completed("u1")
        hub = m.hub.LocalHub(str(root / "hub"))
        src = root / "f.json"
        src.write_text("{}")
        hub.upload_file(str(src), "data/en000/u0.json")
        exp = root / "exp.json"
        exp.write_text(json.dumps({"en000": ["u0", "u1", "u2"], "en001": ["u0"]}))
        saved = str(root / "missing.json")
        template = "data/{shard}/{unit}.json"
        rcs = (
            m.monitor.main(["verify", "--progress-dir", prog_dir, "--hub", f"dir:{root / 'hub'}",
                            "--template", template]),
            m.monitor.main(["missing", "--expected", str(exp), "--hub", f"dir:{root / 'hub'}",
                            "--template", template, "--save-missing", saved]),
        )
        return rcs, json.load(open(saved))

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    assert port == ((1, 1), {"en000": ["u1", "u2"], "en001": ["u0"]})


def test_pod_runner_fanout_and_skip(tmp_path, capsys):
    def scenario(m, root):
        shard_list = root / "shards.txt"
        shard_list.write_text("s1\ns2\ns3\n")
        run_dir, log_dir, prog_dir = (str(root / d) for d in ("run", "logs", "prog"))
        p = m.progress.ShardProgress(prog_dir, "s2")  # completed via meta.done
        p.meta["done"] = True
        p.save()
        marker_dir = root / "markers"
        marker_dir.mkdir()
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "2",
            "--poll-seconds", "0.1",
            "--run-dir", run_dir,
            "--log-dir", log_dir,
            "--progress-dir", prog_dir,
            "--wait",
            "--",
            sys.executable, "-c",
            f"open(r'{marker_dir}'+'/{{shard}}.done','w').write('ok'); print('ran {{shard}}')",
        ])
        logs = {f: open(os.path.join(log_dir, f)).read() for f in sorted(os.listdir(log_dir))}
        return rc, sorted(os.listdir(marker_dir)), logs, json.load(open(os.path.join(run_dir, "jobs.json")))

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    rc, markers, logs, jobs = port
    assert rc == 0
    assert markers == ["s1.done", "s3.done"]  # s2 skipped
    assert "ran s1" in logs["s1.log"]
    assert jobs == {}  # pidfile cleaned up as jobs exit


def test_pod_runner_adopted_jobs_count_toward_throttle(tmp_path, capsys):
    """A still-alive job adopted from the pidfile registry occupies a
    concurrency slot: a rerun with max-concurrent=1 must wait for it to
    exit before launching the next shard (it could otherwise oversubscribe
    the GPU)."""
    def scenario(m, root):
        run_dir = str(root / "run")
        adopted = _adopted_sleeper(1.2)
        m.pod_runner._save_jobs(run_dir, {"s_old": adopted.pid})
        shard_list = root / "shards.txt"
        shard_list.write_text("s_new\n")
        marker = root / "marker"
        t0 = time.perf_counter()
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "1",
            "--poll-seconds", "0.1",
            "--run-dir", run_dir,
            "--log-dir", str(root / "logs"),
            "--wait",
            "--",
            sys.executable, "-c", f"open(r'{marker}','w').write('{{shard}}')",
        ])
        waited = time.perf_counter() - t0 >= 1.0
        adopted.wait()
        return rc, marker.read_text(), waited

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    # did launch, but only after the adopted job exited
    assert port == (0, "s_new", True), "launched while the adopted job still held the slot"


def test_manifest_generation(tmp_path, capsys):
    def scenario(m, root):
        hub = m.hub.LocalHub(str(root / "hub2"))
        f = root / "x.json"
        f.write_text("{}")
        for shard, n in (("en000", 3), ("en001", 1)):
            for i in range(n):
                hub.upload_file(str(f), f"data/{shard}/{i:08d}.json")
        hub.upload_file(str(f), "data/README.json")  # not a shard's unit
        shards = m.manifests.shard_list_from_hub(hub, "data/")
        counts = m.manifests.unit_counts_from_hub(hub, "data/")
        out = str(root / "list.txt")
        m.manifests.write_shard_list(shards, out)
        return shards, counts, open(out).read()

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    shards, counts, listed = port
    assert shards == ["en000", "en001"]
    assert counts == {"en000": 3, "en001": 1}
    assert listed == "en000\nen001\n"


def test_monitor_live_workdir(tmp_path, capsys):
    def scenario(m, root):
        work = root / "work" / "en000"
        work.mkdir(parents=True)
        (work / "00000001.out.json").write_text(
            json.dumps([{"audio_id": "a", "codes": {"c": [[1]]}}, {"audio_id": "b"}])
        )
        (work / "00000002.out.json").write_text(json.dumps([{"audio_id": "c", "codes": {}}]))
        (work / "00000003.out.json.tmp.9").write_text("[")  # an unfinished write
        rep = m.monitor.live_workdir_report(str(root / "work"))
        return rep, m.monitor.main(["live", "--work-dir", str(root / "work")])

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    rep, rc = port
    assert rep[0] == {
        "file": "en000/00000001.out.json",
        "entries": 2,
        "encoded": 1,
        "complete": False,
    }
    assert rc == 0 and '  "encoded": 1,' in port_out


def test_pod_runner_single_chip_warning(tmp_path, capsys, monkeypatch):
    """--max-concurrent above the visible GPU count warns about contention
    (one encoder process per GPU) and still runs."""
    import argparse

    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "1")

    def scenario(m, root):
        lst = root / "shards.txt"
        lst.write_text("")  # no shards: run() returns after the guard
        args = argparse.Namespace(
            shard_list=str(lst),
            log_dir=str(root / "logs"),
            run_dir=str(root / "run"),
            progress_dir=None,
            max_concurrent=4,
            poll_seconds=0.01,
            cmd=["true"],
            wait=False,
            chips=None,
            chip_env=list(m.pod_runner.DEFAULT_CHIP_ENV),
            walltime=None,
            kill_grace=30.0,
        )
        return m.pod_runner.run(args)

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref == 0 and port_out == ref_out
    assert any("but only 1 GPU(s) visible" in ln and "contend for the same chip" in ln
               for ln in port_out)


def test_pod_runner_status(tmp_path, capsys):
    def scenario(m, root):
        run_dir = str(root / "run")
        live = _adopted_sleeper(5)
        m.pod_runner._save_jobs(
            run_dir, {"s1": {"pid": live.pid, "chip": 2}, "s2": 99999999}  # v2 + v1 entries
        )
        rc = m.pod_runner.main(["status", "--run-dir", run_dir])
        live.kill()
        empty = m.pod_runner.main(["status", "--run-dir", str(root / "none")])
        return rc, empty

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref == (0, 0) and port_out == ref_out
    assert "s1\tpid=<pid>\tchip=2\tage=0s\trunning" in port_out
    assert "s2\tpid=<pid>\tchip=-\tage=0s\tdead" in port_out
    assert "[pod-runner] no registered jobs" in port_out


def test_pod_runner_registry_and_cancel(tmp_path, capsys, monkeypatch):
    """Without --wait the runner leaves a jobs.json of the same form as the
    JAX runner's (pid, chip and launch time per shard), ``status`` reads it
    the same, and ``cancel`` on a registry of exited jobs empties it."""
    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "2")

    def scenario(m, root):
        run_dir = str(root / "run")
        shard_list = root / "shards.txt"
        shard_list.write_text("s1\ns2\n")
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "2",
            "--poll-seconds", "0.05",
            "--run-dir", run_dir,
            "--log-dir", str(root / "logs"),
            "--",
            sys.executable, "-c", "import time; time.sleep(60)",
        ])
        jobs = json.load(open(os.path.join(run_dir, "jobs.json")))
        m.pod_runner.main(["status", "--run-dir", run_dir])
        for j in jobs.values():
            os.kill(j["pid"], signal.SIGKILL)
            os.waitpid(j["pid"], 0)
        m.pod_runner.main(["cancel", "--run-dir", run_dir])
        left = json.load(open(os.path.join(run_dir, "jobs.json")))
        return rc, {s: sorted(j) + [j["chip"]] for s, j in jobs.items()}, left

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    assert port == (0, {"s1": ["chip", "pid", "t0", 0], "s2": ["chip", "pid", "t0", 1]}, {})
    assert "s2\tpid=<pid>\tchip=1\tage=0s\trunning" in port_out
    assert "[pod-runner] killed 0 jobs" in port_out


def test_pod_runner_unknown_chip_adoptee_blocks_isolated_launches(tmp_path, capsys,
                                                                  monkeypatch):
    """An adopted job with an UNKNOWN chip (v1 registry / pre-isolation
    launch) was started with no CUDA_VISIBLE_DEVICES restriction — it sees
    every GPU — so isolated launches must wait for it, not grab 'free'
    GPUs it may be using."""
    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "2")

    def scenario(m, root):
        run_dir = str(root / "run")
        adopted = _adopted_sleeper(1.2)
        m.pod_runner._save_jobs(run_dir, {"s_old": adopted.pid})  # v1 bare pid: chip unknown
        shard_list = root / "shards.txt"
        shard_list.write_text("s_new\n")
        marker = root / "marker"
        t0 = time.perf_counter()
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "2",  # a slot IS free — but no known chip
            "--poll-seconds", "0.1",
            "--run-dir", run_dir,
            "--log-dir", str(root / "logs"),
            "--wait",
            "--",
            sys.executable, "-c",
            f"import os; open(r'{marker}','w').write(os.environ['{m.chip_var}'])",
        ])
        waited = time.perf_counter() - t0 >= 1.0
        adopted.wait()
        return rc, marker.read_text(), waited

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    assert port[0] == 0 and port[1] in {"0", "1"}
    assert port[2], "launched while an all-GPU adoptee was alive"


def test_pod_runner_per_chip_isolation(tmp_path, capsys, monkeypatch):
    """On a multi-GPU host every concurrent job gets an EXCLUSIVE GPU via
    env (the reference's one-GPU-per-job Slurm isolation,
    yodas2-mimi/submit/job_template.sh:3-15), the throttle caps at the GPU
    count, and GPUs are reused once freed."""
    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "2")

    def scenario(m, root):
        marker_dir = root / "markers"
        marker_dir.mkdir()
        shard_list = root / "shards.txt"
        shard_list.write_text("s1\ns2\ns3\n")
        code = (
            "import os, time; "
            f"open(r'{marker_dir}'+'/{{shard}}.chip','w').write(os.environ['{m.chip_var}']); "
            "time.sleep(0.5)"
        )
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "4",  # must cap to the 2 GPUs
            "--poll-seconds", "0.05",
            "--run-dir", str(root / "run"),
            "--log-dir", str(root / "logs"),
            "--wait",
            "--",
            sys.executable, "-c", code,
        ])
        chips = {s: (marker_dir / f"{s}.chip").read_text() for s in ("s1", "s2", "s3")}
        # the third reuses whichever GPU freed first, in either package
        return rc, {chips["s1"], chips["s2"]}, chips["s3"] in {"0", "1"}

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario, chips=False)
    assert port == ref and port_out == ref_out
    # first two run concurrently (cap 2) on disjoint GPUs
    assert port == (0, {"0", "1"}, True)
    assert "[pod-runner] capping --max-concurrent=4 to 2 (one job per GPU, each given exactly one)" \
        in port_out


def test_pod_runner_walltime_kills_hung_job(tmp_path, capsys):
    """A job exceeding --walltime is SIGTERMed so its slot/GPU frees and
    the queue keeps draining (the reference's Slurm walltime,
    yodas2-mimi/submit/job_template.sh:5). The hung child here would sleep
    for minutes; the well-behaved one must still get to run."""
    def scenario(m, root):
        shard_list = root / "shards.txt"
        shard_list.write_text("hung\nquick\n")
        marker_dir = root / "markers"
        marker_dir.mkdir()
        code = (
            "import time, sys; "
            f"open(r'{marker_dir}'+'/{{shard}}.start','w').write('x'); "
            "time.sleep(120 if '{shard}' == 'hung' else 0); "
            f"open(r'{marker_dir}'+'/{{shard}}.done','w').write('x')"
        )
        t0 = time.perf_counter()
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "1",  # hung job must free the only slot
            "--poll-seconds", "0.05",
            # the walltime clock starts at launch, so the budget must clear
            # child startup; -S below skips sitecustomize, as the JAX
            # package's test does
            "--walltime", "5.0",
            "--kill-grace", "5.0",
            "--run-dir", str(root / "run"),
            "--log-dir", str(root / "logs"),
            "--wait",
            "--",
            sys.executable, "-S", "-c", code,
        ])
        wall = time.perf_counter() - t0
        assert wall < 60, f"walltime enforcement too slow ({wall:.1f}s)"
        return rc, sorted(os.listdir(marker_dir)), json.load(open(root / "run" / "jobs.json"))

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref and port_out == ref_out
    # hung killed mid-sleep; slot freed, queue drained; registry drained
    assert port == (0, ["hung.start", "quick.done", "quick.start"], {})
    assert "[pod-runner] shard hung exited with -15" in port_out


def test_pod_runner_walltime_sigkill_escalation(tmp_path, capsys):
    """A job that ignores SIGTERM is SIGKILLed after --kill-grace."""
    def scenario(m, root):
        shard_list = root / "shards.txt"
        shard_list.write_text("stubborn\n")
        marker = root / "armed"
        # -S skips sitecustomize, so the handler installs milliseconds after
        # launch — well inside the 3 s budget (else the TERM kills the bare
        # child outright and the escalation branch this test exists to cover
        # never runs)
        code = (
            "import signal, time; "
            "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
            f"open(r'{marker}','w').write('x'); "
            "time.sleep(120)"
        )
        t0 = time.perf_counter()
        rc = m.pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "1",
            "--poll-seconds", "0.05",
            "--walltime", "3.0",
            "--kill-grace", "1.0",
            "--run-dir", str(root / "run"),
            "--log-dir", str(root / "logs"),
            "--wait",
            "--",
            sys.executable, "-S", "-c", code,
        ])
        wall = time.perf_counter() - t0
        assert wall < 60, f"SIGKILL escalation too slow ({wall:.1f}s)"
        assert marker.exists(), "child never armed its SIGTERM handler"
        return rc, json.load(open(root / "run" / "jobs.json"))

    (port, port_out), (ref, ref_out) = _both(tmp_path, capsys, scenario)
    assert port == ref == (0, {}) and port_out == ref_out
    # the escalation branch must actually have fired — without this the
    # test can pass vacuously when the TERM kills a slow-starting child
    assert any("sending SIGKILL" in ln for ln in port_out)
    assert "[pod-runner] shard stubborn exited with -9" in port_out


def _child_error(report):
    """A failed chip check's error with its device count and injected env
    taken out, and the JAX wording of the host mapped to the port's."""
    return re.sub(r"enumerated \d+ devices under \{.*?\}", "enumerated <n> devices under <env>",
                  report["error"]).replace("this fabric", "this host")


def test_chip_check_single_device_contract():
    """chip_check spawns a child under the pod runner's injected GPU env and
    passes iff the child enumerates exactly ONE device and computes. On the
    CPU: with the platform hook the child counts the CPU as its one device
    and passes; a child that sees no GPU (an empty CUDA_VISIBLE_DEVICES, on
    any host) fails with the --chip-env guidance. The JAX check, on its own
    CPU children (one and eight virtual devices), gives reports of the same
    form and verdicts."""
    ok = chip_check.check_chip(
        chip=0,
        templates=("CUDA_VISIBLE_DEVICES={chip}",),
        force_platform="cpu",
        timeout=120,
    )
    assert ok["ok"] and ok["child"]["n_devices"] == 1 and ok["child"]["compute_ok"]
    assert ok["injected_env"] == {"CUDA_VISIBLE_DEVICES": "0"}

    bad = chip_check.check_chip(chip=0, templates=("CUDA_VISIBLE_DEVICES=",), timeout=120)
    assert not bad["ok"] and bad["child"]["n_devices"] == 0
    assert not bad["child"]["compute_ok"]
    assert "--chip-env" in bad["error"]

    ref_ok, ref_bad = (
        jax_chip_check.check_chip(
            chip=0, templates=(f"XLA_FLAGS=--xla_force_host_platform_device_count={n}",),
            force_platform="cpu", timeout=120,
        )
        for n in (1, 8)
    )
    assert sorted(ok) == sorted(ref_ok) and sorted(ok["child"]) == sorted(ref_ok["child"])
    for key in ("ok", "chip"):
        assert ok[key] == ref_ok[key] and bad[key] == ref_bad[key]
    for key in ("n_devices", "platform", "compute_ok"):
        assert ok["child"][key] == ref_ok["child"][key]
    assert sorted(bad) == sorted(ref_bad)
    assert _child_error(bad) == _child_error(ref_bad)


def test_chip_check_cli_exit_codes(capsys):
    """The CLI prints one JSON line and exits 0/1 on pass/fail, as the JAX
    package's does."""
    old = dict(os.environ)
    os.environ["TOKENIZE_AUDIO_CHIP_CHECK_PLATFORM"] = "cpu"
    try:
        rc = chip_check.main(["--timeout", "120"])  # the default chip env
        port_out = capsys.readouterr().out.strip().splitlines()
        ref_rc = jax_chip_check.main(
            ["--chip-env", "XLA_FLAGS=--xla_force_host_platform_device_count=1",
             "--timeout", "120"]
        )
        ref_out = capsys.readouterr().out.strip().splitlines()
    finally:
        os.environ.clear()
        os.environ.update(old)
    assert rc == ref_rc == 0 and len(port_out) == len(ref_out) == 1
    rep, ref = json.loads(port_out[0]), json.loads(ref_out[0])
    assert rep["ok"] and rep["injected_env"] == {"CUDA_VISIBLE_DEVICES": "0"}
    assert sorted(rep) == sorted(ref) and rep["ok"] == ref["ok"]

    rc = chip_check.main(["--chip-env", "CUDA_VISIBLE_DEVICES=", "--timeout", "120"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(out) == 1 and not json.loads(out[0])["ok"]


def test_gpu_count_without_a_cuda_context(monkeypatch):
    """The runner counts GPUs from TOKENIZE_AUDIO_TPU_DEVICES, else from the
    /dev/nvidia<N> nodes narrowed by CUDA_VISIBLE_DEVICES, and never asks
    torch.cuda (a context would hold memory on GPU 0 for the whole run)."""
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("GPU counting touched torch.cuda")

    for name in ("_lazy_init", "init", "device_count", "is_available", "get_device_name"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.delenv("TOKENIZE_AUDIO_TPU_DEVICES", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    pod_runner._visible_gpu_devices()  # this host's real node scan
    monkeypatch.setattr(pod_runner, "_gpu_nodes", lambda: [f"/dev/nvidia{i}" for i in range(4)])
    assert pod_runner._visible_gpu_devices() == 4
    for visible, want in (("2", 1), ("0,3", 2), ("1,7,2", 1), ("", None), ("-1", None),
                          ("GPU-1a2b,GPU-3c4d", 2)):
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
        assert pod_runner._visible_gpu_devices() == want, visible
    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "8")  # the override wins
    assert pod_runner._visible_gpu_devices() == 8
    monkeypatch.setenv("TOKENIZE_AUDIO_TPU_DEVICES", "many")
    assert pod_runner._visible_gpu_devices() is None
    monkeypatch.delenv("TOKENIZE_AUDIO_TPU_DEVICES")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    monkeypatch.setattr(pod_runner, "_gpu_nodes", lambda: [])
    assert pod_runner._visible_gpu_devices() is None


def test_gpu_nodes_skip_the_ones_the_runtime_refuses(monkeypatch):
    """A container may hold the nodes of GPUs it was not given (a card
    machine had /dev/nvidia0 and /dev/nvidia2, with only the second
    openable): only the GPU nodes this process may open count."""
    listed = ["/dev/nvidia0", "/dev/nvidia2", "/dev/nvidiactl", "/dev/nvidia-uvm",
              "/dev/nvidia-uvm-tools", "/dev/nvidia-modeset"]
    opened = []

    def fake_open(path, flags):
        if path == "/dev/nvidia0":
            raise PermissionError(1, "Operation not permitted")
        opened.append(path)
        return -1

    with monkeypatch.context() as m:
        m.setattr(pod_runner.glob, "glob", lambda pattern: listed)
        m.setattr(pod_runner.os, "open", fake_open)
        m.setattr(pod_runner.os, "close", lambda fd: None)
        nodes = pod_runner._gpu_nodes()
    assert nodes == ["/dev/nvidia2"] and opened == ["/dev/nvidia2"]


@pytest.mark.parametrize("visible, want", [
    ("2,3", ["2", "3"]),
    ("GPU-1a2b,GPU-3c4d", ["GPU-1a2b", "GPU-3c4d"]),
    (None, ["0", "1"]),
], ids=["index_list", "uuid_list", "unset"])
def test_jobs_stay_inside_a_narrowed_allocation(tmp_path, monkeypatch, visible, want):
    """With the runner's own CUDA_VISIBLE_DEVICES set, job ``chip`` gets the
    chip-th GPU of that allocation (an index or a UUID), never physical GPU
    ``chip`` (``2,3`` gives jobs 2 and 3, not 0 and 1); unset, the raw
    index as before. Held for the pod runner's jobs and for chip_check's
    child (an index past the allocation gives no GPU)."""
    monkeypatch.setattr(pod_runner, "_gpu_nodes", lambda: [f"/dev/nvidia{i}" for i in range(4)])
    monkeypatch.delenv("TOKENIZE_AUDIO_TPU_DEVICES", raising=False)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    marker_dir = tmp_path / "markers"
    marker_dir.mkdir()
    (tmp_path / "shards.txt").write_text("s1\ns2\n")
    code = ("import os, time; "
            f"open(r'{marker_dir}'+'/{{shard}}.chip','w').write(os.environ['CUDA_VISIBLE_DEVICES']); "
            "time.sleep(0.5)")
    rc = pod_runner.main([
        "run", "--shard-list", str(tmp_path / "shards.txt"), "--max-concurrent", "2",
        "--poll-seconds", "0.05", "--run-dir", str(tmp_path / "run"),
        "--log-dir", str(tmp_path / "logs"), "--wait", "--", sys.executable, "-c", code,
    ])
    assert rc == 0
    assert sorted((marker_dir / f"{s}.chip").read_text() for s in ("s1", "s2")) == want
    assert pod_runner._visible_gpu_devices() == (2 if visible else 4)
    report = chip_check.check_chip(chip=1, force_platform="cpu", timeout=120)
    assert report["ok"] and report["injected_env"] == {"CUDA_VISIBLE_DEVICES": want[1]}
    past = pod_runner._chip_env(pod_runner.DEFAULT_CHIP_ENV, 2)
    assert past == {"CUDA_VISIBLE_DEVICES": "" if visible else "2"}


FLEET_CHILD = os.path.join(os.path.dirname(__file__), "torch_fleet_child.py")


def test_pod_runner_drives_port_yodas2_shards(tmp_path, capsys):
    """The pod runner fans the port's YODAS2 command line out over two
    shards at once (tiny config, seeded random weights, CPU children): both
    complete onto the hub with their ledgers done, and a rerun over the
    progress ledgers launches nothing."""
    import numpy as np

    from torch_yodas2_mirror import Entry, noise_pcm, write_mirror

    rng = np.random.default_rng(0)
    mirror = str(tmp_path / "mirror")
    for shard in ("en000", "en001"):
        write_mirror(mirror, shard, [
            [Entry(f"{shard}-{s}-{a}", noise_pcm(rng, 36_000), 24_000, "wav",
                   [(0, 100), (50, 150)]) for a in range(2)]
            for s in range(2)
        ])
    hub, prog = str(tmp_path / "hub"), str(tmp_path / "prog")
    shard_list = tmp_path / "shards.txt"
    shard_list.write_text("en000\nen001\n")

    def run(tag):
        return pod_runner.main([
            "run",
            "--shard-list", str(shard_list),
            "--max-concurrent", "2",
            "--poll-seconds", "0.2",
            "--chips", "0",  # CPU children: no per-GPU env
            "--walltime", "300",
            "--run-dir", str(tmp_path / tag / "run"),
            "--log-dir", str(tmp_path / tag / "logs"),
            "--progress-dir", prog,
            "--wait",
            "--",
            sys.executable, FLEET_CHILD, "--shard-id", "{shard}",
            "--source", f"dir:{mirror}", "--hub", f"dir:{hub}", "--progress-dir", prog,
            "--work-dir", str(tmp_path / "work" / "{shard}"),
            "--batch-size", "4", "--max-chunk-seconds", "2",
        ])

    assert run("first") == 0
    assert "launched=2 skipped=0" in capsys.readouterr().out
    for shard in ("en000", "en001"):
        log = (tmp_path / "first" / "logs" / f"{shard}.log").read_text()
        report = json.loads([ln for ln in log.splitlines() if ln.startswith("{")][-1])
        assert report["processed"] == 2 and report["failed"] == 0, log[-2000:]
        for s in range(2):
            entries = json.load(open(os.path.join(hub, "data", shard, f"{s:08d}.json")))
            assert len(entries) == 2
            for e in entries:
                assert len(e["codes"]) == 2
                for codes in e["codes"].values():
                    assert np.asarray(codes).shape[0] == 12
        state = json.load(open(os.path.join(prog, f"{shard}_progress.json")))
        assert len(state["completed"]) == 2 and state["meta"]["done"]

    assert run("rerun") == 0
    out = capsys.readouterr().out
    assert "en000: already completed" in out and "en001: already completed" in out
    assert "launched=0 skipped=2" in out
    assert not os.listdir(tmp_path / "rerun" / "logs")
    # the JAX monitor reads the port's ledgers and hub as the port's does
    rows = monitor.scan_progress_dir(prog, {"en000": 2, "en001": 2})
    assert rows == jax_monitor.scan_progress_dir(prog, {"en000": 2, "en001": 2})
    assert [r["status"] for r in rows] == ["completed", "completed"]
    template = "data/{shard}/{unit}.json"
    assert monitor.verify_against_hub(prog, port_hub.LocalHub(hub), template) == []
    assert jax_monitor.verify_against_hub(prog, jax_hub.LocalHub(hub), template) == []
