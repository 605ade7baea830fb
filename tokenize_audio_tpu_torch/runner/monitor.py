"""Progress monitoring and completeness checking.

Capability equivalent of the reference's monitor family (SURVEY §2.1 #24):
``yodas2-mimi/monitor_progress.py`` (per-shard on_hf/local_only/missing
classification, progress vs expected counts, --watch, --verify),
``emilia-mimi/monitor_progress.py`` (status taxonomy + --list-incomplete),
``check_all_completeness.py`` (expected-vs-uploaded set diff with
--save-missing).

One CLI over the generic progress-dir + hub contracts:

    python -m tokenize_audio_tpu_torch.runner.monitor status   --progress-dir P [--expected E.json] [--watch N]
    python -m tokenize_audio_tpu_torch.runner.monitor verify   --progress-dir P --hub H --template T
    python -m tokenize_audio_tpu_torch.runner.monitor missing  --expected E.json --hub H --template T [--save-missing F]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional

from tokenize_audio_tpu_torch.hub import open_hub
from tokenize_audio_tpu_torch.runner.progress import read_json


def shard_status(state: Dict, expected_units: Optional[int] = None) -> Dict:
    """Classify one shard's progress file into the reference taxonomy
    (emilia-mimi/monitor_progress.py:82-126)."""
    completed = len(state.get("completed", []))
    failed = len(state.get("failed", []))
    done_flag = bool(state.get("meta", {}).get("done"))
    if expected_units:
        if completed >= expected_units:
            status = "completed"
        elif completed == 0 and failed == 0:
            status = "not_started"
        else:
            status = f"in_progress ({completed}/{expected_units}, {100*completed/expected_units:.1f}%)"
    else:
        # without expected counts, only an explicit done flag proves
        # completion — progress ledgers exist from the first unit, so a
        # non-empty completed list alone means in_progress
        if done_flag:
            status = "completed"
        elif completed or failed:
            status = "in_progress"
        else:
            status = "not_started"
    return {
        "shard_id": state.get("shard_id", "?"),
        "status": status,
        "completed": completed,
        "failed": failed,
        "updated_at": state.get("updated_at"),
    }


def scan_progress_dir(progress_dir: str, expected: Optional[Dict[str, int]] = None) -> List[Dict]:
    out = []
    for f in sorted(os.listdir(progress_dir)):
        if not f.endswith("_progress.json"):
            continue
        state = read_json(os.path.join(progress_dir, f), {}) or {}
        sid = state.get("shard_id", f[: -len("_progress.json")])
        out.append(shard_status(state, (expected or {}).get(sid)))
    return out


def verify_against_hub(progress_dir: str, hub, template: str) -> List[Dict]:
    """Check every locally-completed unit actually exists on the hub
    (yodas2-mimi/monitor_progress.py --verify). template example:
    'data/{shard}/{unit}.json'."""
    problems = []
    for f in sorted(os.listdir(progress_dir)):
        if not f.endswith("_progress.json"):
            continue
        state = read_json(os.path.join(progress_dir, f), {}) or {}
        shard = state.get("shard_id", "?")
        for unit in state.get("completed", []):
            path = template.format(shard=shard, unit=unit)
            if not hub.exists(path):
                problems.append({"shard": shard, "unit": unit, "missing": path})
    return problems


def missing_report(
    expected: Dict[str, List[str]], hub, template: str
) -> Dict[str, List[str]]:
    """Expected-vs-uploaded set diff per shard
    (emilia-mimi/check_all_completeness.py:34-61)."""
    missing: Dict[str, List[str]] = {}
    for shard, units in expected.items():
        gone = [
            u for u in units if not hub.exists(template.format(shard=shard, unit=u))
        ]
        if gone:
            missing[shard] = gone
    return missing


def live_workdir_report(work_dir: str) -> List[Dict]:
    """Inspect in-flight sub-shard outputs in a work dir, counting encoded
    entries inside each output JSON (yodas2-mimi/monitor_live.py:13-62)."""
    out = []
    for dirpath, _, files in os.walk(work_dir):
        for f in sorted(files):
            if not f.endswith(".out.json") or ".tmp." in f:
                continue
            path = os.path.join(dirpath, f)
            data = read_json(path, [])
            entries = data if isinstance(data, list) else []
            # "codes" present-but-empty still counts as processed (all
            # chunks degenerate) — same done criterion as the pipeline's
            # is_json_complete / resume set (datasets/yodas2.py)
            encoded = sum(1 for e in entries if "codes" in e)
            out.append(
                {
                    "file": os.path.relpath(path, work_dir),
                    "entries": len(entries),
                    "encoded": encoded,
                    "complete": bool(entries) and encoded == len(entries),
                }
            )
    return out


def _print_table(rows: List[Dict]) -> None:
    if not rows:
        print("(no progress files)")
        return
    w = max(len(str(r["shard_id"])) for r in rows) + 2
    print(f"{'SHARD':<{w}}{'STATUS':<34}{'DONE':>6}{'FAIL':>6}")
    for r in rows:
        print(f"{r['shard_id']:<{w}}{r['status']:<34}{r['completed']:>6}{r['failed']:>6}")
    done = sum(1 for r in rows if r["status"] == "completed")
    print(f"-- {done}/{len(rows)} shards completed")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    st = sub.add_parser("status")
    st.add_argument("--progress-dir", required=True)
    st.add_argument("--expected", default=None, help="JSON {shard: n_units}")
    st.add_argument("--watch", type=int, default=0)
    st.add_argument("--list-incomplete", default=None, help="write incomplete shard ids to file")

    vf = sub.add_parser("verify")
    vf.add_argument("--progress-dir", required=True)
    vf.add_argument("--hub", required=True)
    vf.add_argument("--template", required=True)

    ms = sub.add_parser("missing")
    ms.add_argument("--expected", required=True, help="JSON {shard: [unit,...]}")
    ms.add_argument("--hub", required=True)
    ms.add_argument("--template", required=True)
    ms.add_argument("--save-missing", default=None)

    lv = sub.add_parser("live")
    lv.add_argument("--work-dir", required=True)

    args = ap.parse_args(argv)
    if args.cmd == "live":
        report = live_workdir_report(args.work_dir)
        print(json.dumps(report, indent=1))
        return 0
    if args.cmd == "status":
        expected = read_json(args.expected) if args.expected else None
        while True:
            rows = scan_progress_dir(args.progress_dir, expected)
            _print_table(rows)
            if args.list_incomplete:
                inc = [r["shard_id"] for r in rows if r["status"] != "completed"]
                with open(args.list_incomplete, "w") as f:
                    f.write("\n".join(inc) + ("\n" if inc else ""))
                print(f"wrote {len(inc)} incomplete shard ids to {args.list_incomplete}")
            if not args.watch:
                break
            time.sleep(args.watch)
    elif args.cmd == "verify":
        problems = verify_against_hub(args.progress_dir, open_hub(args.hub), args.template)
        print(json.dumps(problems, indent=1))
        return 1 if problems else 0
    else:
        expected = read_json(args.expected, {})
        missing = missing_report(expected, open_hub(args.hub), args.template)
        print(json.dumps(missing, indent=1))
        if args.save_missing:
            with open(args.save_missing, "w") as f:
                json.dump(missing, f)
        return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
