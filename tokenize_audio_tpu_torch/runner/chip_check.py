"""Launch-time validation of per-GPU job isolation (VERDICT r3 #4).

The pod runner gives every shard job an exclusive GPU via env
(``CUDA_VISIBLE_DEVICES={chip}``, pod_runner.DEFAULT_CHIP_ENV, ``{chip}`` taken
inside the parent's own ``CUDA_VISIBLE_DEVICES`` where that is set) — what the
reference's ``#SBATCH --gres=gpu:1`` sets for each job
(yodas2-mimi/submit/job_template.sh:3). Whether a host's container runtime
and GPU stack honor that var is deployment-dependent, so this check spawns a
child with EXACTLY the env the pod runner would inject and requires it to

  1. enumerate exactly one CUDA device, and
  2. complete a tiny computation on it.

Run it once at provisioning time on each host class::

    python -m tokenize_audio_tpu_torch.runner.chip_check [--chip 0]
        [--chip-env VAR={chip} ...] [--timeout 900]

Prints one JSON line; exit 0 iff the isolation contract holds. If a
host ignores the default var, find the ones it honors and pass the
same ``--chip-env`` overrides to the pod runner.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import Optional, Sequence

from tokenize_audio_tpu_torch.runner.pod_runner import DEFAULT_CHIP_ENV, _chip_env

# Child payload: count the CUDA devices under the injected env and run a
# tiny op on the first. Kept to torch alone (no package import) so the
# check also works from a bare deployment image.
_CHILD = r"""
import json, os
import torch
if os.environ.get("TOKENIZE_AUDIO_CHIP_CHECK_PLATFORM") == "cpu":
    # test hook, only when asked: the CPU counts as the one device
    n, dev, name = 1, "cpu", "cpu"
else:
    n = torch.cuda.device_count()
    dev, name = "cuda:0", (torch.cuda.get_device_name(0) if n else None)
ok = bool(n) and float((torch.arange(8.0, device=dev) * 2).sum()) == 56.0
print(json.dumps({
    "n_devices": n,
    "platform": ("gpu" if dev.startswith("cuda") else dev) if n else None,
    "device0": name,
    "compute_ok": ok,
}))
"""


def check_chip(
    chip: int = 0,
    templates: Sequence[str] = DEFAULT_CHIP_ENV,
    timeout: float = 900.0,
    force_platform: Optional[str] = None,
    extra_env: Optional[dict] = None,
) -> dict:
    """Spawn a child under the pod runner's chip env and validate the
    single-device contract. Returns a report dict with ``ok`` True iff
    the child saw exactly one device and computed on it."""
    injected = _chip_env(templates, chip)
    env = dict(os.environ)
    env.update(injected)
    if force_platform:
        env["TOKENIZE_AUDIO_CHIP_CHECK_PLATFORM"] = force_platform
    if extra_env:
        env.update(extra_env)
    report: dict = {"chip": chip, "injected_env": injected}
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD],
            env=env,
            capture_output=True,
            text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        report.update(ok=False, error=f"child stalled >{timeout}s (wedged claim?)")
        return report
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        report.update(
            ok=False,
            error=f"child rc={proc.returncode}",
            stderr_tail=proc.stderr[-500:],
        )
        return report
    child = json.loads(lines[-1])
    report["child"] = child
    report["ok"] = child["n_devices"] == 1 and child["compute_ok"]
    if not report["ok"] and child["n_devices"] != 1:
        report["error"] = (
            f"child enumerated {child['n_devices']} devices under "
            f"{injected} — this host ignores those vars; find the ones "
            "it honors and pass them to the pod runner via --chip-env"
        )
    elif not report["ok"]:
        report["error"] = (
            "child enumerated exactly one device but its compute "
            "check failed (compute_ok=false) — the GPU claims but "
            "miscomputes; see report['child'] for the device string"
        )
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tokenize_audio_tpu_torch.runner.chip_check", description=__doc__
    )
    ap.add_argument("--chip", type=int, default=0)
    ap.add_argument(
        "--chip-env",
        action="append",
        default=None,
        metavar="VAR={chip}",
        help="env template(s) to test instead of the pod runner defaults",
    )
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    report = check_chip(
        chip=args.chip,
        templates=args.chip_env or DEFAULT_CHIP_ENV,
        timeout=args.timeout,
    )
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
