"""Readings of the correctness check over many seeds in one process: the
program as the configuration states it ("sound"), and the program with a
lower-precision path of its own switched on ("tf32": TF32 convolutions and
matmuls, the nearest precision below IEEE float32; "bf16": bfloat16
compute). The limits in ``cells/<cell>.json`` are set between the sound
runs' largest reading and the control's smallest.

    python3 port_bench/control.py --workload engine-web.8cb --seeds 1,2,3 \
        --modes sound,tf32 --seconds 5 [--out readings.json]

Each (mode, seed) builds the cell from its seed, runs a window of
``--seconds`` at the cell's own load and sizes, and prints one JSON line
with the compared numbers and the window's end-to-end metrics. It needs
the CUDA devices the cell asks for.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MODES = {
    "sound": {},
    "tf32": {"matmul_precision": "high"},
    "bf16": {"compute_dtype": "bfloat16"},
}


def main(argv=None) -> int:
    sys.path[:0] = [HERE, ROOT]
    import torch

    from pbkit import manifest, runner

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--modes", default="sound,tf32", help=f"comma-separated, of {sorted(MODES)}")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None, help="also append every line to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.Manifest(ROOT)
    cell = man.cell(args.workload)
    mix = man.traffic(cell.traffic)
    drv = runner.driver(mix["driver"])
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            workdir = tempfile.mkdtemp(prefix="port_bench_control_")
            try:
                run = runner.Run(cell.name, man.config(cell.config), mix, man.cell_params(cell.name),
                                 seed, args.seconds, torch.device("cuda", 0), workdir, MODES[mode])
                result = runner.execute(run, drv, False, time.perf_counter())
                line = {
                    "workload": cell.name, "mode": mode, "seed": seed,
                    "checks": {k: v["value"] for k, v in result["checks"].items()},
                    "sampled": result["sampled"], "attempted": result["attempted"],
                    "metrics": {k: v["value"] for k, v in runner.metrics(man, run, False).items()},
                    "error": run.error,
                }
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
