"""The benchmark of ``tokenize_audio_tpu_torch``: run one cell once.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. Prints one JSON result line last on standard output, and the
numbers the correctness check compared, each beside its limit, last on
standard error. ``BENCHMARK.json`` names the cells; ``pbkit/runner.py``
says what a run does.
"""

import os
import sys
import time

_T_IMPORT = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    sys.path[:0] = [HERE, ROOT]
    from pbkit import runner

    return runner.main(argv, root=ROOT, t_import=_T_IMPORT)


if __name__ == "__main__":
    sys.exit(main())
