"""The pipeline benchmark is a package CLI — ``python -m
tokenize_audio_tpu_torch.benchmark --pipeline``. This forwards to it, with
any further arguments (``--device cpu`` among them)."""

import sys

from tokenize_audio_tpu_torch.benchmark import main

if __name__ == "__main__":
    sys.exit(main(["--pipeline"] + sys.argv[1:]))
