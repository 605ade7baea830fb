"""A pod-runner job for the PyTorch port's fleet test (tests/test_torch_runner.py):
the port's YODAS2 command line (``datasets.yodas2.main``) at the tiny oracle
config on the CPU (without ``--params``: the CLI's seeded random weights at
that config). The arguments are the CLI's own; ``--device cpu`` is appended.
Imports nothing of JAX. Run only via the test."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# tests/mimi_fixtures.tiny_hf_config's dims (that module imports the JAX package)
TINY = dict(
    num_filters=8,
    hidden_size=32,
    num_hidden_layers=2,
    intermediate_size=64,
    num_attention_heads=4,
    num_key_value_heads=4,
    head_dim=8,
    codebook_size=64,
    codebook_dim=16,
    vector_quantization_hidden_dimension=16,
    num_quantizers=12,
    upsample_groups=32,
)


def main():
    from tokenize_audio_tpu_torch import cli
    from tokenize_audio_tpu_torch.datasets import yodas2
    from tokenize_audio_tpu_torch.mimi import MimiConfig

    tiny = MimiConfig(**TINY)
    cli.MimiConfig = lambda **kw: dataclasses.replace(tiny, **kw)
    yodas2.MimiConfig = lambda: tiny
    yodas2.main(sys.argv[1:] + ["--device", "cpu"])


if __name__ == "__main__":
    main()
