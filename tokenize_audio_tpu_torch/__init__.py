"""tokenize_audio_tpu_torch — the PyTorch/CUDA port of tokenize_audio_tpu.

The Mimi neural codec encoder on an NVIDIA GPU: SEANet conv stack, RoPE
transformer bottleneck and split residual vector quantization in PyTorch,
with hand-written CUDA kernels for the fused SEANet residual block and the
chained RVQ search. The JAX package ``tokenize_audio_tpu`` stays beside it
as the reference; this package imports nothing of it.

Subpackages
-----------
core      : audio DSP (resample/frame/normalize, length buckets)
mimi      : the PyTorch Mimi encoder, weight conversion from HF checkpoints
ops       : hand-written CUDA kernels and their plain PyTorch versions
engine    : length-bucketed batch encoding engine with throughput metrics

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from tokenize_audio_tpu_torch.config import (  # noqa: F401
    CODEBOOK_SIZE,
    FRAME_RATE,
    MIMI_SAMPLE_RATE,
    NUM_CODEBOOKS,
    SAMPLES_PER_FRAME,
    UNICODE_OFFSET,
    UNICODE_OFFSET_LARGE,
)
