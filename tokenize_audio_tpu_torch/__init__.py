"""tokenize_audio_tpu_torch — the PyTorch/CUDA port of tokenize_audio_tpu.

The Mimi neural codec on an NVIDIA GPU: the encoder (SEANet conv stack, RoPE
transformer bottleneck and split residual vector quantization, one-shot or
streaming) and the decoder in PyTorch, with hand-written CUDA kernels for
the fused SEANet residual block and the chained RVQ search. The JAX package ``tokenize_audio_tpu`` stays beside it
as the reference; this package imports nothing of it.

Subpackages
-----------
core      : audio DSP (resample/frame/normalize, length buckets), the
            code <-> unicode converter
mimi      : the PyTorch Mimi encoder (one-shot and streaming) and decoder,
            weight conversion from HF checkpoints
ops       : hand-written CUDA kernels and their plain PyTorch versions
engine    : length-bucketed batch encoding engine with throughput metrics
parallel  : the (data, model) mesh of torch.distributed ranks, tensor-parallel
            param slices, multi-process helpers
io        : WAV / native FLAC / libmpg123 decode, fast code JSON, prefetch
hub       : artifact stores (local directory, HuggingFace Hub)
runner    : crash-safe progress ledger and the shard work loop
datasets  : corpus processors (YODAS2)
cli       : the engine flags shared by the processors' command lines
codec     : MimiCodec — audio <-> codes <-> unicode strings, encode and decode
__main__  : ``python -m tokenize_audio_tpu_torch encode|decode|info``

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


def __getattr__(name):
    # ``tokenize_audio_tpu_torch.main`` is the command line's entry
    # (``python -m tokenize_audio_tpu_torch``), loaded on first use so that
    # running the package as ``__main__`` does not import that module twice
    if name == "main":
        from tokenize_audio_tpu_torch.__main__ import main

        return main
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
