"""Audio DSP for the port. The code<->unicode codec (``core/codes.py`` of the
JAX package) joins with the corpus processors that use it."""

from tokenize_audio_tpu_torch.core.audio import (  # noqa: F401
    bucket_for_length,
    encoded_frame_count,
    make_buckets,
    pad_to_bucket,
    pcm_to_float,
    resample,
    resample_many,
    split_long_audio,
    split_long_audio_with_context,
)
