"""Audio DSP for the port (``core.audio``), the code<->unicode converter
(``core.codes``) and the models' shared encode contract
(``core.contract``)."""

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
