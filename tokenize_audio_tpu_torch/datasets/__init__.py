"""Corpus processors of the port, each with its CLI
(``python -m tokenize_audio_tpu_torch.datasets.<name>``): ``yodas2`` (the
YODAS2 shard processor), ``librispeech``, ``mls`` (two stages), ``emilia``
(standard and conversational) and ``parquet_corpus`` (LibriTTS-R, Common
Voice, People's Speech); ``base`` holds the pretraining document builders
they share, re-exported here, and ``parquet_utils`` the parquet helpers."""

from tokenize_audio_tpu_torch.datasets.base import (  # noqa: F401
    asr_document,
    interleaved_type1,
    interleaved_type2,
    speaker_tagged_text,
    tts_document,
)
