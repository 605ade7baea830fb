"""Corpus processors of the port: ``yodas2`` (the YODAS2 shard processor and
its CLI, ``python -m tokenize_audio_tpu_torch.datasets.yodas2``)."""
