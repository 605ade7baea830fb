from tokenize_audio_tpu_torch.bpe.trainer import CodecBPETrainer  # noqa: F401
