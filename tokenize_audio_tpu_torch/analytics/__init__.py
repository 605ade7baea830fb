from tokenize_audio_tpu_torch.analytics.estimate_tokens import TokenEstimator  # noqa: F401
from tokenize_audio_tpu_torch.analytics.count_rows import count_parquet_rows  # noqa: F401
