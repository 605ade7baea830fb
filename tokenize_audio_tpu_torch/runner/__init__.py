from tokenize_audio_tpu_torch.runner.progress import (  # noqa: F401
    ShardProgress,
    append_jsonl,
    append_jsonl_lines,
    atomic_write_json,
    atomic_write_text,
    read_json,
    read_jsonl,
)
from tokenize_audio_tpu_torch.runner.shard_runner import ShardRunner, WorkUnit  # noqa: F401
