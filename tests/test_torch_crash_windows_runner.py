"""PyTorch port, ShardRunner crash window (tier 1): the port's LibriSpeech
train layout (tests/torch_runner_chaos_child.py with no corpus shards: tiny
config, random weights, the CPU; 8 utterances in 4 chunks, upload batches of
2) SIGKILLed inside ``ShardRunner._flush_uploads`` after the second batch's
``upload_batch`` and before its marks, then rerun unchanged: hub and progress
equal an uninterrupted run's, the rerun adopts both chunks from their hub
markers and encodes nothing, and a second rerun encodes nothing."""

import json

from tests.torch_crash_windows import child, clean_run, crash_window

CHILD = child("torch_runner_chaos_child.py")
KILL_AT = "after:tokenize_audio_tpu_torch.hub.local:LocalHub.upload_batch:2"


def argv(base):
    return [CHILD, str(base), "--utterances", "8", "--corpus-shards", "0", "--device", "cpu"]


def state(base):
    """Every row of every chunk on the hub, and the progress without its clock."""
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    rows = {p.name: read_parquet(str(p)) for p in sorted((base / "ls_hub").rglob("*.parquet"))}
    progress = json.loads((base / "ls_prog" / "train-clean_progress.json").read_text())
    progress.pop("updated_at")
    return rows, progress


def test_sigkill_after_upload_batch_before_marks_then_rerun_converges(tmp_path):
    report = clean_run(argv(tmp_path / "clean"))
    assert report["utterances"] == 8 and report["report"]["librispeech"]["processed"] == 4
    want = state(tmp_path / "clean")
    assert len(want[0]) == 4 and want[1]["meta"] == {"done": True}
    base = tmp_path / "chaos"
    report = crash_window(argv(base), KILL_AT, "data/train-clean-00003-of-00004.parquet",
                          lambda: state(base), want, 0,
                          killed=lambda: _marked_before_kill(base))
    assert report["report"]["librispeech"]["skipped"] == 4


def _marked_before_kill(base):
    """The kill left chunks 0 and 1 marked, 2 and 3 on the hub only."""
    progress = json.loads((base / "ls_prog" / "train-clean_progress.json").read_text())
    assert progress["completed"] == [f"train-clean-0000{i}-of-00004.parquet" for i in (0, 1)]
    assert len(list((base / "ls_hub" / "data").iterdir())) == 4
