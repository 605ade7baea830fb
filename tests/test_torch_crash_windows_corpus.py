"""PyTorch port, parquet-corpus crash windows (tier 1): the port's corpus
template (tests/torch_corpus_chaos_child.py: Common Voice spec, tiny config,
random weights, the CPU) SIGKILLed inside one named window of
``process_shard``, then rerun unchanged: hub and progress equal an
uninterrupted run's, the rerun encodes nothing (each window opens after the
encode) and skips both shards, and a second rerun encodes nothing. On two
shards of two rows, each window is reached twice."""

import json

import pytest

from tests.torch_crash_windows import child, clean_run, crash_window

CHILD = child("torch_corpus_chaos_child.py")

# window: (kill spec, KILL-line marker)
WINDOWS = {
    # shard 1's parquet uploaded, not yet verified: the rerun finds it on the hub
    "uploaded_not_verified": ("after:tokenize_audio_tpu_torch.hub.local:LocalHub.upload_file:2",
                              "en/shard1.parquet"),
    # shard 1 verified on the hub, not marked: the rerun adopts it
    "verified_not_marked": (
        "before:tokenize_audio_tpu_torch.runner.progress:ShardProgress.mark_completed:2",
        "shard1"),
}


def argv(base):
    return [CHILD, *(str(base / d) for d in ("src", "dst", "work", "prog")),
            "--shards", "2", "--rows", "2", "--device", "cpu"]


def state(base):
    """Every row of every target parquet, and the progress without its clock."""
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    rows = {str(p.relative_to(base)): read_parquet(str(p))
            for p in sorted((base / "dst").rglob("*.parquet"))}
    progress = json.loads((base / "prog" / "common_voice_en_progress.json").read_text())
    progress.pop("updated_at")
    return rows, progress


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    base = tmp_path_factory.mktemp("corpus_clean")
    report = clean_run(argv(base))
    assert report["utterances"] == 4
    assert [r["status"] for r in report["report"]] == ["processed", "processed"]
    return state(base)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_sigkill_in_window_then_rerun_converges(window, clean, tmp_path):
    kill_at, marker = WINDOWS[window]
    report = crash_window(argv(tmp_path), kill_at, marker, lambda: state(tmp_path), clean, 0)
    assert [r["status"] for r in report["report"]] == ["skipped", "skipped"]
