"""PyTorch port, MLS crash windows (tier 1): the port's two-stage MLS path
(tests/torch_mls_chaos_child.py: tiny config, random weights, the CPU; 2
speakers x 1 book x 3 utterances, progress every 2 entries, a stage-2 batch a
speaker) SIGKILLed inside one named window, then rerun unchanged: the stage-1
tree, its progress and the hub equal an uninterrupted run's, the rerun
encodes only what the kill lost, and a second rerun encodes nothing. Each
window is reached twice: three progress saves, two stage-2 batches."""

import json

import pytest

from tests.torch_crash_windows import child, clean_run, crash_window

CHILD = child("torch_mls_chaos_child.py")

# window: (kill spec, KILL-line marker, utterances the rerun encodes)
WINDOWS = {
    # stage 1: entry JSONs 0-3 written (atomic_write_json calls 1, 2, 4, 5;
    # 3 is the first progress save), the second save not: the rerun skips
    # entries 2 and 3 by their content-addressed files and encodes 4 and 5
    "stage1_json_before_progress": (
        "after:tokenize_audio_tpu_torch.datasets.mls:atomic_write_json:5", "spkB/bk0/", 2),
    # stage 2: the first batch's parquet uploaded, the second batch not
    # started: the rerun skips the first as already uploaded
    "stage2_first_batch_uploaded": (
        "after:tokenize_audio_tpu_torch.hub.local:LocalHub.upload_file:1",
        "data/batch_000.parquet", 0),
}


def argv(base):
    return [CHILD, *(str(base / d) for d in ("s1", "prog", "hub", "w2")),
            "--books", "1", "--per-book", "3", "--device", "cpu"]


def state(base):
    """Every stage-1 JSON, the stage-1 progress, every hub row."""
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    tree = {str(p.relative_to(base / "s1")): json.loads(p.read_text())
            for p in sorted((base / "s1").rglob("*.json"))}
    progress = json.loads((base / "prog" / "mls_sh0_progress.json").read_text())
    rows = {p.name: read_parquet(str(p)) for p in sorted((base / "hub").rglob("*.parquet"))}
    return tree, progress, rows


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    base = tmp_path_factory.mktemp("mls_clean")
    report = clean_run(argv(base))
    assert report["utterances"] == 6
    assert [r["status"] for r in report["report"]["stage2"]] == ["processed", "processed"]
    want = state(base)
    assert len(want[0]) == 6 and want[1]["last_processed_index"] == 5 and len(want[2]) == 2
    return want


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_sigkill_in_window_then_rerun_converges(window, clean, tmp_path):
    kill_at, marker, rerun_utterances = WINDOWS[window]

    def killed():
        progress = json.loads((tmp_path / "prog" / "mls_sh0_progress.json").read_text())
        if window == "stage1_json_before_progress":
            assert progress["last_processed_index"] == 1
            assert len(list((tmp_path / "s1").rglob("*.json"))) == 4
        else:
            assert progress["last_processed_index"] == 5

    report = crash_window(argv(tmp_path), kill_at, marker, lambda: state(tmp_path), clean,
                          rerun_utterances, killed)
    statuses = [r["status"] for r in report["report"]["stage2"]]
    assert statuses == (["skipped", "processed"] if window.startswith("stage2")
                        else ["processed", "processed"])
