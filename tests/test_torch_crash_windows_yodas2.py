"""PyTorch port, YODAS2 crash windows (tier 1): the port's shard processor
(tests/torch_yodas2_chaos_child.py: tiny config, random weights, the CPU,
upload batch 1, a group per entry) SIGKILLed inside one named window, then
rerun unchanged: hub and progress equal an uninterrupted run's, the rerun
encodes only what the kill lost, and a second rerun encodes nothing. On two
sub-shards of two entries, each window is reached twice."""

import json
import os

import numpy as np
import pytest

from tests.torch_crash_windows import child, clean_run, crash_window
from torch_yodas2_mirror import Entry, noise_pcm, write_mirror

CHILD = child("torch_yodas2_chaos_child.py")
SUBSHARDS, ENTRIES, CHUNKS = 2, 2, [(0, 100), (50, 150)]  # 2 chunks an entry
YODAS2 = "tokenize_audio_tpu_torch.datasets.yodas2"

# (kill spec, KILL-line marker, utterances the rerun encodes)
WINDOWS = {
    # sub-shard 1 on the hub, not marked: the rerun adopts it from the hub
    "uploaded_not_marked": ("after:tokenize_audio_tpu_torch.hub.local:LocalHub.upload_file:2",
                            "data/en000/00000001.json", 0),
    # sub-shard 1's output written, not uploaded: the startup scan uploads it
    "written_not_uploaded": (f"after:{YODAS2}:atomic_write_text:2", "00000001.out.json", 0),
    # sub-shard 1's first group appended to its .partial, the second not:
    # the rerun encodes that entry's chunks and nothing more
    "first_group_appended": (f"after:{YODAS2}:append_jsonl_lines:{ENTRIES + 1}",
                             "00000001.out.json.partial", len(CHUNKS)),
}


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    rng = np.random.default_rng(3)
    return write_mirror(str(tmp_path_factory.mktemp("yodas2_mirror")), "en000", [
        [Entry(f"vid-{s}-{a}", noise_pcm(rng, 38_400), 24_000, "wav", CHUNKS)
         for a in range(ENTRIES)]
        for s in range(SUBSHARDS)
    ])


def argv(mirror, base):
    return [CHILD, mirror, *(str(base / d) for d in ("work", "prog", "hub")), "--device", "cpu"]


def state(base):
    """Every hub JSON, parsed, and the shard's progress without its clock."""
    hub = base / "hub"
    files = {str(p.relative_to(hub)): json.loads(p.read_text())
             for p in sorted(hub.rglob("*")) if p.is_file()}
    progress = json.loads((base / "prog" / "en000_progress.json").read_text())
    progress.pop("updated_at")
    return files, progress


@pytest.fixture(scope="module")
def clean(mirror, tmp_path_factory):
    base = tmp_path_factory.mktemp("yodas2_clean")
    report = clean_run(argv(mirror, base))
    assert report == {"report": {"processed": SUBSHARDS, "skipped": 0, "missing": 5, "failed": 0,
                                 "uploaded": SUBSHARDS},
                      "utterances": SUBSHARDS * ENTRIES * len(CHUNKS)}
    return state(base)


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_sigkill_in_window_then_rerun_converges(window, mirror, clean, tmp_path):
    kill_at, marker, rerun_utterances = WINDOWS[window]

    def killed():
        partial = tmp_path / "work" / "en000" / "00000001.out.json.partial"
        if window == "first_group_appended":  # one entry on disk, the other not
            assert [json.loads(ln)["audio_id"] for ln in partial.read_text().splitlines()] \
                == ["vid-1-0"]
        else:  # sub-shard 0 completes before sub-shard 1's output is assembled
            assert os.path.isfile(tmp_path / "hub" / "data" / "en000" / "00000000.json")

    report = crash_window(argv(mirror, tmp_path), kill_at, marker, lambda: state(tmp_path),
                          clean, rerun_utterances, killed)
    assert report["report"]["failed"] == 0
