"""PyTorch port, Emilia crash windows (tier 1): the port's Emilia processor
in standard mode (tests/torch_emilia_chaos_child.py: tiny config, random
weights, the CPU; a tar of 2 speakers x 3 utterances, encode batches of 4)
SIGKILLed inside one named window, then rerun unchanged: the hub parquet
equals an uninterrupted run's row for row (its only ledger: the processor
skips a shard on the hub), the rerun encodes only what the kill lost, and a
second rerun encodes nothing."""

import json
import tarfile

import numpy as np
import pytest

from tests.torch_crash_windows import child, clean_run, crash_window

CHILD = child("torch_emilia_chaos_child.py")
SHARD, SPEAKERS, UTTERANCES = "EN_B00000", 2, 3

# window: (kill spec, KILL-line marker, utterances the rerun encodes)
WINDOWS = {
    # the first batch's 4 utterances cached, the last 2 not, nothing uploaded
    "cached_not_uploaded": ("after:tokenize_audio_tpu_torch.datasets.emilia:append_jsonl:1",
                            "audio_str_cache.json", 2),
    # the parquet uploaded, not yet verified: the rerun skips the shard
    "uploaded_not_verified": ("after:tokenize_audio_tpu_torch.hub.local:LocalHub.upload_file:1",
                              f"Emilia/EN/{SHARD}.parquet", 0),
}


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """The shard's tar of 0.5 s WAV + JSON members on a source hub."""
    from tokenize_audio_tpu_torch.hub import LocalHub
    from tokenize_audio_tpu_torch.io import write_wav

    tmp = tmp_path_factory.mktemp("emilia_source")
    members = tmp / "members"
    members.mkdir()
    rng = np.random.default_rng(5)
    for spk in range(1, SPEAKERS + 1):
        for w in range(UTTERANCES):
            uid = f"{SHARD}_S{spk:05d}_W{w:06d}"
            write_wav(str(members / f"{uid}.wav"),
                      (rng.standard_normal(12_000) * 0.2).astype(np.float32), 24_000)
            (members / f"{uid}.json").write_text(
                json.dumps({"text": f"utt {spk}-{w}", "speaker": f"SPEAKER_{spk:02d}"}))
    with tarfile.open(tmp / f"{SHARD}.tar", "w") as tf:
        tf.add(members, arcname=SHARD)
    LocalHub(str(tmp / "hub")).upload_file(str(tmp / f"{SHARD}.tar"), f"Emilia/EN/{SHARD}.tar")
    return str(tmp / "hub")


def argv(source, base):
    return [CHILD, source, str(base / "dst"), str(base / "work"), "--device", "cpu"]


def state(base):
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    return read_parquet(str(base / "dst" / "Emilia" / "EN" / f"{SHARD}.parquet"))


@pytest.fixture(scope="module")
def clean(source, tmp_path_factory):
    base = tmp_path_factory.mktemp("emilia_clean")
    report = clean_run(argv(source, base))
    assert report["utterances"] == SPEAKERS * UTTERANCES
    assert report["report"]["status"] == "processed"
    rows = state(base)
    assert len(rows) == SPEAKERS * 2  # a speaker document of each type
    return rows


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_sigkill_in_window_then_rerun_converges(window, source, clean, tmp_path):
    kill_at, marker, rerun_utterances = WINDOWS[window]
    report = crash_window(argv(source, tmp_path), kill_at, marker, lambda: state(tmp_path),
                          clean, rerun_utterances)
    assert report["report"]["status"] == ("processed" if window == "cached_not_uploaded"
                                          else "skipped")
