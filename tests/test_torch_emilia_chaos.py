"""PyTorch port, SIGKILL chaos for the Emilia processor (slow, as
tests/test_emilia_chaos.py is), standard and conversational: the port's
processor is hard-killed mid-shard (download, extract, encode, cache, group,
upload) and rerun unchanged; the uploaded parquet must equal an uninterrupted
run of the port's and one of the JAX package's (its own child, unedited) row
for row on the same source and weights, utterance order inside each speaker
document included."""

import os

import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_emilia_chaos import build_source, rows_of
from tests.torch_crash_windows import child
from tests.torch_processor_chaos import oracle_checkpoint, port_argv

CHILD = child("torch_emilia_chaos_child.py")
JAX_CHILD = child("emilia_chaos_child.py")


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["standard", "conversational"])
def test_kill_anywhere_rerun_converges(tmp_path, rng, mode):
    src = build_source(tmp_path, rng)
    params = oracle_checkpoint(tmp_path / "model.safetensors")
    extra = ["conversational"] if mode == "conversational" else []

    rc, out, _ = run_child(port_argv(CHILD, src, tmp_path / "clean", tmp_path / "cw", *extra,
                                     params=params))
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref = rows_of(str(tmp_path / "clean"))
    if mode == "standard":
        assert len(ref) == 6 * 2  # speakers x (type1, type2)
    else:
        assert len(ref) == 6  # type1 only (process_shard_conversational.py)
        assert all(r["speaker_count"] >= 1 for r in ref.values())
    rc, out, _ = run_child([JAX_CHILD, src, str(tmp_path / "jax"), str(tmp_path / "jw"), *extra])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert rows_of(str(tmp_path / "jax")) == ref

    dst, work = str(tmp_path / "chaos"), str(tmp_path / "w")

    def started():  # tar fetch/extract into the work dir counts as work
        return os.path.isdir(work) and bool(os.listdir(work))

    kills = kill_anywhere(
        lambda k: run_child(port_argv(CHILD, src, dst, work, *extra, params=params),
                            kill_after=k, evidence=started),
        midwork=started,
        delays=[0.2, 0.8, 1.6, 3.0],
    )
    assert kills >= 1  # a run that outpaced every kill proves nothing
    # ids, texts, speaker columns, and in-document utterance order
    assert rows_of(dst) == ref
