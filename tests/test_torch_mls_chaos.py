"""PyTorch port, SIGKILL chaos for the MLS two-stage path (slow, as
tests/test_mls_chaos.py is): the port's stage-1 processor (index progress,
content-addressed skip-if-exists JSONs) and stage-2 merger (skip-if-uploaded)
are hard-killed at staggered moments and rerun unchanged; the stage-1 tree
and the hub parquets must equal an uninterrupted run of the port's and one of
the JAX package's (its own child, unedited) on the same seeded rows and
weights. Reruns regroup the remaining entries into other batches."""

import os

import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_mls_chaos import _hub_docs, _stage1_any, _stage1_tree
from tests.torch_crash_windows import child
from tests.torch_processor_chaos import oracle_checkpoint, port_argv

CHILD = child("torch_mls_chaos_child.py")
JAX_CHILD = child("mls_chaos_child.py")


def assert_same_tree(got, ref):
    assert set(got) == set(ref)
    for rel in ref:
        assert got[rel] == ref[rel], rel


@pytest.mark.slow
def test_kill_anywhere_rerun_converges(tmp_path):
    params = oracle_checkpoint(tmp_path / "model.safetensors")
    clean = [str(tmp_path / f"clean_{d}") for d in ("s1", "prog", "hub", "w2")]
    rc, out, _ = run_child(port_argv(CHILD, *clean, params=params))
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref_tree = _stage1_tree(clean[0])
    assert len(ref_tree) == 40
    ref_docs = _hub_docs(clean[2])
    # 2 batches (speakers_per_batch=1) x 2 books x 2 segments x 2 types
    assert len(ref_docs) == 16
    jax = [str(tmp_path / f"jax_{d}") for d in ("s1", "prog", "hub", "w2")]
    rc, out, _ = run_child([JAX_CHILD, *jax])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert_same_tree(_stage1_tree(jax[0]), ref_tree)
    assert _hub_docs(jax[2]) == ref_docs

    ch = [str(tmp_path / f"chaos_{d}") for d in ("s1", "prog", "hub", "w2")]
    kills = kill_anywhere(
        lambda k: run_child(port_argv(CHILD, *ch, params=params), kill_after=k,
                            evidence=lambda: _stage1_any(ch[0])),
        midwork=lambda: _stage1_any(ch[0])
        or os.path.isdir(os.path.join(ch[2], "data")),
        delays=[0.2, 0.8, 1.6, 3.0],
    )
    assert kills >= 1  # a run that outpaced every kill proves nothing
    assert_same_tree(_stage1_tree(ch[0]), ref_tree)
    assert _hub_docs(ch[2]) == ref_docs
