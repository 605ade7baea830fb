"""PyTorch port, SIGKILL chaos for the parquet-corpus family (slow, as
tests/test_corpus_chaos.py is): the port's generic template (Common Voice
spec) is hard-killed at staggered moments mid-run and rerun unchanged; the
published target parquets must equal, document for document, an
uninterrupted run of the port and an uninterrupted run of the JAX package
(its own child, unedited) on the same seeded shards and weights."""

import os

import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_corpus_chaos import _hub_docs
from tests.torch_crash_windows import child
from tests.torch_processor_chaos import oracle_checkpoint, port_argv

CHILD = child("torch_corpus_chaos_child.py")
JAX_CHILD = child("corpus_chaos_child.py")


@pytest.mark.slow
def test_kill_anywhere_rerun_converges(tmp_path):
    params = oracle_checkpoint(tmp_path / "model.safetensors")
    clean = [str(tmp_path / f"clean_{d}") for d in ("src", "dst", "work", "prog")]
    rc, out, _ = run_child(port_argv(CHILD, *clean, params=params))
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref_docs = _hub_docs(clean[1])
    assert len(ref_docs) == 24  # 3 shards x 4 rows x (type1 + type2)
    jax = [str(tmp_path / f"jax_{d}") for d in ("src", "dst", "work", "prog")]
    rc, out, _ = run_child([JAX_CHILD, *jax])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert _hub_docs(jax[1]) == ref_docs

    ch = [str(tmp_path / f"chaos_{d}") for d in ("src", "dst", "work", "prog")]

    def started():
        # cheap existence checks only (see tests/test_corpus_chaos.py)
        return any(
            os.path.isdir(d) and bool(os.listdir(d)) for d in (ch[2], ch[3], os.path.join(ch[1], "en"))
        )

    kills = kill_anywhere(
        lambda k: run_child(port_argv(CHILD, *ch, params=params), kill_after=k, evidence=started),
        midwork=started,
        delays=[0.2, 0.8, 1.6, 3.0],
    )
    assert kills >= 1  # a run that outpaced every kill proves nothing
    assert _hub_docs(ch[1]) == ref_docs
