"""PyTorch port, SIGKILL chaos for the YODAS2 shard processor (slow, as
tests/test_yodas2_chaos.py is): the port's processor is hard-killed at
staggered moments mid-run and rerun unchanged; the final hub must equal, entry
for entry and code for code, an uninterrupted run of the port and an
uninterrupted run of the JAX package (its own child, unedited) on the same
mirror and weights."""

import json
import os

import numpy as np
import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_yodas2 import build_corpus
from tests.torch_crash_windows import child
from tests.torch_processor_chaos import oracle_checkpoint, port_argv

CHILD = child("torch_yodas2_chaos_child.py")
JAX_CHILD = child("yodas2_chaos_child.py")


def _hub_contents(hub_dir):
    """{repo_path: {audio_id: {chunk_id: codes-list}}} for every data JSON."""
    out = {}
    base = os.path.join(hub_dir, "data", "en000")
    for f in sorted(os.listdir(base)):
        with open(os.path.join(base, f)) as fh:
            entries = json.load(fh)
        out[f] = {
            e["audio_id"]: {k: np.asarray(v) for k, v in e["codes"].items()}
            for e in entries
        }
    return out


def assert_same_hub(got, ref):
    assert set(got) == set(ref)
    for f in ref:
        assert set(got[f]) == set(ref[f]), f
        for aid in ref[f]:
            assert set(got[f][aid]) == set(ref[f][aid]), (f, aid)
            for cid in ref[f][aid]:
                assert got[f][aid][cid].dtype == ref[f][aid][cid].dtype, (f, aid, cid)
                assert (got[f][aid][cid] == ref[f][aid][cid]).all(), (f, aid, cid)


@pytest.mark.slow
def test_kill_anywhere_rerun_converges(tmp_path, rng):
    mirror = build_corpus(str(tmp_path / "mirror"), rng, subshards=3, audios_per=2)
    params = oracle_checkpoint(tmp_path / "model.safetensors")

    # uninterrupted runs: the port's, then the JAX package's
    clean = [str(tmp_path / f"clean_{d}") for d in ("work", "prog", "hub")]
    rc, out, _ = run_child(port_argv(CHILD, mirror, *clean, params=params))
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref = _hub_contents(clean[2])
    assert len(ref) == 3
    jax = [str(tmp_path / f"jax_{d}") for d in ("work", "prog", "hub")]
    rc, out, _ = run_child([JAX_CHILD, mirror, *jax])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert_same_hub(_hub_contents(jax[2]), ref)

    # chaos runs: SIGKILL at staggered offsets after the first evidence of
    # work (fetch/extract into the work dir), then rerun until completion
    ch = {d: str(tmp_path / f"chaos_{d}") for d in ("work", "prog", "hub")}

    def started():
        return os.path.isdir(ch["work"]) and bool(os.listdir(ch["work"]))

    kills = kill_anywhere(
        lambda k: run_child(
            port_argv(CHILD, mirror, ch["work"], ch["prog"], ch["hub"], params=params),
            kill_after=k,
            evidence=started,
        ),
        midwork=started,
        delays=[0.2, 1.0, 2.5, 5.0],
    )
    assert kills >= 1  # a run that outpaced every kill proves nothing
    assert_same_hub(_hub_contents(ch["hub"]), ref)
