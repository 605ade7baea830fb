"""PyTorch port, SIGKILL chaos for the ShardRunner-based families (slow, as
tests/test_runner_chaos.py is): the port's LibriSpeech chunked-train layout
and parquet-corpus template (LibriTTS-R spec) are hard-killed at staggered
moments and rerun unchanged; both hubs must equal, document for document, an
uninterrupted run of the port and an uninterrupted run of the JAX package
(its own child, unedited) on the same seeded workloads and weights. Reruns
regroup the remaining work into other batches, so the codes are also held
independent of batch composition."""

import os

import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_runner_chaos import _hub_docs, _work_evidence
from tests.torch_crash_windows import child
from tests.torch_processor_chaos import oracle_checkpoint, port_argv

CHILD = child("torch_runner_chaos_child.py")
JAX_CHILD = child("runner_chaos_child.py")


@pytest.mark.slow
def test_kill_anywhere_rerun_converges(tmp_path):
    params = oracle_checkpoint(tmp_path / "model.safetensors")
    clean = str(tmp_path / "clean")
    rc, out, _ = run_child(port_argv(CHILD, clean, params=params))
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref_docs = _hub_docs(clean)
    # librispeech: 12 utts x 2 rows over 6 chunks; corpus: 3 shards x 6 x 2
    assert len(ref_docs) == 24 + 36
    assert len(os.listdir(os.path.join(clean, "ls_hub", "data"))) == 6
    jax = str(tmp_path / "jax")
    rc, out, _ = run_child([JAX_CHILD, jax])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert _hub_docs(jax) == ref_docs

    chaos = str(tmp_path / "chaos")
    kills = kill_anywhere(
        lambda k: run_child(
            port_argv(CHILD, chaos, params=params), kill_after=k,
            evidence=lambda: _work_evidence(chaos)
        ),
        midwork=lambda: _work_evidence(chaos),
        delays=[0.2, 0.8, 1.6, 3.0],
    )
    assert kills >= 1  # a run that outpaced every kill proves nothing
    assert _hub_docs(chaos) == ref_docs
