"""PyTorch port, SIGKILL chaos (slow, as the JAX package's chaos tests are):
the port's pretrain converter CLI, BPE sampler and token-estimator CLI are
hard-killed at staggered points and rerun unchanged (tests/chaos_utils.py);
the final artifacts must equal an uninterrupted run of the port and an
uninterrupted run of the JAX package on the same seeded inputs (the cases of
tests/test_pretrain_chaos.py, test_sampler_chaos.py and
test_estimate_chaos.py)."""

import json
import os

import numpy as np
import pytest

from tests.chaos_utils import kill_anywhere, run_child
from tests.test_estimate_chaos import _report
from tests.test_pretrain_chaos import N_SUB
from tests.test_pretrain_chaos import build_source as build_code_jsons
from tests.test_pretrain_chaos import run_cli as run_jax_converter
from tests.test_sampler_chaos import _npy_corpus

HERE = os.path.dirname(__file__)
SAMPLER_CHILD = os.path.join(HERE, "torch_sampler_chaos_child.py")
JAX_SAMPLER_CHILD = os.path.join(HERE, "sampler_chaos_child.py")
ESTIMATE_CHILD = os.path.join(HERE, "torch_estimate_chaos_child.py")
JAX_ESTIMATE_CHILD = os.path.join(HERE, "estimate_chaos_child.py")

_CLI = ("import sys; from tokenize_audio_tpu_torch.datasets.pretrain_converter import main; "
        "sys.exit(main(sys.argv[1:]))")


def run_converter(src, dst, work, prog, kill_after=None, evidence=None):
    sids = ",".join(f"{s:08d}" for s in range(N_SUB))
    argv = ["-c", _CLI, "--shard-id", "en000", "--subshard-ids", sids,
            "--source-hub", f"dir:{src}", "--target-hub", f"dir:{dst}", "--work-dir", work,
            "--progress-dir", prog, "--parquet-rows", "100"]
    return run_child(argv, kill_after=kill_after, timeout=300, evidence=evidence,
                     wait_ready=False)


def uploaded_rows(dst):
    from tokenize_audio_tpu_torch.datasets.parquet_utils import read_parquet

    rows = {}
    base = os.path.join(dst, "data")
    for f in sorted(os.listdir(base)):
        for r in read_parquet(os.path.join(base, f)):
            assert r["id"] not in rows, f"duplicate id {r['id']} in {f}"
            rows[r["id"]] = r["text"]
    return rows


@pytest.mark.slow
def test_pretrain_kill_anywhere_row_set_converges(tmp_path):
    src = build_code_jsons(tmp_path, np.random.default_rng(0))
    rc, out, _ = run_converter(src, str(tmp_path / "clean"), str(tmp_path / "cw"),
                               str(tmp_path / "cp"))
    assert rc == 0, out[-2000:]
    ref = uploaded_rows(str(tmp_path / "clean"))
    rc, out, _ = run_jax_converter(src, str(tmp_path / "jax"), str(tmp_path / "jw"),
                                   str(tmp_path / "jp"))
    assert rc == 0, out[-2000:]
    assert uploaded_rows(str(tmp_path / "jax")) == ref
    assert len(ref) == N_SUB * 400 * 2

    dst, work, prog = (str(tmp_path / d) for d in ("chaos", "w", "p"))

    def state_sig():
        pf = os.path.join(prog, "pretrain_en000_progress.json")
        mtime = os.path.getmtime(pf) if os.path.exists(pf) else None
        listing = tuple(sorted(os.listdir(work))) if os.path.isdir(work) else ()
        return (mtime, listing)

    snap = []

    def run(k):
        snap[:] = [state_sig()]
        return run_converter(src, dst, work, prog, kill_after=k,
                             evidence=lambda: state_sig() != snap[0])

    kill_anywhere(run, midwork=lambda: state_sig() != snap[0],
                  delays=[0.3, 0.8, 1.5, 2.5, 3.5], done_token=None)
    assert uploaded_rows(dst) == ref


@pytest.mark.slow
def test_sampler_kill_anywhere_rerun_converges(tmp_path):
    rc, out, _ = run_child([SAMPLER_CHILD, str(tmp_path / "clean_src"),
                            str(tmp_path / "clean_out")])
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref = _npy_corpus(str(tmp_path / "clean_out"))
    assert len(ref) == 120
    rc, out, _ = run_child([JAX_SAMPLER_CHILD, str(tmp_path / "jax_src"),
                            str(tmp_path / "jax_out")])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert _npy_corpus(str(tmp_path / "jax_out")) == ref

    src, outdir = str(tmp_path / "chaos_src"), str(tmp_path / "chaos_out")

    def started():
        return os.path.isfile(os.path.join(outdir, "sampling_progress.txt"))

    kill_anywhere(
        lambda k: run_child([SAMPLER_CHILD, src, outdir], kill_after=k, evidence=started,
                            timeout=300),
        midwork=started, delays=[0.05, 0.1, 0.2, 0.4],
    )
    assert _npy_corpus(outdir) == ref
    # dtype too: the corpus is uint16 in all three runs
    for path in (os.path.join(outdir, f) for f in os.listdir(outdir) if f.endswith(".npy")):
        assert all(a.dtype == np.uint16 for a in np.load(path, allow_pickle=True))


@pytest.mark.slow
def test_estimate_kill_anywhere_rerun_converges(tmp_path):
    def estimates(path):
        return {k: v for k, v in _report(path).items() if k != "_config"}

    rc, out, _ = run_child([ESTIMATE_CHILD, str(tmp_path / "clean_src"),
                            str(tmp_path / "clean.json"), str(tmp_path / "tok")])
    assert rc == 0 and "DONE" in out, out[-3000:]
    ref = estimates(str(tmp_path / "clean.json"))
    assert len(ref) == 24 and all(v["estimated_total_tokens"] > 0 for v in ref.values())
    rc, out, _ = run_child([JAX_ESTIMATE_CHILD, str(tmp_path / "jax_src"),
                            str(tmp_path / "jax.json"), str(tmp_path / "jax_tok")])
    assert rc == 0 and "DONE" in out, out[-3000:]
    assert estimates(str(tmp_path / "jax.json")) == ref

    src, outpath = str(tmp_path / "chaos_src"), str(tmp_path / "chaos.json")

    def started():
        return bool(_report(outpath))

    kill_anywhere(
        lambda k: run_child([ESTIMATE_CHILD, src, outpath, str(tmp_path / "tok")],
                            kill_after=k, evidence=started, timeout=300),
        midwork=started, delays=[0.05, 0.15, 0.3, 0.6],
    )
    assert estimates(outpath) == ref
    assert json.loads(open(outpath).read())["_config"]["seed"] == 5
