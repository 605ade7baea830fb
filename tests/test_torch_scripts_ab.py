"""PyTorch port, qualification scripts, part 4: ``probe_common`` and the
seven interleaved A/B probes (drain policy, fetch-ahead, fetch dtype, wire
format, bucket growth, pipeline depth, samples budget) against the JAX
package's scripts (``scripts/``, loaded by path, ``probe_common`` put in
``sys.modules`` as the scripts import it) on the tiny oracle config on the
CPU. The JAX probes run once per module on a cut workload (1 round, three
utterances of at most 4 s; fetch-ahead on a 4 x 1 x 3 s mirror); each port
probe runs on the same inputs and is held to them: ``bench_audios`` byte
for byte, every configuration's warm-pass codes bit-equal to the JAX
engine's, the printed lines equal with each number masked, ``RESULT`` keys
equal (growth adds ``buckets``), the growth lattices' bucket counts,
``bucket_efficiency`` and ``padded_frames`` equal, and fetch-ahead's hub
codes equal. (Part 5, the warmup receipt and the conv-layout probe:
tests/test_torch_scripts_receipts.py.)"""

import contextlib
import io
import json
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import tokenize_audio_tpu.benchmark as jax_benchmark
import tokenize_audio_tpu.mimi as jax_mimi
from tests.torch_scripts import (
    load_jax_script,
    no_compile_cache,
    run_jax_main,
    tiny_jax,
    tiny_port_config,
)
from tokenize_audio_tpu.config import EngineConfig as JaxEngineConfig
from tokenize_audio_tpu.engine import MimiEncoderEngine as JaxEngine
from tokenize_audio_tpu.mimi.weights import random_params as jax_random_params
from tokenize_audio_tpu_torch.config import EngineConfig
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import random_params
from tokenize_audio_tpu_torch.scripts import (
    drain_policy_probe,
    fetch_ahead_probe,
    fetch_dtype_probe,
    fetch_pack_probe,
    growth_probe,
    pipeline_depth_probe,
    probe_common,
    samples_budget_probe,
)

MAX_SAMPLES = 4 * 24_000  # the cut workload's longest utterance
NUMBER = re.compile(r"-?\d+(\.\d+)?(e[-+]?\d+)?")
# stages the port's engine times inside its dispatch and fetch stages, which
# the JAX engine does not have: left out where the stage tables are compared
PORT_SUB_STAGES = {"dispatch.upload", "dispatch.launch", "fetch.wait"}
SUB_STAGE_ENTRY = re.compile(
    r""",? ?['"](?:%s)['"]: #""" % "|".join(map(re.escape, sorted(PORT_SUB_STAGES))))


def cut_bench_audios(real):
    """``bench_audios`` cut for the CPU: three utterances of the seed's
    draw, each at most 4 s (the same cut in both packages)."""

    def bench_audios(utts=192, seed=0):
        audios = [a[:MAX_SAMPLES] for a in real(3, seed)[0]]
        return audios, sum(len(a) for a in audios) / 24_000.0

    return bench_audios


class FewShortRng:
    """``np.random.default_rng`` for the fetch-dtype probe's inline
    workload: three lognormal lengths of at most 3.5 s (both packages)."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def lognormal(self, mean, sigma, size):
        return np.minimum(self.rng.lognormal(mean, sigma, size=3), 3.5)

    def standard_normal(self, n):
        return self.rng.standard_normal(n)


def few_short_numpy():
    shim = types.ModuleType("numpy_few_short")
    shim.__dict__.update(np.__dict__)
    shim.random = types.SimpleNamespace(default_rng=FewShortRng, randint=np.random.randint)
    return shim


def cut_mirror(real):
    return lambda root, shard, *args: real(root, shard, 4, 1, 3)


def kept_tmp(path: Path):
    """The fetch-ahead scripts' ``tempfile`` and ``shutil``, keeping their
    directory (under ``path``) for the hubs to be read."""
    path.mkdir(parents=True, exist_ok=True)
    return (types.SimpleNamespace(mkdtemp=lambda prefix: str(path)),
            types.SimpleNamespace(rmtree=lambda *a, **k: None))


def hub_codes(hub: Path) -> dict:
    got = {}
    for f in sorted((hub / "data" / "en000").glob("*.json")):
        for entry in json.loads(f.read_text()):
            for cid, c in entry["codes"].items():
                got[cid] = np.asarray(c)
    return got


def lines(out: str) -> list:
    """Printed lines, each number masked, each port sub-stage's entry of a
    printed stage table left out and each run of spaces made one (numbers
    pad to their width), without the device line (the JAX scripts print a
    JAX device, the port its card or "cpu")."""
    return [" ".join(SUB_STAGE_ENTRY.sub("", NUMBER.sub("#", ln)).split())
            for ln in out.splitlines() if not ln.startswith("device:")]


def result_of(out: str) -> dict:
    return json.loads(next(ln for ln in out.splitlines() if ln.startswith("RESULT "))[7:])


JAX_RUNS = [
    ("drain_policy_probe", ["1"]),
    ("fetch_ahead_probe", ["1"]),
    ("fetch_dtype_probe", []),
    ("fetch_pack_probe", ["--rounds", "1", "--utts", "3"]),
    ("growth_probe", ["--rounds", "1", "--utts", "3"]),
    ("pipeline_depth_probe", ["1"]),
    ("samples_budget_probe", ["1"]),
]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each JAX probe once on the cut workload: its stdout, the warm-pass
    codes of each of its engines (the first encode of each, in order) and,
    for fetch-ahead, its directory of hubs."""
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        no_compile_cache(mp)
        mp.setattr(jax_mimi, "MimiConfig", tiny_jax)
        common = load_jax_script("probe_common")
        mp.setattr(common, "bench_audios", cut_bench_audios(common.bench_audios))
        mp.setitem(sys.modules, "probe_common", common)
        calls = []
        encode_batch = JaxEngine.encode_batch

        def recorded(self, *args, **kwargs):
            out = encode_batch(self, *args, **kwargs)
            calls.append((self, out))
            return out

        mp.setattr(JaxEngine, "encode_batch", recorded)
        # the JAX fetch-ahead script imports build_mirror from its sibling
        # pipeline_bench, which no longer defines it (it moved to the
        # package's benchmark module, where the port takes it from too)
        mp.setitem(sys.modules, "pipeline_bench",
                   types.SimpleNamespace(build_mirror=jax_benchmark.build_mirror))
        for name, argv in JAX_RUNS:
            mod = load_jax_script(name)
            if name == "fetch_ahead_probe":
                mp.setattr(mod, "build_mirror", cut_mirror(mod.build_mirror))
                tmp = tmp_path_factory.mktemp("jax_fa")
                tempfile_, shutil_ = kept_tmp(tmp)
                mp.setattr(mod, "tempfile", tempfile_)
                mp.setattr(mod, "shutil", shutil_)
            if name == "fetch_dtype_probe":
                mp.setattr(mod, "np", few_short_numpy())
            calls.clear()
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                run_jax_main(mod, argv, mp)
            warm, seen = [], set()
            for eng, codes in calls:
                if id(eng) not in seen:
                    seen.add(id(eng))
                    warm.append(codes)
            runs[name] = {"out": out.getvalue(), "warm": warm}
            if name == "fetch_ahead_probe":
                runs[name]["tmp"] = tmp
    return runs


@pytest.fixture
def port(monkeypatch, tmp_path):
    """The port's probes patched to the same cut: the tiny config, the cut
    workload (``probe_common``, fetch-ahead's mirror, fetch-dtype's draws),
    and fetch-ahead's directory kept under ``tmp_path``."""
    for mod in (drain_policy_probe, fetch_ahead_probe, fetch_dtype_probe, fetch_pack_probe,
                growth_probe, pipeline_depth_probe, samples_budget_probe):
        monkeypatch.setattr(mod, "MimiConfig", tiny_port_config)
    monkeypatch.setattr(probe_common, "bench_audios", cut_bench_audios(probe_common.bench_audios))
    monkeypatch.setattr(fetch_ahead_probe, "build_mirror", cut_mirror(fetch_ahead_probe.build_mirror))
    tmp, shutil_ = kept_tmp(tmp_path / "fa")
    monkeypatch.setattr(fetch_ahead_probe, "tempfile", tmp)
    monkeypatch.setattr(fetch_ahead_probe, "shutil", shutil_)
    monkeypatch.setattr(fetch_dtype_probe, "np", few_short_numpy())
    return tmp_path / "fa"


def assert_codes_equal(got: list, want: list):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("utts,seed", [(16, 0), (5, 7)])
def test_bench_audios_byte_equal_to_jax(utts, seed):
    jax_common = load_jax_script("probe_common")
    got, got_s = probe_common.bench_audios(utts, seed)
    want, want_s = jax_common.bench_audios(utts, seed)
    assert got_s == want_s and len(got) == len(want) == utts
    for a, b in zip(got, want):
        assert a.dtype == np.int16 and a.tobytes() == b.tobytes()


def test_warm_check_and_rounds_match_jax(capsys):
    """``warm_and_check_equal`` and ``interleaved_rounds`` over a padded and
    a packed engine in each package: the same codes and the same round
    line; each round's stages the JAX keys."""
    audios, total_s = cut_bench_audios(probe_common.bench_audios)()
    jcfg, cfg = tiny_jax(), tiny_port_config()
    jparams = jax_random_params(jcfg, seed=0)
    fmts = ("padded", "packed")
    jax_common = load_jax_script("probe_common")
    want = jax_common.warm_and_check_equal(
        {f: JaxEngine(jparams, jcfg, JaxEngineConfig(code_transfer_format=f)) for f in fmts},
        audios)
    _, jax_stages = jax_common.interleaved_rounds(
        {f: JaxEngine(jparams, jcfg, JaxEngineConfig(code_transfer_format=f)) for f in fmts},
        audios, total_s, 1)
    want_out = capsys.readouterr().out
    engines = {f: MimiEncoderEngine(random_params(cfg, seed=0), cfg,
                                    EngineConfig(code_transfer_format=f), device="cpu")
               for f in fmts}
    got = probe_common.warm_and_check_equal(engines, audios)
    results, stages = probe_common.interleaved_rounds(engines, audios, total_s, 1)
    assert_codes_equal([got], [want])
    assert lines(capsys.readouterr().out) == lines(want_out)
    assert all(len(r) == 1 and r[0] > 0 for r in results.values())
    assert {f: set(s) - PORT_SUB_STAGES for f, s in stages.items()} == {
        f: set(s) for f, s in jax_stages.items()}
    assert all(PORT_SUB_STAGES <= set(s) for s in stages.values())


class _Fixed:
    def __init__(self, codes):
        self.codes = codes

    def encode_batch(self, audios):
        return self.codes


def test_warm_and_check_equal_names_the_engine_that_differs():
    a, b = [np.zeros((2, 3), np.int32)], [np.ones((2, 3), np.int32)]
    engines = {"same": _Fixed(a), "again": _Fixed(a), "other": _Fixed(b)}
    for common in (probe_common, load_jax_script("probe_common")):
        with pytest.raises(AssertionError, match="other"):
            common.warm_and_check_equal(engines, [])


def test_drain_policy_probe_matches_jax(jax_runs, port, capsys):
    run = jax_runs["drain_policy_probe"]
    got = drain_policy_probe.main(["1", "--device", "cpu"])
    assert lines(capsys.readouterr().out) == lines(run["out"])
    # the three policies' warm codes, asserted equal by the probe
    assert_codes_equal([got["codes"]] * 3, run["warm"])
    assert got["device"] == "cpu"
    assert list(got["median_x_realtime"]) == ["fifo", "ready", "threaded"]


def test_fetch_ahead_probe_matches_jax(jax_runs, port, capsys):
    """Four sub-shards in every run; each run's hub the same, and the
    same codes as the JAX probe's hub."""
    run = jax_runs["fetch_ahead_probe"]
    got = fetch_ahead_probe.main(["1", "--device", "cpu"])
    assert lines(capsys.readouterr().out) == lines(run["out"])
    assert got["processed"] == {"warm": 4, "r0a0": 4, "r0a1": 4}
    assert len(set(got["hub_digests"].values())) == 1
    for tag in ("warm", "r0a0", "r0a1"):
        want, have = hub_codes(run["tmp"] / f"hub_{tag}"), hub_codes(port / f"hub_{tag}")
        assert sorted(have) == sorted(want) and len(want) == got["chunks"]
        for cid in want:
            np.testing.assert_array_equal(have[cid], want[cid])
            assert want[cid].shape[0] == tiny_port_config().num_quantizers


def test_fetch_dtype_probe_matches_jax(jax_runs, port, capsys):
    run = jax_runs["fetch_dtype_probe"]
    got = fetch_dtype_probe.main(["--device", "cpu"])
    assert lines(capsys.readouterr().out) == lines(run["out"])
    assert got["code_dtypes"] == {"int32": "int32", "uint16": "uint16"}
    assert_codes_equal(list(got["codes"].values()), run["warm"])
    assert got["raw_values_equal"] and got["device"] == "cpu"


def test_fetch_pack_probe_matches_jax(jax_runs, port, capsys):
    run = jax_runs["fetch_pack_probe"]
    got = fetch_pack_probe.main(["--rounds", "1", "--utts", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert lines(out) == lines(run["out"])
    want = result_of(run["out"])
    assert result_of(out) == got["result"]
    assert {k: set(v) for k, v in got["result"].items()} == {k: set(v) for k, v in want.items()}
    assert list(want) == ["padded", "packed", "compact"]
    assert_codes_equal([got["codes"]] * 3, run["warm"])


def test_growth_probe_matches_jax(jax_runs, port, capsys):
    """Per growth: the lattice's bucket count, bucket_efficiency and
    padded_frames equal to the JAX probe's (its bucket count read from its
    warm line), the JAX keys plus ``buckets``."""
    run = jax_runs["growth_probe"]
    got = growth_probe.main(["--rounds", "1", "--utts", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert [ln for ln in lines(out) if not ln.startswith("RESULT")] == \
        [ln for ln in lines(run["out"]) if not ln.startswith("RESULT")]
    want, res = result_of(run["out"]), result_of(out)
    assert res == got["result"] and list(res) == list(want) == ["1.45", "1.25", "1.15"]
    buckets = {g: int(n) for g, n in re.findall(r"warm growth=([\d.]+): .*\(buckets=(\d+)\)",
                                                run["out"])}
    for g, entry in res.items():
        assert set(entry) == set(want[g]) | {"buckets"}
        assert entry["buckets"] == buckets[g]
        assert entry["bucket_efficiency"] == want[g]["bucket_efficiency"]
        assert entry["padded_frames"] == want[g]["padded_frames"]
    assert len(set(buckets.values())) == 3
    assert_codes_equal(list(got["codes"].values()), run["warm"])


@pytest.mark.parametrize("name,mod,variants", [
    ("pipeline_depth_probe", pipeline_depth_probe, ["d12", "d18", "d24"]),
    ("samples_budget_probe", samples_budget_probe, ["b128", "b192", "b288"]),
])
def test_permuted_probe_matches_jax(jax_runs, port, capsys, name, mod, variants):
    run = jax_runs[name]
    got = mod.main(["1", "--device", "cpu"])
    assert lines(capsys.readouterr().out) == lines(run["out"])
    assert list(got["codes"]) == variants == list(got["median_x_realtime"])
    assert_codes_equal(list(got["codes"].values()), run["warm"])


PROBES = [drain_policy_probe, fetch_ahead_probe, fetch_dtype_probe, fetch_pack_probe,
          growth_probe, pipeline_depth_probe, samples_budget_probe]


@pytest.mark.parametrize("mod", PROBES, ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_refuses_without_a_card(monkeypatch, mod):
    """With no ``--device`` a probe runs on the card, and where there is
    none it raises before any work: it never falls back to the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "MimiConfig", lambda: pytest.fail("built a model"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["1"] if mod in (drain_policy_probe, fetch_ahead_probe, pipeline_depth_probe,
                                  samples_budget_probe) else [])


@pytest.fixture(scope="module")
def tie_engine():
    """A tiny port engine on the CPU and its codes of 2 x 45 s (1126
    frames: one differing frame is under 0.1 %)."""
    cfg = tiny_port_config()
    engine = MimiEncoderEngine(random_params(cfg, seed=0), cfg, EngineConfig(), device="cpu")
    rng = np.random.default_rng(11)
    audios = [(rng.standard_normal(45 * 24_000 + k) * 0.3 * 32767).astype(np.int16)
              for k in (0, 700)]
    return engine, audios, engine.encode_batch(audios)


def test_rvq_input_gives_the_engines_codes(tie_engine):
    """``rvq_input`` is the RVQ input of the engine's own encode: quantized,
    the engine's codes of each utterance, bit for bit."""
    import torch

    from tokenize_audio_tpu_torch.mimi.model import split_rvq_encode

    engine, audios, codes = tie_engine
    for audio, want in zip(audios, codes):
        emb = probe_common.rvq_input(engine, audio)
        assert emb.shape == (1, engine.cfg.hidden_size, want.shape[1])
        got = split_rvq_encode(engine.params["rvq"], emb, engine.num_codebooks, backend="torch")
        np.testing.assert_array_equal(got[0].numpy(), want)
        assert got.dtype == torch.int32


def test_within_ties_holds_the_kits_rule(tie_engine, monkeypatch):
    """One flip at an exact tie (book 0's entry duplicated) passes with
    margin 0; a flip to an unrelated entry fails on its margin; two
    differing frames fail on their share (2 of 1126 > 0.1 %)."""
    engine, audios, codes = tie_engine
    embed = engine.params["rvq"]["semantic"]["embed"].clone()
    c = int(codes[0][0, 5])
    twin, other = (c + 1) % embed.shape[1], (c + 2) % embed.shape[1]
    dup = embed.clone()
    dup[0, twin] = embed[0, c]
    monkeypatch.setitem(engine.params["rvq"]["semantic"], "embed", dup)

    def flipped(frames, to):
        got = [a.copy() for a in codes]
        for f in frames:
            got[0][0, f] = to
        return got

    rep = probe_common.within_ties(engine, audios, flipped([5], twin), codes, "tie")
    assert rep == {"frames": 1126, "equal_frames": 1125, "flip_margins": [0.0]}
    assert probe_common.within_ties(engine, audios, codes, codes, "same")["flip_margins"] == []
    with pytest.raises(AssertionError, match="non-tie"):
        probe_common.within_ties(engine, audios, flipped([5], other), codes, "non-tie")
    # the share of frames is held before the margins
    with pytest.raises(AssertionError, match="1124 of 1126 frames"):
        probe_common.within_ties(engine, audios, flipped([5, 6], twin), codes, "two")
