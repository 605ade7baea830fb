"""PyTorch port, qualification scripts, part 2: the resampler sensitivity,
the stream-policy and SEANet-backend probes, the pipeline-bench shim and
the shell wrappers, against the JAX package's scripts (``scripts/``, loaded
by path) on the tiny oracle config on the CPU: match rates and reports
equal, the filter design restored afterwards, and each wrapper's argv equal
to the JAX one's with the package renamed. (Part 3, the parity census and
sweep: tests/test_torch_scripts_parity.py.)"""

import functools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import tokenize_audio_tpu.config as jax_config
import tokenize_audio_tpu.mimi as jax_mimi
import tokenize_audio_tpu_torch.core.audio as audio_mod
from tests.torch_scripts import (
    ROOT,
    load_jax_script,
    no_compile_cache,
    run_jax_main,
    tiny_jax,
    tiny_port_config,
)
from tokenize_audio_tpu_torch.scripts import (
    resampler_sensitivity,
    seanet_backend_probe,
    stream_policy_probe,
)


def _lines(out: str) -> list:
    return [ln for ln in out.splitlines() if not ln.startswith("device:")]


def test_resampler_sensitivity_matches_jax_and_restores_the_design(monkeypatch, capsys):
    """Both scripts on three fixtures per rate at the tiny config: the same
    printed lines (waveform deltas, code, frame and per-book match), and
    afterwards the production design back in ``core.audio`` with its plan
    rebuilt from it."""
    base, plan = audio_mod._kaiser_sinc_filter, audio_mod._resample_plan(3, 2)
    jax_mod = load_jax_script("resampler_sensitivity")
    few = dict(n=3, max_s=1.5)
    monkeypatch.setattr(jax_mod, "MimiConfig", tiny_jax)
    monkeypatch.setattr(jax_mod, "make_fixtures", functools.partial(jax_mod.make_fixtures, **few))
    jax_mod.main()
    want = _lines(capsys.readouterr().out)
    monkeypatch.setattr(resampler_sensitivity, "MimiConfig", tiny_port_config)
    monkeypatch.setattr(resampler_sensitivity, "make_fixtures",
                        functools.partial(resampler_sensitivity.make_fixtures, **few))
    got = resampler_sensitivity.main(["--device", "cpu"])
    assert _lines(capsys.readouterr().out) == want
    assert len(want) == 4 and sorted(got) == [16_000, 48_000]
    for sr, rep in got.items():
        line = next(ln for ln in want if ln.startswith(f"{sr} Hz"))
        assert f"code match {100 * rep['code_match']:.2f}%" in line
        assert rep["fixtures"] == 3 and rep["max_waveform_delta"] > 1e-7
    assert audio_mod._kaiser_sinc_filter is base
    np.testing.assert_array_equal(audio_mod._resample_plan(3, 2)[0], plan[0])


def test_resampler_design_restored_when_an_encode_fails():
    base = audio_mod._kaiser_sinc_filter
    sharp = resampler_sensitivity.with_filter(24, 12.0)
    x = np.zeros(800, dtype=np.float32)
    with pytest.raises(TypeError):
        resampler_sensitivity.encode_with(None, tiny_port_config(), [x], 16_000, sharp, "cpu")
    assert audio_mod._kaiser_sinc_filter is base
    want = audio_mod._kaiser_sinc_filter(3, 2)
    assert len(sharp(3, 2)) > len(want)
    audio_mod._resample_plan.cache_clear()
    np.testing.assert_array_equal(audio_mod._resample_plan(3, 2)[0],
                                  resampler_sensitivity.audio_mod._resample_plan(3, 2)[0])


def _short_cap(config_mod, monkeypatch, cap=4.0):
    """The scripts' EngineConfig with a ``cap`` s split (their audio stays
    short on the CPU)."""
    real = config_mod.EngineConfig
    monkeypatch.setattr(config_mod, "EngineConfig",
                        lambda **kw: real(**{**kw, "max_chunk_seconds": cap}))


def test_stream_policy_probe_matches_jax(monkeypatch, capsys):
    """Two 9 s utterances over a 4 s cap: the same report keys, sizes and
    split-vs-stream agreement in both packages."""
    no_compile_cache(monkeypatch)
    monkeypatch.setattr(jax_mimi, "MimiConfig", tiny_jax)
    _short_cap(jax_config, monkeypatch)
    argv = ["--n", "2", "--seconds", "9", "--rounds", "1", "--stream-batch", "2"]
    run_jax_main(load_jax_script("stream_policy_probe"), argv, monkeypatch)
    want = json.loads(capsys.readouterr().out.splitlines()[-1])
    monkeypatch.setattr(stream_policy_probe, "MimiConfig", tiny_port_config)
    _short_cap(stream_policy_probe, monkeypatch)
    got = stream_policy_probe.main(argv + ["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == got
    assert got.keys() == want.keys()
    for key in ("probe", "n_utts", "seconds_each", "stream_batch",
                "code_agreement_split_vs_stream"):
        assert got[key] == want[key], key
    assert len(got["split_seconds"]) == len(got["stream_seconds"]) == 1
    assert got["device"] == "cpu" and got["stream_x_realtime"] > 0
    assert got["code_agreement_split_vs_stream"] < 1  # the 4 s seams


RENAMED = {"seanet xla   ": "seanet torch ", "seanet pallas": "seanet kernel",
           "encode xla   ": "encode torch ", "encode pallas": "encode kernel",
           "code agreement pallas-vs-xla": "code agreement kernel-vs-torch"}
AGREEMENT = re.compile(r"code agreement \S+: ([\d.]+)% codes, ([\d.]+)% frames fully "
                       r"identical \((\d+) frames\)")


def test_seanet_backend_probe_matches_jax(monkeypatch, capsys):
    """Both probes at 1 x 1 s: the same lines (the port names its backends
    "torch" and "kernel" for JAX's "xla" and "pallas", run in interpret
    mode on the CPU) and the same code agreement."""
    no_compile_cache(monkeypatch)
    monkeypatch.setattr(jax_mimi, "MimiConfig", tiny_jax)
    argv = ["--batch", "1", "--seconds", "1"]
    run_jax_main(load_jax_script("seanet_backend_probe"), argv, monkeypatch)
    want = _lines(capsys.readouterr().out)
    monkeypatch.setattr(seanet_backend_probe, "MimiConfig", tiny_port_config)
    got = seanet_backend_probe.main(argv + ["--device", "cpu"])
    lines = _lines(capsys.readouterr().out)
    assert [ln.split(":")[0] for ln in lines] == [RENAMED[ln.split(":")[0]] for ln in want]
    w, g = AGREEMENT.search(want[-1]).groups(), AGREEMENT.search(lines[-1]).groups()
    assert g == w and int(g[2]) == got["frames"] == 4 * 1 * 12
    assert got["code_agreement"] == got["frame_agreement"] == 1.0


def test_pipeline_bench_forwards_to_the_benchmark(monkeypatch):
    from tokenize_audio_tpu_torch import benchmark

    seen = []
    monkeypatch.setattr(benchmark, "main", lambda argv: seen.append(argv) or 0)
    monkeypatch.setattr(sys, "argv", ["pipeline_bench", "--subshards", "1", "--device", "cpu"])
    import runpy

    with pytest.raises(SystemExit) as exit_:
        runpy.run_module("tokenize_audio_tpu_torch.scripts.pipeline_bench", run_name="__main__")
    assert exit_.value.code == 0
    assert seen == [["--pipeline", "--subshards", "1", "--device", "cpu"]]


SHIM = '#!/bin/sh\nprintf "%s\\0" "$@" > "$ARGV_RECORD"\n'


def _exec_argv(script, args, env, tmp_path) -> list:
    """The argv ``script`` execs ``python`` with (a recording shim first on
    PATH)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir(exist_ok=True)
    shim = bin_dir / "python"
    shim.write_text(SHIM)
    shim.chmod(0o755)
    record = tmp_path / "argv"
    full = {**os.environ, **env, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
            "ARGV_RECORD": str(record)}
    subprocess.run(["bash", str(script)] + args, env=full, check=True, timeout=60)
    return record.read_bytes().decode().split("\0")[:-1]


WRAPPERS = [
    ("run_yodas2_pod.sh", ["shards.txt"], {"TARGET_HUB": "hf:me/codes"}),
    ("run_yodas2_pod.sh", ["shards.txt", "4"],
     {"TARGET_HUB": "dir:/h", "DATA_DIR": "/d", "PARAMS": "/p.safetensors",
      "SOURCE_HUB": "dir:/src"}),
    ("monitor.sh", [], {}),
    ("monitor.sh", ["5"], {"DATA_DIR": "/d", "EXPECTED": "12"}),
]


@pytest.mark.parametrize("name,args,env", WRAPPERS)
def test_shell_wrapper_execs_the_port(tmp_path, name, args, env):
    """The port's wrapper execs the JAX one's argv with every
    ``tokenize_audio_tpu.`` module renamed to ``tokenize_audio_tpu_torch.``,
    and names no module of the JAX package."""
    want = _exec_argv(ROOT / "scripts" / name, args, env, tmp_path)
    got = _exec_argv(ROOT / "tokenize_audio_tpu_torch" / "scripts" / name, args, env, tmp_path)
    assert got == [a.replace("tokenize_audio_tpu.", "tokenize_audio_tpu_torch.") for a in want]
    assert got[0] == "-m" and got[1].startswith("tokenize_audio_tpu_torch.")
    assert not any(a.startswith("tokenize_audio_tpu.") for a in got)
    if name == "run_yodas2_pod.sh":
        assert "tokenize_audio_tpu_torch.datasets.yodas2" in got
