"""PyTorch port, isolation: no module of the port (nor chip_smoke.py) pulls in
JAX or the JAX package (the ported scripts' shell wrappers name none of its
modules either), loads tokenizers or transformers, or initializes
torch.distributed on import; no chaos child of the port and no crash-window
test imports JAX or the JAX package, even through a test helper; the kernel
build fails loudly without nvcc and removes what a killed build left."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SCRIPTS = ("", ".bf16_qualification", ".precision_probe", ".split_boundary_census",
           ".resampler_sensitivity", ".seanet_backend_probe", ".stream_policy_probe",
           ".parity_census", ".parity_sweep", ".pipeline_bench", ".probe_common",
           ".drain_policy_probe", ".fetch_ahead_probe", ".fetch_dtype_probe",
           ".fetch_pack_probe", ".growth_probe", ".pipeline_depth_probe",
           ".samples_budget_probe", ".warmup_tails_receipt", ".conv_layout_probe")

_PROBE = r"""
import importlib, pkgutil, sys
import tokenize_audio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import torch.distributed
assert not torch.distributed.is_initialized(), "importing the port initialized torch.distributed"
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "tokenize_audio_tpu" or m.startswith("tokenize_audio_tpu.")
)
heavy = sorted(m for m in sys.modules if m.split(".")[0] in ("transformers", "tokenizers"))
print(",".join(names))
print(bad)
print(heavy)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, bad, heavy = out.stdout.strip().splitlines()[-3:]
    names = names.split(",")
    assert len(names) >= 75  # every module of the slices so far was imported
    for name in ("benchmark", "io.mp3enc", "datasets.yodas2", "engine.encoder",
                 "mimi.streaming", "mimi.decoder", "codec", "core.codes", "__main__",
                 "datasets.base", "datasets.parquet_utils", "datasets.parquet_corpus",
                 "datasets.librispeech", "datasets.mls", "datasets.emilia", "qualify",
                 "runner.pod_runner", "runner.chip_check", "runner.manifests",
                 "runner.monitor", "datasets.pretrain_converter", "datasets.derivatives",
                 "datasets.cvss", "bpe", "bpe.sampler", "bpe.trainer", "bpe.surgery",
                 "analytics", "analytics.count_rows", "analytics.estimate_tokens",
                 "analytics.validate", "parallel", "parallel.mesh", "parallel.multihost",
                 *(f"scripts{s}" for s in SCRIPTS)):
        assert f"tokenize_audio_tpu_torch.{name}" in names
    assert bad == "[]", f"the port imported {bad}"
    # tokenizers and transformers load where they are used (bpe, analytics,
    # qualify), never when a module is imported
    assert heavy == "[]", f"importing the port loaded {heavy}"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from tokenize_audio_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # nothing cached
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rvq"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("seanet_resblock", "resblock_elu_launch", [])


def test_build_removes_a_dead_builders_output(tmp_path, monkeypatch):
    """A build killed before its ``os.replace`` leaves
    ``lib<name>-<key>.<pid>.tmp.so``: the next build deletes it when that pid
    is dead and leaves a live builder's file alone (nvcc stubbed)."""
    from tokenize_audio_tpu_torch.ops.cuda import _build

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    # writes the file after -o, as nvcc would
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\necho lib > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.BUILD_DIR.mkdir()
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    builder = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)"])
    try:
        stem = _build.library_path("rvq").stem
        stale = _build.BUILD_DIR / f"{stem}.{dead.pid}.tmp.so"
        live = _build.BUILD_DIR / f"{stem}.{builder.pid}.tmp.so"
        other = _build.BUILD_DIR / "libseanet_resblock-0123456789abcdef.999999999.tmp.so"
        for f in (stale, live, other):
            f.write_text("half a library")
        seconds = _build.build(["rvq"])
        assert seconds["rvq"] > 0.0 and _build.library_path("rvq").read_text() == "lib\n"
        assert not stale.exists() and not other.exists()  # dead builders (no pid 999999999)
        assert live.read_text() == "half a library"  # a live builder's, left alone
        stale.write_text("half a library")
        assert _build.build(["rvq"]) == {"rvq": 0.0}  # cached: cleans up all the same
        assert not stale.exists() and live.exists()
    finally:
        builder.kill()
        builder.wait()


TESTS = ROOT / "tests"
FORBIDDEN = ("jax", "jaxlib", "tokenize_audio_tpu")


def _imports(path: Path) -> set:
    """Every absolute module name ``path`` imports, at any depth of its code."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def _forbidden_imports(path: Path, seen=None) -> list:
    """(file, module) for each import of JAX or the JAX package by ``path``
    or by a test helper it imports (as ``tests.name`` or by its own name)."""
    seen = set() if seen is None else seen
    seen.add(path)
    bad = []
    for name in sorted(_imports(path)):
        if name.split(".")[0] in FORBIDDEN:
            bad.append((path.name, name))
            continue
        helper = TESTS / (name.split(".")[-1] + ".py")
        local = name.startswith("tests.") or "." not in name
        if local and helper.is_file() and helper not in seen:
            bad += _forbidden_imports(helper, seen)
    return bad


def test_chaos_children_and_crash_windows_import_no_jax():
    children = sorted(TESTS.glob("torch_*chaos*_child.py"))
    windows = sorted(TESTS.glob("test_torch_crash_windows_*.py"))
    names = {p.name for p in children}
    for family in ("yodas2", "corpus", "runner", "mls", "emilia", "sampler", "estimate"):
        assert f"torch_{family}_chaos_child.py" in names
    assert len(windows) >= 2
    for path in children + windows:
        assert _forbidden_imports(path) == [], path.name
    # the check itself sees an import through a helper
    assert _forbidden_imports(TESTS / "test_torch_yodas2.py")


def test_scripts_name_no_jax_module():
    """Each ported script imports nothing of JAX or the JAX package at any
    depth of its code, and each shell wrapper runs only the port's modules."""
    scripts = ROOT / "tokenize_audio_tpu_torch" / "scripts"
    pys = sorted(scripts.glob("*.py"))
    assert len(pys) == len(SCRIPTS)
    for path in pys:
        assert not [n for n in _imports(path) if n.split(".")[0] in FORBIDDEN], path.name
    for name in ("run_yodas2_pod.sh", "monitor.sh"):
        text = (scripts / name).read_text()
        assert "python -m tokenize_audio_tpu_torch." in text, name
        assert "tokenize_audio_tpu." not in text and "TPU_VISIBLE" not in text, name
