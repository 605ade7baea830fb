"""PyTorch port, isolation: no module of the port (nor chip_smoke.py) pulls in
JAX or the JAX package, and the kernel build fails loudly without nvcc."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import tokenize_audio_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == "jaxlib" or m.startswith("jaxlib.")
    or m == "tokenize_audio_tpu" or m.startswith("tokenize_audio_tpu.")
)
print(",".join(names))
print(bad)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().splitlines()[-2:]
    names = names.split(",")
    assert len(names) >= 46  # every module of the slices so far was imported
    for name in ("benchmark", "io.mp3enc", "datasets.yodas2", "engine.encoder",
                 "mimi.streaming", "mimi.decoder", "codec", "core.codes", "__main__",
                 "datasets.base", "datasets.parquet_utils", "datasets.parquet_corpus",
                 "datasets.librispeech", "datasets.mls", "datasets.emilia"):
        assert f"tokenize_audio_tpu_torch.{name}" in names
    assert bad == "[]", f"the port imported {bad}"


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    from tokenize_audio_tpu_torch.ops.cuda import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")  # nothing cached
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["rvq"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("seanet_resblock", "resblock_elu_launch", [])
