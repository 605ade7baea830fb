"""Nothing the benchmark runs on the card imports JAX or the JAX package,
compared by whole top-level module name."""

import ast
import os
import subprocess
import sys

import pytest

from bench_testkit import BENCH, ROOT
from pbkit import runner


@pytest.mark.parametrize("names,found", [
    (["tokenize_audio_tpu_torch", "tokenize_audio_tpu_torch.mimi.model", "torch"], []),
    (["tokenize_audio_tpu", "torch"], ["tokenize_audio_tpu"]),
    (["tokenize_audio_tpu.mimi"], ["tokenize_audio_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "tokenize_audio_tpu_extra"], []),
])
def test_forbidden_modules_by_whole_top_level_name(names, found):
    assert runner.forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(BENCH):
        if os.path.basename(dirpath) == "tests":
            continue
        for name in files:
            if name.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, name)):
                    assert mod.split(".")[0] not in runner.FORBIDDEN, (name, mod)


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench_testkit\n"
        "run, result, line = bench_testkit.run_tiny('engine-web.8cb', %r, seconds=0.1)\n"
        "from pbkit import runner\n"
        "print(runner.forbidden_modules())\n"
    ) % (os.path.join(BENCH, "tests"), BENCH, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_fails_without_the_program(tmp_path):
    import shutil

    shutil.copytree(BENCH, tmp_path / "port_bench")
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", "engine-web.8cb", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )
    assert out.returncode != 0 and out.stdout.strip() == ""
