"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
by ``nvcc`` for Hopper (``sm_90a``) into a shared library, loaded with
``ctypes``. Libraries are cached under ``tokenize_audio_tpu_torch/_build/``
(listed in ``.gitignore``), keyed by a hash of the source and the flags, so
a changed source rebuilds and an unchanged one loads at once. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("rvq", "seanet_resblock")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "tokenize_audio_tpu_torch are built from source at first use and need "
        "the CUDA toolkit (run on the CPU with device='cpu' instead)"
    )


def nvcc_command(src: Path, out: Path) -> list:
    """The ``nvcc`` command that builds ``src`` into the shared library
    ``out``."""
    return [find_nvcc(), *FLAGS, "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is not cached yet, one
    ``nvcc`` process per source, all started together. Returns the build
    seconds per name (0.0 for a cached library); raises on any failure with
    the compiler's output. ``nvcc -Xptxas -v``'s report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    names = list(names)
    todo = [n for n in names if not library_path(n).is_file()]
    seconds = {n: 0.0 for n in names}
    if not todo:
        return seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = nvcc_command(CSRC / f"{n}.cu", tmp)
        procs.append((n, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for n, out, tmp, p in procs:
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failures.append(f"--- nvcc {n}.cu (exit {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of a built kernel library."""
    return library_path(name).with_suffix(".log").read_text()


def load(name: str, fn: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of kernel library ``name`` (built at first use),
    with its argument types set and an ``int`` (cudaError_t) result."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f
