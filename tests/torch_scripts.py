"""Helpers of the scripts tests (tests/test_torch_scripts*.py): the JAX
package's scripts loaded by path (nothing under ``scripts/`` changes), the
tiny oracle's configs for both packages, and JAX's k-means draws."""

import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np

from tests.mimi_fixtures import tiny_jax_config
from tokenize_audio_tpu.mimi.config import MimiConfig as JaxMimiConfig
from tokenize_audio_tpu_torch.mimi import MimiConfig

ROOT = Path(__file__).resolve().parents[1]
TINY_JAX = dataclasses.asdict(tiny_jax_config())
# its widths in the port's config (the backends are the JAX package's names)
TINY = {k: v for k, v in TINY_JAX.items() if k not in ("rvq_backend", "seanet_backend")}


def load_jax_script(name: str, monkeypatch=None):
    """``scripts/<name>.py`` as a fresh module; ``bf16_qualification`` is
    also registered under its own name (``precision_probe`` imports it so)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if monkeypatch is not None and name == "bf16_qualification":
        monkeypatch.setitem(sys.modules, "bf16_qualification", mod)
    return mod


def tiny_port_config(**kw) -> MimiConfig:
    """The port's MimiConfig at the tiny oracle's widths."""
    return MimiConfig(**{**TINY, **kw})


def tiny_jax(**kw):
    """The JAX package's MimiConfig at the tiny widths (safe to patch in for
    ``tokenize_audio_tpu.mimi.MimiConfig``)."""
    return JaxMimiConfig(**{**TINY_JAX, **kw})


def jax_kmeans_inits(n: int, k: int, levels: int, seed: int = 7) -> list:
    """The rows the JAX ``train_codebooks`` draws as initial centroids, per
    level (semantic first): ``jax.random.choice`` on its key splits."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(levels):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.choice(sub, n, shape=(k,), replace=n < k)))
    return out


def no_compile_cache(monkeypatch) -> None:
    """The JAX scripts enable a persistent compile cache under ``~``: off
    in the tests."""
    import tokenize_audio_tpu.utils as jax_utils

    monkeypatch.setattr(jax_utils, "enable_compile_cache", lambda *a, **k: None)


def run_jax_main(mod, argv, monkeypatch):
    """A JAX script's ``main()``, which parses ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    return mod.main()
