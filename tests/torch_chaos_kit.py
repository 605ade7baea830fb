"""What the port's processor chaos children (``tests/torch_*_chaos_child.py``)
share: their flags, the engine at the tiny config, the ``--kill-at`` hook and
the DONE line.

``--kill-at WHEN:MODULE:ATTR:N`` replaces ``MODULE.ATTR`` (a function, or a
method as ``Class.method``) in this process only: at its N-th call the child
prints ``KILL <spec> <str arguments>`` and SIGKILLs itself, ``before`` the
call runs or ``after`` it returned (printing its short string arguments,
paths for the most part). A crash window is thereby named by the function
that opens it, and nothing in the package changes.

Imported by its own name (the children run with ``tests/`` as their script
directory). Imports nothing of JAX or the JAX package."""

from __future__ import annotations

import argparse
import importlib
import json
import os
import signal
import threading

from torch_fleet_child import TINY

# the JAX chaos children's engine (tests/yodas2_chaos_child.py and the others)
ENGINE_KW = dict(batch_size=4, min_bucket_seconds=0.25, max_chunk_seconds=2.0)


def parser(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc)
    ap.add_argument("--params", default=None,
                    help="an HF Mimi model.safetensors at the tiny config (default: the "
                         "port's seeded random weights at that config)")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA device)")
    ap.add_argument("--kill-at", default=None, metavar="WHEN:MODULE:ATTR:N",
                    help="SIGKILL this process at the N-th call of MODULE.ATTR, "
                         "'before' it runs or 'after' it returned")
    return ap


def make_engine(args, num_codebooks=None):
    """The port's engine at ``TINY`` with the JAX children's EngineConfig."""
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi import MimiConfig
    from tokenize_audio_tpu_torch.mimi.weights import params_from_safetensors, random_params

    cfg = MimiConfig(**TINY)
    params = params_from_safetensors(args.params, cfg) if args.params else random_params(cfg)
    return MimiEncoderEngine(params, cfg, EngineConfig(**ENGINE_KW),
                             num_codebooks=num_codebooks, device=args.device)


def arm_kill(spec) -> None:
    """Install ``--kill-at``'s hook (no-op for ``None``)."""
    if spec is None:
        return
    when, module, attr_path, n = spec.split(":")
    if when not in ("before", "after"):
        raise ValueError(f"--kill-at: WHEN is 'before' or 'after', not {when!r}")
    owner = importlib.import_module(module)
    *parents, attr = attr_path.split(".")
    for p in parents:
        owner = getattr(owner, p)
    real, target, calls, lock = getattr(owner, attr), int(n), [0], threading.Lock()

    def die(args):
        shown = " ".join(str(a) for a in args if isinstance(a, (str, os.PathLike, int, list))
                         and len(str(a)) < 2000)
        print(f"KILL {spec} {shown}", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)

    def hooked(*args, **kwargs):
        with lock:
            calls[0] += 1
            hit = calls[0] == target
        if hit and when == "before":
            die(args)
        out = real(*args, **kwargs)
        if hit and when == "after":
            die(args)
        return out

    setattr(owner, attr, hooked)


def done(report, engine) -> None:
    """The DONE line: the report and how many utterances this run encoded."""
    print("DONE " + json.dumps({"report": report, "utterances": engine.stats.utterances}),
          flush=True)
