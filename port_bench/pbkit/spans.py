"""``record_function`` ranges around the program's functions, put there by
the benchmark for the traced segment only, and taken away after it. The
program is not edited: a module's, class's or engine's attribute is
replaced by a wrapper that calls the original inside a range named
``port_bench::<name>``. The model's functions are looked up in their
module at every call, so the wrappers see every call the engine makes.

A target may also take a note of each call: ``seanet_encode``'s keeps the
rows' valid lengths (the device tensor itself, read only after the
segment, so the note adds no wait), from which the rooflines count each
call's work.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Iterable, List, Optional


def ranged(fn, name: str, note: Optional[Callable] = None, notes: Optional[list] = None):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if note is not None:
            notes.append(note(*args, **kwargs))
        with record_function(f"port_bench::{name}"):
            return fn(*args, **kwargs)

    return wrapper


def seanet_rows(params, cfg, x, valid=None, *args, **kwargs) -> tuple:
    """A ``seanet_encode`` call's note: (rows, samples per row, the valid
    lengths' tensor or None where every column is valid)."""
    return x.shape[0], x.shape[-1], valid


def rows_of(note: tuple) -> List[int]:
    """Valid samples per row of a ``seanet_rows`` note."""
    b, t, valid = note
    return [t] * b if valid is None else [int(n) for n in valid.tolist()]


def model_targets(notes: Optional[dict] = None) -> list:
    """The model's stages, by the module functions that ``encode`` calls;
    ``notes["seanet_encode"]``, where given, gathers ``seanet_rows``."""
    from tokenize_audio_tpu_torch.mimi import model

    seanet = (model, "seanet_encode", "seanet_encode")
    if notes is not None:
        seanet += (seanet_rows, notes.setdefault("seanet_encode", []))
    return [
        seanet,
        (model, "transformer_apply", "transformer_apply"),
        (model, "split_rvq_encode", "split_rvq_encode"),
    ]


@contextlib.contextmanager
def installed(targets: Iterable[tuple]):
    """Wrap each ``(owner, attribute, range name[, note, notes])`` for the
    enclosed block."""
    missing = object()
    saved = []
    try:
        for owner, attr, name, *noted in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, vars(owner).get(attr, missing)))
            setattr(owner, attr, ranged(fn, name, *noted))
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if old is missing:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
