"""Code <-> unicode-character codec (the port's copy of the JAX package's
``core/codes.py``).

Maps ``(num_codebooks, T)`` integer RVQ codes to a unicode string and back:
code ``c`` of codebook ``k`` maps to ``chr(offset + k*codebook_size + c)``,
frames interleaved frame-major (``codes.T.reshape(-1)``).

Semantics replicate the reference's validated converter
(``pretraining-data/converter.py:17-140``) exactly, including
surrogate-range offset validation, sequential inconsistent-code dropping,
and hanging-code trimming at both sequence edges — but vectorized with
numpy fast paths (the reference loops in Python per character).

The "simple" non-validating variant used by the per-dataset processors
(``librispeech-mimi/utils.py:18-55``) is the same API with
``drop_inconsistent_codes=False, drop_hanging_codes=False``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple, Union

import numpy as np

from tokenize_audio_tpu_torch.config import UNICODE_OFFSET, UNICODE_OFFSET_LARGE

logger = logging.getLogger(__name__)

_SURROGATE_LO = 0xD800
_SURROGATE_HI = 0xDFFF

ArrayLike = Union[List[List[int]], np.ndarray]


def validate_unicode_offset(unicode_offset: int, num_codebooks: int, codebook_size: int) -> int:
    """Reject offsets whose code range intersects the non-printable surrogate
    block [0xD800, 0xDFFF] (reference: pretraining-data/converter.py:68-81)."""
    lower = unicode_offset
    upper = unicode_offset + num_codebooks * codebook_size
    # [lower, upper) intersects the inclusive block [0xD800, 0xDFFF]
    if lower <= _SURROGATE_HI and upper > _SURROGATE_LO:
        raise ValueError(
            f"Unicode offset {hex(unicode_offset)} with base vocabulary size "
            f"{num_codebooks * codebook_size} intersects the surrogate range "
            f"0xD800-0xDFFF. Use an offset past the surrogates, e.g. "
            f"{hex(UNICODE_OFFSET_LARGE)}."
        )
    return unicode_offset


def _as_numpy(codes: ArrayLike) -> np.ndarray:
    if isinstance(codes, np.ndarray):
        return codes
    if hasattr(codes, "detach"):  # torch tensor, possibly on the card
        return codes.detach().cpu().numpy()
    return np.asarray(codes)


def codes_to_chars(
    codes: ArrayLike,
    codebook_size: int,
    copy_before_conversion: bool = True,  # kept for API parity; conversion never mutates
    unicode_offset: int = UNICODE_OFFSET,
) -> str:
    """Convert a ``(num_codebooks, T)`` code array to a frame-major unicode string.

    Reference: pretraining-data/converter.py:17-37 (identical output).
    """
    del copy_before_conversion  # we always operate out-of-place
    arr = _as_numpy(codes)
    if arr.ndim != 2:
        raise ValueError("codes must be a 2D array of shape (num_codebooks, seq_length).")
    num_codebooks = arr.shape[0]
    validate_unicode_offset(unicode_offset, num_codebooks, codebook_size)
    offsets = unicode_offset + np.arange(num_codebooks, dtype=np.int64) * codebook_size
    shifted = arr.astype(np.int64) + offsets[:, None]
    flat = shifted.T.reshape(-1)
    # np.uint32 -> UTF-32 string in one shot: ~100x faster than per-char chr().
    return flat.astype("<u4").tobytes().decode("utf-32-le")


def _chars_to_codepoints(chars: str) -> np.ndarray:
    # surrogatepass keeps lone surrogates (legal in Python strings) from
    # crashing the vectorized decode; they are then dropped outright —
    # deliberate robustness deviation from the reference, whose per-char ord()
    # can alias a surrogate into a valid-looking codebook slot at small
    # offsets and emit an out-of-range code.
    data = chars.encode("utf-32-le", "surrogatepass")
    cps = np.frombuffer(data, dtype="<u4").astype(np.int64)
    return cps[(cps < _SURROGATE_LO) | (cps > _SURROGATE_HI)]


def resolve_codebook(
    code: Union[int, np.ndarray],
    num_codebooks: int,
    codebook_size: int,
    unicode_offset: int,
) -> Union[int, np.ndarray]:
    """Which codebook a raw codepoint belongs to.

    Matches the reference's downward scan (pretraining-data/converter.py:83-87):
    values below the offset resolve to -1; values past the last codebook clamp
    to ``num_codebooks - 1``.
    """
    rel = (np.asarray(code, dtype=np.int64) - unicode_offset) // codebook_size
    out = np.where(rel < 0, -1, np.minimum(rel, num_codebooks - 1))
    if np.isscalar(code) or (isinstance(code, np.ndarray) and code.ndim == 0):
        return int(out)
    return out


def _drop_inconsistent(
    codes: np.ndarray, num_codebooks: int, codebook_size: int, unicode_offset: int
) -> np.ndarray:
    """Sequentially drop codes whose codebook does not match the expected
    cyclic order (reference: converter.py:89-112).

    Fast path: if the sequence already follows the strict cyclic pattern
    starting from its first code's codebook, nothing is dropped — verified
    with one vectorized comparison. The stateful scan only runs on dirty
    input (rare in practice: only corrupted BPE output).
    """
    if codes.size == 0:
        return codes
    cbs = resolve_codebook(codes, num_codebooks, codebook_size, unicode_offset)
    start = int(cbs[0])
    if start < 0:
        start = 0
    expected_clean = (start + np.arange(codes.size, dtype=np.int64)) % num_codebooks
    if np.array_equal(cbs, expected_clean):
        return codes
    mask = np.ones(codes.size, dtype=bool)
    expected = start
    for i in range(codes.size):
        if int(cbs[i]) != expected:
            mask[i] = False
            logger.warning(
                "Dropped inconsistent audio code at position %d. "
                "Expected codebook %d but got codebook %d.",
                i,
                expected,
                int(cbs[i]),
            )
        else:
            expected = (expected + 1) % num_codebooks
    return codes[mask]


def _drop_hanging(
    codes: np.ndarray, num_codebooks: int, codebook_size: int, unicode_offset: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Trim partial frames from the sequence edges
    (reference: converter.py:114-140).

    The head is trimmed until the first code resolving to codebook 0; the
    tail until the last code resolving to codebook ``num_codebooks-1``.
    """
    cbs = resolve_codebook(codes, num_codebooks, codebook_size, unicode_offset)
    n = codes.size
    head_is_zero = cbs == 0
    begin = int(np.argmax(head_is_zero)) if head_is_zero.any() else n
    tail_is_last = cbs == num_codebooks - 1
    if tail_is_last[begin:].any():
        end = n - int(np.argmax(tail_is_last[::-1]))
    else:
        end = begin
    begin_hanging = codes[:begin]
    end_hanging = codes[end:]
    return codes[begin:end], begin_hanging, end_hanging


def chars_to_codes(
    chars: str,
    num_codebooks: int,
    codebook_size: int,
    drop_inconsistent_codes: bool = True,
    drop_hanging_codes: bool = True,
    return_hanging_codes_chars: bool = False,
    return_tensors: Optional[str] = None,
    unicode_offset: int = UNICODE_OFFSET,
):
    """Convert a frame-major unicode string back to ``(num_codebooks, T)`` codes.

    Reference: pretraining-data/converter.py:39-66 (identical output, incl.
    hanging-code character returns). ``return_tensors``: None -> nested
    lists, "np" -> numpy int64, "pt" -> torch tensor (imported lazily).
    """
    validate_unicode_offset(unicode_offset, num_codebooks, codebook_size)
    codes = _chars_to_codepoints(chars)
    begin_hanging = np.empty(0, dtype=np.int64)
    end_hanging = np.empty(0, dtype=np.int64)
    if drop_inconsistent_codes:
        codes = _drop_inconsistent(codes, num_codebooks, codebook_size, unicode_offset)
    if drop_hanging_codes:
        codes, begin_hanging, end_hanging = _drop_hanging(
            codes, num_codebooks, codebook_size, unicode_offset
        )
    if codes.size % num_codebooks != 0:
        hint = (
            "pass drop_hanging_codes=True to trim partial frames"
            if not drop_hanging_codes
            else "the stream has out-of-cycle codes inside the trimmed "
            "region; pass drop_inconsistent_codes=True to drop them"
        )
        raise ValueError(
            f"Code stream length {codes.size} is not divisible by num_codebooks "
            f"{num_codebooks}; {hint}."
        )
    codes = codes.reshape(-1, num_codebooks).T
    offsets = unicode_offset + np.arange(num_codebooks, dtype=np.int64) * codebook_size
    codes = codes - offsets[:, None]

    if return_tensors is None:
        out = codes.tolist()
    elif return_tensors == "np":
        out = codes
    elif return_tensors == "pt":
        import torch

        out = torch.tensor(codes)
    else:
        raise ValueError(f"Unknown return_tensors={return_tensors!r}")

    if return_hanging_codes_chars:
        to_str = lambda a: a.astype("<u4").tobytes().decode("utf-32-le", "surrogatepass")  # noqa: E731
        return out, to_str(begin_hanging), to_str(end_hanging)
    return out
