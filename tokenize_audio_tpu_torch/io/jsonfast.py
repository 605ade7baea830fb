"""Fast JSON serialization of integer code matrices.

The raw YODAS2 stage stores every entry's codes as JSON int lists
(reference format contract, yodas2-mimi/process_shard.py:520-523), so a
500-file sub-shard serializes tens of millions of ints per output file.
``json.dumps(arr.tolist())`` materializes a Python int object per code and
re-formats each one; at ~80 ms per million codes that is the dominant
write-behind cost and — because both ``tolist`` and ``dumps`` hold the GIL
— it steals time from the main thread that keeps the GPU fed.

``int_matrix_to_json`` instead maps each value to a PRE-BUILT decimal
string through a 65536-entry lookup table (one vectorized ``take``, no new
Python objects per element) and joins rows at C speed: ~2.5x faster and
far less GIL pressure. Output parses identically to the ``json.dumps``
form (compact separators).
"""

from __future__ import annotations

import json

import numpy as np

_LUT = None


def _lut() -> np.ndarray:
    global _LUT
    if _LUT is None:
        _LUT = np.array([str(i) for i in range(65536)], dtype=object)
    return _LUT


def int_matrix_to_json(a) -> str:
    """Serialize a 1-D or 2-D integer array to a JSON array (of arrays)
    of ints, byte-parseable identically to ``json.dumps(a.tolist())``.

    Values must fit uint16 (codebooks are 2048 wide); anything else falls
    back to ``json.dumps`` so the function is safe on arbitrary input.
    """
    a = np.asarray(a)
    if (
        a.ndim not in (1, 2)
        or not np.issubdtype(a.dtype, np.integer)
        or (a.size and (int(a.min()) < 0 or int(a.max()) > 65535))
    ):
        return json.dumps(a.tolist())
    rows = _lut()[a.astype(np.intp, copy=False)]
    if a.ndim == 1:
        return "[" + ",".join(rows) + "]"
    if a.shape[0] == 0:
        return "[]"
    return "[[" + "],[".join(",".join(r) for r in rows) + "]]"
