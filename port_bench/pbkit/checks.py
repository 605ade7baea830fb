"""The comparison that decides ``correct``.

The program's codes are judged by the plain reference
(``port_bench/reference``), which works the quantizer's input out again
from the same audio and weights, follows the program's codes through each
head's residual chain, and reads how far each code's squared distance lies
above the nearest codeword's, relative to the codebook's mean distance
(``mimi_ref.code_gaps``). A sound run reads rounding there; a code that
is wrong, or computed in a lower precision, reads far more.

Three numbers are compared, each with its limit from the cell's file:
``code_gap_max``, the widest gap over the sampled items; ``malformed``,
items whose codes have the wrong shape or a value outside the codebook;
``missing``, items that were due and never came (or came unasked).
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from pbkit import weights

COMPARED = ("code_gap_max", "malformed", "missing")


def sample(run, pool: Sequence, lengths: Sequence[int]) -> List:
    """``check.sample`` items of ``pool`` drawn from the seed, with the
    longest among them."""
    if not pool:
        return []
    rng = np.random.default_rng([int(run.seed) % (1 << 63), 3])
    n = min(run.params["check"]["sample"], len(pool))
    picked = [int(i) for i in rng.choice(len(pool), size=n, replace=False)]
    longest = int(np.argmax(lengths))
    if longest not in picked:
        picked[-1] = longest
    return [pool[i] for i in picked]


class Reference:
    """The plain reference on the run's configuration and weights, made
    again from the seed once the program's state is freed."""

    def __init__(self, run):
        from reference import mimi_ref

        self.mimi_ref = mimi_ref
        self.run = run
        self.cfg = run.cfg
        self.sd = weights.state_dict(run.cfg, run.seed, run.device)
        self.spf = 2 * math.prod(run.cfg["upsampling_ratios"])

    def well_formed(self, codes, n: int) -> bool:
        c = np.asarray(codes)
        return (
            c.shape == (self.run.books, -(-n // self.spf))
            and c.size > 0
            and int(c.min()) >= 0
            and int(c.max()) < self.cfg["codebook_size"]
        )

    def gap(self, audio: torch.Tensor, codes) -> float:
        """The widest gap of ``codes`` on 24 kHz float ``audio``."""
        emb = self.mimi_ref.embeddings(self.sd, self.cfg, audio)
        c = torch.from_numpy(np.asarray(codes, dtype=np.int64)).to(emb.device)
        return float(self.mimi_ref.code_gaps(self.sd, self.cfg, emb, c).max())

    def result(self, gaps: List[float], malformed: int, attempted: int, missing: int) -> dict:
        limits = self.run.params["limits"]
        values = {
            "code_gap_max": max(gaps) if gaps else None,
            "malformed": malformed,
            "missing": missing,
        }
        compared = {k: {"value": values[k], "limit": limits[k]} for k in COMPARED}
        correct = all(v["value"] is not None and v["value"] <= v["limit"] for v in compared.values())
        return {
            "correct": correct,
            "attempted": attempted,
            "failed": malformed + missing,
            "checks": compared,
            "sampled": len(gaps),
        }
