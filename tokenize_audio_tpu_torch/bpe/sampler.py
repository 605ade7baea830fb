"""Seeded corpus sampler: code JSONs -> per-sub-shard .npy training files.

Capability equivalent of ``codec-bpe/sample_yodas2_codes_from_hf.py``:
seeded sampling of <=N sub-shards per shard (:90-131), pull each code JSON
from the hub, write an object-dtype .npy holding the list of
``(num_codebooks, T)`` uint16 arrays (:205-263), append-only progress file
so interrupted sampling resumes (:266-302). The port's copy of the JAX
package's module of the same path; host code, no device work.

    python -m tokenize_audio_tpu_torch.bpe.sampler --hub dir:/data/hub \
        --out-dir /data/npys [--per-shard 5] [--seed 42] [--num-codebooks 8]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
from typing import Dict, List, Sequence

import numpy as np

from tokenize_audio_tpu_torch.hub import open_hub

logger = logging.getLogger(__name__)


def pick_subshards(
    shard_subshards: Dict[str, List[str]], per_shard: int, seed: int
) -> List[tuple]:
    """Deterministic <=per_shard sample per shard."""
    rng = random.Random(seed)
    picks = []
    for shard in sorted(shard_subshards):
        subs = sorted(shard_subshards[shard])
        chosen = subs if len(subs) <= per_shard else sorted(rng.sample(subs, per_shard))
        picks += [(shard, s) for s in chosen]
    return picks


def codes_from_entries(entries: Sequence[Dict], num_codebooks: int = 8) -> List[np.ndarray]:
    """Extract every chunk's codes (first num_codebooks books) as uint16."""
    out = []
    for e in entries:
        for codes in (e.get("codes") or {}).values():
            arr = np.asarray(codes, dtype=np.uint16)[:num_codebooks]
            if arr.size:
                out.append(arr)
    return out


class CodeSampler:
    def __init__(
        self,
        hub,
        out_dir: str,
        num_codebooks: int = 8,
        source_prefix: str = "data/",
    ):
        self.hub = hub
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.num_codebooks = num_codebooks
        self.source_prefix = source_prefix
        self.progress_path = os.path.join(out_dir, "sampling_progress.txt")

    def _done(self) -> set:
        try:
            with open(self.progress_path) as f:
                return {line.strip() for line in f if line.strip()}
        except FileNotFoundError:
            return set()

    def _mark(self, key: str) -> None:
        with open(self.progress_path, "a") as f:
            f.write(key + "\n")
            f.flush()
            os.fsync(f.fileno())

    def sample(self, picks: Sequence[tuple]) -> Dict:
        done = self._done()
        processed = skipped = failed = 0
        for shard, sub in picks:
            key = f"{shard}/{sub}"
            if key in done:
                skipped += 1
                continue
            try:
                local = os.path.join(self.out_dir, f"_dl_{shard}_{sub}.json")
                self.hub.download(f"{self.source_prefix}{shard}/{sub}.json", local)
                with open(local) as f:
                    entries = json.load(f)
                os.unlink(local)
                arrays = codes_from_entries(entries, self.num_codebooks)
                out_path = os.path.join(self.out_dir, f"{shard}_{sub}.npy")
                # explicit 1-D object array: np.array(list, dtype=object) would
                # build an (N, K, T) object ndarray for same-shape utterances
                obj = np.empty(len(arrays), dtype=object)
                obj[:] = arrays
                np.save(out_path, obj, allow_pickle=True)
                self._mark(key)
                processed += 1
            except Exception:  # noqa: BLE001 — per-subshard isolation
                logger.exception("sampling %s failed", key)
                failed += 1
        return {"processed": processed, "skipped": skipped, "failed": failed}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--per-shard", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--num-codebooks", type=int, default=8)
    ap.add_argument("--source-prefix", default="data/")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    hub = open_hub(args.hub)
    # enumerate shard/subshard structure from the hub listing
    shard_subshards: Dict[str, List[str]] = {}
    plen = len(args.source_prefix)
    for f in hub.list_files(args.source_prefix):
        if not f.endswith(".json"):
            continue
        rel = f[plen:]
        if "/" not in rel:
            continue
        shard, name = rel.split("/", 1)
        shard_subshards.setdefault(shard, []).append(name[: -len(".json")])
    picks = pick_subshards(shard_subshards, args.per_shard, args.seed)
    sampler = CodeSampler(hub, args.out_dir, args.num_codebooks, args.source_prefix)
    print(json.dumps(sampler.sample(picks)))


if __name__ == "__main__":
    main()
