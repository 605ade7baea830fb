"""Corpus token-count estimation by sampling + extrapolation.

Capability equivalent of ``pretraining-data/estimate_tokens.py`` (sample N
rows, tokenize, extrapolate via total row counts, :85-170),
``estimate_tokens_by_language.py`` (per-group estimates), and
``estimate_tokens_stratified.py`` (weights from a known row distribution).
The port's copy of the JAX package's module of the same path; host code, no
device work.

    python -m tokenize_audio_tpu_torch.analytics.estimate_tokens \
        --hub dir:/data/pretrain --tokenizer /data/tok [--sample-rows 200] \
        [--group-depth 0] [--output est.json]
"""

from __future__ import annotations

import argparse
import json
import logging
import random
from typing import Dict, List, Sequence

from tokenize_audio_tpu_torch.analytics.count_rows import RangeReader

logger = logging.getLogger(__name__)


class TokenEstimator:
    def __init__(self, tokenizer, text_field: str = "text"):
        """``tokenizer``: any callable-compatible HF tokenizer (or an object
        with .encode returning a list)."""
        self.tokenizer = tokenizer
        self.text_field = text_field

    def count_tokens(self, texts: Sequence[str]) -> int:
        total = 0
        for t in texts:
            if not isinstance(t, str):
                continue  # null parquet cells sample as None: 0 tokens
            enc = self.tokenizer.encode(t)
            total += len(enc if isinstance(enc, list) else enc.ids)
        return total

    def estimate_hub_dataset(
        self,
        hub,
        prefix: str = "",
        sample_rows: int = 200,
        seed: int = 0,
        group_depth: int = 0,
        rows_distribution: Dict[str, int] | None = None,
        resume: Dict[str, Dict] | None = None,
        on_group=None,
    ) -> Dict[str, Dict]:
        """Per group: sample rows across files, mean tokens/row x total rows
        (estimate_tokens.py extrapolation).

        Transfer-frugal: each file is opened over ranged reads — the footer
        gives total_rows, and samples come from ONE random row group's text
        column, so a multi-GB parquet costs only that column chunk instead
        of a full download (the scale fix the reference applies to counting
        in count_dataset_rows.py:66-88, extended here to sampling).

        ``rows_distribution`` (group -> row count, or count_rows JSON
        output) replaces footer counting with known totals — the stratified
        per-language mode (estimate_tokens_stratified.py:23-270, whose
        145-language table this framework GENERATES via
        ``analytics.count_rows --group-depth N`` instead of hard-coding).

        ``resume`` (a previous run's report) skips already-estimated
        groups — the per-language resume grain of the reference's 145
        fanned-out estimation jobs + check_token_estimation_progress.sh,
        done in-process; ``on_group(key, stats)`` fires after each group
        (the CLI uses it to checkpoint the output file)."""
        import pyarrow.parquet as pq

        files = [f for f in hub.list_files(prefix) if f.endswith(".parquet")]
        groups: Dict[str, List[str]] = {}
        for f in files:
            key = "/".join(f.split("/")[:group_depth]) if group_depth else "all"
            groups.setdefault(key, []).append(f)
        out: Dict[str, Dict] = {}
        known = None
        if rows_distribution is not None:
            known = {
                k: (v["rows"] if isinstance(v, dict) else int(v))
                for k, v in rows_distribution.items()
            }
        for key, gfiles in sorted(groups.items()):
            if resume is not None and key in resume:
                out[key] = resume[key]
                continue
            # per-GROUP rng: resuming past finished groups must not shift
            # later groups' draws, so a crash-resumed run samples exactly
            # like an uninterrupted run with the same seed
            rng = random.Random(f"{seed}/{key}")
            total_rows = 0
            sampled_texts: List[str] = []
            per_file = max(1, sample_rows // len(gfiles))
            for f in gfiles:
                pf = pq.ParquetFile(RangeReader(hub, f))
                total_rows += pf.metadata.num_rows
                if pf.metadata.num_row_groups == 0:
                    continue  # footer-only empty part-file (e.g. Spark)
                if self.text_field not in pf.schema_arrow.names:
                    logger.warning(
                        "%s has no %r column; counted but not sampled", f, self.text_field
                    )
                    continue
                g = rng.randrange(pf.metadata.num_row_groups)
                texts = pf.read_row_group(g, columns=[self.text_field])[
                    self.text_field
                ].to_pylist()
                take = texts if len(texts) <= per_file else rng.sample(texts, per_file)
                sampled_texts += take
            if known is not None and key in known:
                total_rows = known[key]
            tokens = self.count_tokens(sampled_texts)
            mean = tokens / len(sampled_texts) if sampled_texts else 0.0
            out[key] = {
                "files": len(gfiles),
                "total_rows": total_rows,
                "sampled_rows": len(sampled_texts),
                "mean_tokens_per_row": round(mean, 2),
                "estimated_total_tokens": int(mean * total_rows),
            }
            if on_group is not None:
                on_group(key, out[key])
        return out

    def stratified_estimate(
        self, samples_by_group: Dict[str, Sequence[str]], rows_by_group: Dict[str, int]
    ) -> Dict[str, Dict]:
        """Known row distribution -> per-group + total estimates
        (estimate_tokens_stratified.py semantics)."""
        out: Dict[str, Dict] = {}
        total = 0
        for g, texts in samples_by_group.items():
            mean = self.count_tokens(texts) / len(texts) if texts else 0.0
            est = int(mean * rows_by_group.get(g, 0))
            out[g] = {"mean_tokens_per_row": round(mean, 2), "estimated_total_tokens": est}
            total += est
        out["_total"] = {"estimated_total_tokens": total}
        return out


def main(argv=None):
    from tokenize_audio_tpu_torch.hub import open_hub

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--hub", required=True)
    ap.add_argument("--prefix", default="")
    ap.add_argument("--tokenizer", required=True, help="HF tokenizer name/path")
    ap.add_argument("--sample-rows", type=int, default=200)
    ap.add_argument("--group-depth", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--output",
        help="write the report JSON here, checkpointed after every group "
        "(atomic tmp+rename); an existing file resumes — finished groups "
        "are skipped, so a killed long estimation continues where it died",
    )
    ap.add_argument(
        "--rows-distribution",
        help="JSON file of group -> rows (accepts analytics.count_rows "
        "output) for stratified extrapolation with known totals",
    )
    args = ap.parse_args(argv)
    rows_dist = None
    if args.rows_distribution:
        with open(args.rows_distribution) as f:
            rows_dist = json.load(f)
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(args.tokenizer)
    est = TokenEstimator(tok)
    resume = None
    on_group = None
    if args.output:
        import os

        # the run's fingerprint: a resume file computed under different
        # settings would silently return stale estimates, so refuse it
        config = {
            "hub": args.hub,
            "prefix": args.prefix,
            "tokenizer": args.tokenizer,
            "sample_rows": args.sample_rows,
            "group_depth": args.group_depth,
            "seed": args.seed,
            "rows_distribution": bool(rows_dist),
        }
        if os.path.exists(args.output):
            with open(args.output) as f:
                prior = json.load(f)
            if prior.get("_config", config) != config:
                raise SystemExit(
                    f"{args.output} was produced with different settings "
                    f"({prior.get('_config')} != {config}); delete it or "
                    "pick another --output to avoid mixing stale estimates"
                )
            resume = {k: v for k, v in prior.items() if k != "_config"}
        state = dict(resume or {})
        state["_config"] = config

        def on_group(key, stats, _state=state, _path=args.output):
            _state[key] = stats
            tmp = f"{_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(_state, f, indent=1)
            os.replace(tmp, _path)

    report = est.estimate_hub_dataset(
        open_hub(args.hub),
        args.prefix,
        sample_rows=args.sample_rows,
        seed=args.seed,
        group_depth=args.group_depth,
        rows_distribution=rows_dist,
        resume=resume,
        on_group=on_group,
    )
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
