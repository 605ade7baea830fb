"""Shard manifest generation.

Capability equivalent of the reference's static work-lists and their
generators (SURVEY §2.1 #25: shard_ids.txt, subshard_counts.json,
file_lists/*.txt, emilia-mimi/generate_file_list.py,
mls-en-mimi-pretrain/make_file_list.py): enumerate a hub's source layout
into shard lists and expected-unit counts consumed by the pod runner and
the monitor.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional


def shard_list_from_hub(
    hub, prefix: str = "", pattern: str = r"([^/]+)/", suffix: Optional[str] = None
) -> List[str]:
    """Distinct shard ids: first regex group of each path under prefix."""
    rx = re.compile(pattern)
    shards = set()
    for f in hub.list_files(prefix):
        if suffix and not f.endswith(suffix):
            continue
        m = rx.match(f[len(prefix) :])
        if m:
            shards.add(m.group(1))
    return sorted(shards)


def unit_counts_from_hub(
    hub, prefix: str = "", suffix: str = ".json"
) -> Dict[str, int]:
    """{shard: number of unit files} — the subshard_counts.json equivalent
    (yodas2-mimi/get_total_subshards.py)."""
    counts: Dict[str, int] = defaultdict(int)
    for f in hub.list_files(prefix):
        if not f.endswith(suffix):
            continue
        rel = f[len(prefix) :]
        if "/" in rel:
            counts[rel.split("/", 1)[0]] += 1
    return dict(counts)


def write_shard_list(shards: List[str], path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(shards) + ("\n" if shards else ""))


def main(argv=None):
    from tokenize_audio_tpu_torch.hub import open_hub

    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ls = sub.add_parser("shards")
    ls.add_argument("--hub", required=True)
    ls.add_argument("--prefix", default="")
    ls.add_argument("--suffix", default=None)
    ls.add_argument("--out", default=None)
    ct = sub.add_parser("counts")
    ct.add_argument("--hub", required=True)
    ct.add_argument("--prefix", default="")
    ct.add_argument("--suffix", default=".json")
    ct.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    hub = open_hub(args.hub)
    if args.cmd == "shards":
        shards = shard_list_from_hub(hub, args.prefix, suffix=args.suffix)
        if args.out:
            write_shard_list(shards, args.out)
        print("\n".join(shards))
    else:
        counts = unit_counts_from_hub(hub, args.prefix, args.suffix)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(counts, f, indent=1)
        print(json.dumps(counts, indent=1))


if __name__ == "__main__":
    main()
