"""Child process of the port's parquet-corpus SIGKILL chaos test
(tests/test_torch_corpus_chaos.py) and its crash windows
(tests/test_torch_crash_windows_corpus.py): the port's generic corpus
template (Common Voice spec, 48 kHz embedded audio) over seeded source shards,
as tests/corpus_chaos_child.py runs the JAX package's, draw for draw at the
default size (3 shards x 4 rows). Prints READY once the engine is built and
DONE <report> on completion; see tests/torch_chaos_kit.py for ``--params``,
``--device`` and ``--kill-at``. Run only via those tests. Imports nothing of
JAX or the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_chaos_kit import arm_kill, done, make_engine, parser  # noqa: E402


def build_source(src, shards, rows_per):
    """Seeded Common Voice-style source; idempotent across reruns."""
    import numpy as np

    from tokenize_audio_tpu_torch.datasets.parquet_utils import write_parquet

    rng = np.random.default_rng(11)
    for shard in shards:
        rows = []
        for i in range(rows_per):
            dur = float(rng.uniform(0.3, 0.6))
            audio = (rng.standard_normal(int(48_000 * dur)) * 0.2).astype(np.float32)
            rows.append(
                {
                    "id": f"{shard}_cv{i}",
                    "sentence": f"{shard} phrase {i}",
                    "client_id": f"spk{i % 2}",
                    "audio": {"array": audio, "sampling_rate": 48_000},
                }
            )
        path = os.path.join(src.root, "tmp_build.parquet")
        write_parquet(rows, path)
        src.upload_file(path, f"en/{shard}.parquet")
        os.unlink(path)


def main():
    ap = parser(__doc__)
    for name in ("src", "dst", "work", "prog"):
        ap.add_argument(name)
    ap.add_argument("--shards", type=int, default=3)
    ap.add_argument("--rows", type=int, default=4, help="rows per shard")
    args = ap.parse_args()
    from tokenize_audio_tpu_torch.datasets.parquet_corpus import SPECS, process_shard
    from tokenize_audio_tpu_torch.hub import LocalHub

    engine = make_engine(args)
    shards = [f"shard{s}" for s in range(args.shards)]
    src = LocalHub(args.src)
    build_source(src, shards, args.rows)
    dst = LocalHub(args.dst)
    arm_kill(args.kill_at)
    print("READY", flush=True)
    reports = [
        process_shard(SPECS["common_voice"], s, "en", src, dst, engine, args.work, args.prog)
        for s in shards
    ]
    done(reports, engine)


if __name__ == "__main__":
    main()
