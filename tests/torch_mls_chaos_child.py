"""Child process of the port's MLS SIGKILL chaos test
(tests/test_torch_mls_chaos.py) and its crash windows
(tests/test_torch_crash_windows_mls.py): the port's two-stage MLS path
(stage-1 content-addressed entry JSONs with index progress, then the stage-2
merge into hub parquets, one speaker a batch) over the seeded rows of
tests/mls_chaos_child.py, draw for draw at the default size (2 speakers x 2
books x 10 utterances). Prints READY once the engine is built and
DONE <report> on completion; see tests/torch_chaos_kit.py for ``--params``,
``--device`` and ``--kill-at``. Run only via those tests. Imports nothing of
JAX or the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_chaos_kit import arm_kill, done, make_engine, parser  # noqa: E402


def build_rows(books: int, per_book: int):
    """2 speakers x ``books`` x ``per_book`` utterances, 16 kHz, consecutive
    times with a gap before utterance 5 (stage 2 then emits > 1 segment)."""
    import numpy as np

    rng = np.random.default_rng(7)
    rows = []
    for spk in ("spkA", "spkB"):
        for book in [f"bk{b}" for b in range(books)]:
            t = 0.0
            for i in range(per_book):
                dur = float(rng.uniform(0.3, 0.7))
                if i == 5:
                    t += 5.0  # continuity break -> new segment
                audio = (rng.standard_normal(int(16_000 * dur)) * 0.2).astype(
                    np.float32
                )
                rows.append(
                    {
                        "speaker_id": spk,
                        "book_id": book,
                        "transcript": f"{spk} {book} line {i}",
                        "begin_time": t,
                        "end_time": t + dur,
                        "original_path": f"orig/{spk}/{book}.flac",
                        "audio": {"array": audio, "sampling_rate": 16_000},
                    }
                )
                t += dur
    return rows


def main():
    ap = parser(__doc__)
    for name in ("out1", "prog", "hub", "work2"):
        ap.add_argument(name)
    ap.add_argument("--books", type=int, default=2, help="books per speaker")
    ap.add_argument("--per-book", type=int, default=10, help="utterances per book")
    args = ap.parse_args()
    from tokenize_audio_tpu_torch.datasets.mls import (
        MLSStage1Processor,
        create_batch_lists,
        merge_batch,
    )
    from tokenize_audio_tpu_torch.hub import LocalHub

    engine = make_engine(args)
    rows = build_rows(args.books, args.per_book)
    arm_kill(args.kill_at)
    print("READY", flush=True)
    stage1 = MLSStage1Processor(
        "sh0", engine, args.out1, args.prog, progress_save_interval=2
    ).run(rows)
    hub = LocalHub(args.hub)
    reports = [
        merge_batch(args.out1, b, f"batch_{i:03d}", hub, args.work2)
        for i, b in enumerate(create_batch_lists(args.out1, speakers_per_batch=1))
    ]
    done({"stage1": stage1, "stage2": reports}, engine)


if __name__ == "__main__":
    main()
