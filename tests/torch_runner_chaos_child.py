"""Child process of the port's ShardRunner-family SIGKILL chaos test
(tests/test_torch_runner_chaos.py) and its crash window
(tests/test_torch_crash_windows_runner.py): the port's two
ShardRunner/ShardProgress families back to back over the seeded workloads of
tests/runner_chaos_child.py, draw for draw at the default size,

  1. the LibriSpeech train layout: chunked parquet via ShardRunner, upload
     batches of 2 (chunk resume, the pending flush and the
     upload-then-mark adoption window);
  2. parquet_corpus (LibriTTS-R spec): shard-grain skip-if-on-hub with
     upload verification (``--corpus-shards 0`` leaves it out).

Fixtures are regenerated at the top of every run, so a kill inside them
heals on the rerun. Prints READY once the engine is built and DONE <report>
on completion; see tests/torch_chaos_kit.py for ``--params``, ``--device``
and ``--kill-at``. Run only via those tests. Imports nothing of JAX or the
JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_chaos_kit import arm_kill, done, make_engine, parser  # noqa: E402


def main():
    ap = parser(__doc__)
    ap.add_argument("base")
    ap.add_argument("--utterances", type=int, default=12, help="LibriSpeech utterances")
    ap.add_argument("--corpus-shards", type=int, default=3)
    args = ap.parse_args()
    base = args.base
    import numpy as np

    from tokenize_audio_tpu_torch.datasets.librispeech import process_split
    from tokenize_audio_tpu_torch.datasets.parquet_corpus import SPECS, process_shard
    from tokenize_audio_tpu_torch.datasets.parquet_utils import write_parquet
    from tokenize_audio_tpu_torch.hub import LocalHub
    from tokenize_audio_tpu_torch.io import write_wav

    # --- deterministic fixtures, regenerated every run -------------------
    wav_dir = os.path.join(base, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    rng = np.random.default_rng(11)
    manifest = []
    for i in range(args.utterances):
        audio = (rng.standard_normal(int(24_000 * (0.3 + 0.04 * i))) * 0.3).astype(
            np.float32
        )
        p = os.path.join(wav_dir, f"utt{i}.wav")
        write_wav(p, audio, 24_000)
        manifest.append({"id": f"tr-{i}", "audio": p, "text": f"line {i}"})

    src_dir = os.path.join(base, "pc_src")
    rng2 = np.random.default_rng(13)
    for s in range(args.corpus_shards):
        rows = []
        for i in range(6):
            audio = (rng2.standard_normal(int(24_000 * 0.4)) * 0.3).astype(np.float32)
            rows.append(
                {
                    "id": f"s{s}u{i}",
                    "text_normalized": f"shard {s} utt {i}",
                    "speaker_id": 100 + i // 3,
                    "chapter_id": s,
                    "audio": {"array": audio, "sampling_rate": 24_000},
                }
            )
        tmp = os.path.join(base, f".shard{s}.tmp")
        write_parquet(rows, tmp)
        dest = os.path.join(src_dir, "data", f"shard{s}.parquet")
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        os.replace(tmp, dest)

    engine = make_engine(args)
    arm_kill(args.kill_at)
    print("READY", flush=True)

    ls_report = process_split(
        manifest,
        "train-clean",
        engine,
        LocalHub(os.path.join(base, "ls_hub")),
        os.path.join(base, "ls_prog"),
        os.path.join(base, "ls_work"),
        chunk_rows=4,  # 2 utterances per chunk
        upload_batch_size=2,
    )
    pc_reports = []
    if args.corpus_shards:
        src = LocalHub(src_dir)
        dst = LocalHub(os.path.join(base, "pc_hub"))
        pc_reports = [
            process_shard(
                SPECS["libritts_r"],
                f"shard{s}",
                "",
                src,
                dst,
                engine,
                os.path.join(base, "pc_work"),
                os.path.join(base, "pc_prog"),
            )
            for s in range(args.corpus_shards)
        ]
    done({"librispeech": ls_report.__dict__, "corpus": pc_reports}, engine)


if __name__ == "__main__":
    main()
