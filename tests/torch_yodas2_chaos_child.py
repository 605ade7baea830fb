"""Child process of the port's YODAS2 SIGKILL chaos test
(tests/test_torch_yodas2_chaos.py) and its crash windows
(tests/test_torch_crash_windows_yodas2.py): the port's shard processor end to
end against a local mirror, as tests/yodas2_chaos_child.py runs the JAX
package's (tiny config, 12 books, upload batch 1, save every entry). Prints
READY once the engine is built and DONE <report> on completion; see
tests/torch_chaos_kit.py for ``--params``, ``--device`` and ``--kill-at``.
Run only via those tests. Imports nothing of JAX or the JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_chaos_kit import arm_kill, done, make_engine, parser  # noqa: E402


def main():
    ap = parser(__doc__)
    for name in ("mirror", "work", "prog", "hub"):
        ap.add_argument(name)
    ap.add_argument("shard", nargs="?", default="en000")
    args = ap.parse_args()
    from tokenize_audio_tpu_torch.datasets.yodas2 import LocalSource, Yodas2ShardProcessor
    from tokenize_audio_tpu_torch.hub import LocalHub

    engine = make_engine(args, num_codebooks=12)
    proc = Yodas2ShardProcessor(
        args.shard,
        LocalSource(args.mirror),
        LocalHub(args.hub),
        engine,
        args.work,
        args.prog,
        max_subshards=20,
        max_consecutive_missing=5,
        upload_batch_size=1,  # upload eagerly: more crash windows straddle it
        save_every=1,
    )
    arm_kill(args.kill_at)
    print("READY", flush=True)
    done(proc.process(), engine)


if __name__ == "__main__":
    main()
