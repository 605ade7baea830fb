"""Child process of the port's Emilia SIGKILL chaos test
(tests/test_torch_emilia_chaos.py) and its crash windows
(tests/test_torch_crash_windows_emilia.py): the port's
EmiliaShardProcessor end to end against a parent-built source hub, standard
or (``conversational``) conversational, as tests/emilia_chaos_child.py runs
the JAX package's. Prints READY once the engine is built and DONE <report>
on completion; see tests/torch_chaos_kit.py for ``--params``, ``--device``
and ``--kill-at``. Run only via those tests. Imports nothing of JAX or the
JAX package."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from torch_chaos_kit import arm_kill, done, make_engine, parser  # noqa: E402


def main():
    ap = parser(__doc__)
    for name in ("src", "dst", "work"):
        ap.add_argument(name)
    ap.add_argument("mode", nargs="?", default="standard",
                    choices=["standard", "conversational"])
    args = ap.parse_args()
    from tokenize_audio_tpu_torch.datasets.emilia import EmiliaShardProcessor
    from tokenize_audio_tpu_torch.hub import LocalHub

    engine = make_engine(args)
    proc = EmiliaShardProcessor(
        "Emilia",
        "EN",
        "EN_B00000",
        LocalHub(args.src),
        LocalHub(args.dst),
        engine,
        args.work,
        conversational=args.mode == "conversational",
    )
    arm_kill(args.kill_at)
    print("READY", flush=True)
    done(proc.process(), engine)


if __name__ == "__main__":
    main()
