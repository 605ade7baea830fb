"""Within-process A/B probe: engine samples_per_batch (the per-dispatch
audio budget) on the card.

The shipped 192x24k (~3.2 min of audio per call) was picked on the TPU;
fewer, larger dispatches amortize more per-call overhead, smaller ones
overlap more, so the ranking deserves a probe on every machine.
Interleaved rounds within one process, as all probes. The budget changes
batch rows only, and the warm passes must give the same codes (they do on
the H100: cuDNN's convs sum each row alike at these row counts).

Usage: python -m tokenize_audio_tpu_torch.scripts.samples_budget_probe
           [rounds] [--device cpu]
"""

from __future__ import annotations

import argparse

from tokenize_audio_tpu_torch.config import EngineConfig, resolve_device
from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
from tokenize_audio_tpu_torch.mimi import MimiConfig, random_params
from tokenize_audio_tpu_torch.scripts import device_name, probe_common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rounds", nargs="?", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = MimiConfig()
    params = random_params(cfg, seed=0)
    audios, total_s = probe_common.bench_audios(256)

    variants = {}
    for mult in (128, 192, 288):
        ecfg = EngineConfig(
            min_bucket_seconds=2.0,
            bucket_growth=1.25,
            samples_per_batch=mult * 24_000,
            max_batch_size=128,
        )
        variants[f"b{mult}"] = MimiEncoderEngine(
            params, cfg, ecfg, pipeline_depth=18, device=dev
        )
    report = probe_common.permuted_rounds(variants, audios, total_s, args.rounds,
                                          device_name(dev))
    assert probe_common.codes_equal(report["codes"]), "the budgets' codes differ"
    return report


if __name__ == "__main__":
    main()
