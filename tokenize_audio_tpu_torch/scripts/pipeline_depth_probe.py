"""Within-process A/B probe: engine pipeline_depth (in-flight device
batches) on the card.

Cross-run walls swing, so configurations are compared ONLY inside one
process, interleaved round-robin (config order re-randomized per round)
with medians reported. Depth changes transport only: the warm passes
must give the same codes.

Usage: python -m tokenize_audio_tpu_torch.scripts.pipeline_depth_probe
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

    # packed transfer, tail ladder, growth 1.25: does a deeper in-flight
    # window pay?
    variants = {}
    for depth in (12, 18, 24):
        ecfg = EngineConfig(
            min_bucket_seconds=2.0,
            bucket_growth=1.25,
            samples_per_batch=192 * 24_000,
            max_batch_size=128,
        )
        variants[f"d{depth}"] = MimiEncoderEngine(
            params, cfg, ecfg, pipeline_depth=depth, device=dev
        )
    report = probe_common.permuted_rounds(variants, audios, total_s, args.rounds,
                                          device_name(dev))
    assert probe_common.codes_equal(report["codes"]), "the depths' codes differ"
    return report


if __name__ == "__main__":
    main()
