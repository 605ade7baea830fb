"""How the benchmark builds the program under test: the Mimi configuration
from a configuration file, the engine from the benchmark's seeded weights
through the program's own checkpoint converter.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from pbkit import weights


def mimi_config(cfg: Dict, mode: Dict):
    """The program's ``MimiConfig`` for a configuration file: its shape
    keys, and the run modes (precision, dtype, backends, window) from
    ``mode``."""
    from tokenize_audio_tpu_torch.mimi.config import MimiConfig

    keys = {f.name for f in dataclasses.fields(MimiConfig)}
    kw = {k: v for k, v in cfg.items() if k in keys}
    kw.update({k: v for k, v in mode.items() if k in keys})
    kw["upsampling_ratios"] = tuple(kw["upsampling_ratios"])
    return MimiConfig(**kw)


def build_engine(run, engine_kw: Dict):
    """A ``MimiEncoderEngine`` of the run's configuration and modes, its
    weights from the run's seed."""
    from tokenize_audio_tpu_torch.config import EngineConfig
    from tokenize_audio_tpu_torch.engine import MimiEncoderEngine
    from tokenize_audio_tpu_torch.mimi.weights import convert_hf_state_dict

    mcfg = mimi_config(run.cfg, run.mode)
    params = convert_hf_state_dict(weights.state_dict(run.cfg, run.seed, run.device), mcfg)
    return MimiEncoderEngine(
        params, mcfg, EngineConfig(**engine_kw), num_codebooks=run.books, device=run.device,
    )
