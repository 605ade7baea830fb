"""DAC (Descript Audio Codec) model configuration.

Shape defaults equal ``transformers.DacConfig`` defaults, which equal the
``descript/dac_44khz`` checkpoint's shapes (https://huggingface.co/descript/dac_44khz),
with the checkpoint's ``sampling_rate`` of 44.1 kHz in place of
``DacConfig``'s 16 kHz: a non-causal SEANet of Snake activations from 64
channels at strides 2, 4, 8, 8 (512 samples a frame, 86.13 frames a
second) to a 1024-wide latent, and 9 factorized codebooks of 1024 x 8
searched by cosine similarity.

``hidden_size``, ``hop_length`` and ``upsampling_ratios`` are keys of the
checkpoint's ``config.json`` that follow from the others; left None they
are derived, and given they must agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DacConfig:
    encoder_hidden_size: int = 64
    downsampling_ratios: Tuple[int, ...] = (2, 4, 8, 8)
    decoder_hidden_size: int = 1536
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    quantizer_dropout: float = 0.0
    commitment_loss_weight: float = 0.25
    codebook_loss_weight: float = 1.0
    sampling_rate: int = 44_100
    # None: derived (encoder_hidden_size * 2 ** stages, the product of the
    # strides, the strides reversed)
    hidden_size: Optional[int] = None
    hop_length: Optional[int] = None
    upsampling_ratios: Optional[Tuple[int, ...]] = None
    # Run modes, under the names ``MimiConfig`` gives them so that the
    # command line's flags map onto all three models. DAC runs IEEE float32
    # only ("float32", "highest"): the engine refuses the others at
    # construction (dac.model.check_modes).
    compute_dtype: str = "float32"
    matmul_precision: str = "highest"

    def __post_init__(self):
        ratios = tuple(self.downsampling_ratios)
        object.__setattr__(self, "downsampling_ratios", ratios)
        derived = {
            "hidden_size": self.encoder_hidden_size * 2 ** len(ratios),
            "hop_length": int(math.prod(ratios)),
            "upsampling_ratios": tuple(reversed(ratios)),
        }
        for key, want in derived.items():
            got = getattr(self, key)
            got = tuple(got) if isinstance(got, list) else got
            if got is None:
                object.__setattr__(self, key, want)
            elif got != want:
                raise ValueError(
                    f"DacConfig.{key} {got} disagrees with the strides and widths ({want})"
                )
            else:
                object.__setattr__(self, key, got)

    @property
    def samples_per_frame(self) -> int:
        """Input samples per code frame: the product of the strides (512)."""
        return self.hop_length
