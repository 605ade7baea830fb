"""EnCodec model configuration.

Shape defaults equal ``transformers.EncodecConfig`` defaults, which equal
the ``facebook/encodec_24khz`` checkpoint configuration
(https://huggingface.co/facebook/encodec_24khz, ``config.json``): the
SEANet encoder at strides 2, 4, 5, 8 (320 samples a frame, 75 frames a
second), a 2-layer LSTM of width 512, and 32 Euclidean codebooks of
1024 x 128, of which a bandwidth keeps the first few.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EncodecConfig:
    target_bandwidths: Tuple[float, ...] = (1.5, 3.0, 6.0, 12.0, 24.0)
    sampling_rate: int = 24_000
    audio_channels: int = 1
    normalize: bool = False
    chunk_length_s: Optional[float] = None
    overlap: Optional[float] = None
    hidden_size: int = 128
    num_filters: int = 32
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 5, 4, 2)
    norm_type: str = "weight_norm"
    kernel_size: int = 7
    last_kernel_size: int = 7
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "reflect"
    compress: int = 2
    num_lstm_layers: int = 2
    trim_right_ratio: float = 1.0
    codebook_size: int = 1024
    # None: ``hidden_size``, as transformers resolves it
    codebook_dim: Optional[int] = None
    use_conv_shortcut: bool = True
    # Run modes, under the names ``MimiConfig`` gives them so that the
    # command line's flags map onto both. EnCodec runs IEEE float32 only
    # ("float32", "highest"): the engine refuses the others at
    # construction (encodec.model.check_modes).
    compute_dtype: str = "float32"
    matmul_precision: str = "highest"

    def __post_init__(self):
        if self.codebook_dim is None:
            object.__setattr__(self, "codebook_dim", self.hidden_size)
        object.__setattr__(self, "upsampling_ratios", tuple(self.upsampling_ratios))
        object.__setattr__(self, "target_bandwidths", tuple(self.target_bandwidths))

    @property
    def hop_length(self) -> int:
        return int(math.prod(self.upsampling_ratios))

    @property
    def samples_per_frame(self) -> int:
        """Input samples per code frame: the product of the strides (320)."""
        return self.hop_length

    @property
    def frame_rate(self) -> int:
        return math.ceil(self.sampling_rate / self.hop_length)

    @property
    def encoder_strides(self) -> Tuple[int, ...]:
        """SEANet encoder strides in order (reversed ratios): (2, 4, 5, 8)."""
        return tuple(reversed(self.upsampling_ratios))

    @property
    def lstm_size(self) -> int:
        """Channels after the last stage, the LSTM's width (512)."""
        return self.num_filters * 2 ** len(self.upsampling_ratios)

    @property
    def codebook_nbits(self) -> int:
        return math.ceil(math.log2(self.codebook_size))

    @property
    def num_quantizers(self) -> int:
        """Codebooks of the checkpoint: those of the largest bandwidth (32)."""
        return int(1000 * self.target_bandwidths[-1] // (self.frame_rate * self.codebook_nbits))

    def books_for_bandwidth(self, kbps: float) -> int:
        """Codebooks at ``kbps``, as transformers'
        ``EncodecResidualVectorQuantizer.get_num_quantizers_for_bandwidth``
        counts them: 6 kbps -> 8 at 75 frames a second of 10 bits."""
        if kbps not in self.target_bandwidths:
            raise ValueError(f"bandwidth {kbps} kbps not in {self.target_bandwidths}")
        per_book = math.log2(self.codebook_size) * self.frame_rate
        return int(max(1, math.floor(kbps * 1000 / per_book)))
