"""Mimi model configuration.

Field defaults equal ``transformers.MimiConfig`` defaults, which equal the
``kyutai/mimi`` checkpoint configuration (the model the reference invokes at
yodas2-mimi/process_shard.py:188-195 and nine copy-paste sites).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    sampling_rate: int = 24_000
    audio_channels: int = 1
    hidden_size: int = 512
    num_filters: int = 64
    num_residual_layers: int = 1
    upsampling_ratios: Tuple[int, ...] = (8, 6, 5, 4)
    kernel_size: int = 7
    last_kernel_size: int = 3
    residual_kernel_size: int = 3
    dilation_growth_rate: int = 2
    use_causal_conv: bool = True
    pad_mode: str = "constant"
    compress: int = 2
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    vector_quantization_hidden_dimension: int = 256
    upsample_groups: int = 512
    # transformer bottleneck
    num_hidden_layers: int = 8
    intermediate_size: int = 2048
    num_attention_heads: int = 8
    num_key_value_heads: int = 8
    head_dim: int = 64
    hidden_act: str = "gelu"
    max_position_embeddings: int = 8000
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    sliding_window: int = 250
    layer_scale_initial_scale: float = 0.01
    # NOTE on sliding_window: the parity target — one-shot MimiModel.encode,
    # the only way the reference calls it (yodas2-mimi/process_shard.py:
    # 215-218) — applies NO sliding window on transformers 4.57:
    # MimiTransformerModel masks via create_causal_mask (plain causal), the
    # eager attention ignores self.sliding_window, and MimiModel.encode is
    # one _encode_frame over the whole input. use_sliding_window=True opts
    # into the original kyutai semantics, which transformers 5.x's encode
    # applies (create_sliding_window_causal_mask); the qualification kit
    # reports the installed version's mode and its flips past the window.
    use_sliding_window: bool = False
    # RVQ backend: "kernel" (the hand-written CUDA kernel,
    # ops/cuda/rvq.py — its plain PyTorch version on a CPU tensor) or
    # "torch" (per-book matmul/argmin/gather in PyTorch ops).
    rvq_backend: str = "kernel"
    # SEANet stage backend: "kernel" (fused resblock + ELU CUDA kernel,
    # ops/cuda/seanet.py, then the strided down-conv in PyTorch) or "torch"
    # (causal_conv1d chain). The kernel's summation order differs from the
    # cuDNN conv, so its code agreement is measured, not bit-guaranteed.
    # Applies only to the standard geometry (num_residual_layers=1).
    seanet_backend: str = "kernel"
    # "float32" (default): bit-exact codes vs HF MimiModel.encode fp32 on
    # the CPU. "bfloat16": SEANet + transformer + downsample compute in
    # bf16 (LayerNorm/softmax/RoPE/RVQ stay f32, and so does the streaming
    # encoder); codes are NOT bit-identical to float32's, and the fused
    # resblock kernel (float32 only) gives way to the plain convs. Not a
    # parity mode: its code match against parity is measured, not promised.
    compute_dtype: str = "float32"
    # float32 precision of the SEANet convs, transformer matmuls and the
    # 25->12.5 Hz downsample (mimi.model.matmul_precision):
    #   "highest" — IEEE fp32 (TF32 off). The ONLY parity mode.
    #   "high", "default" — TF32 on the card (cuDNN/cuBLAS), what XLA gives
    #               Precision.HIGH/DEFAULT on f32 on an NVIDIA GPU; not
    #               parity. On the CPU both equal "highest".
    # The resample, the quantizer in_proj and the RVQ always stay IEEE:
    # they are argmin-adjacent.
    # MEASURED against "highest" on an NVIDIA H100 80GB HBM3 (700.00 W) on
    # k-means-realistic codebooks (this package's scripts.precision_probe:
    # residual k-means on the model's own pre-RVQ activations; 3000
    # frames, 8 books): "high" (TF32) 50.6 % of codes, 42.5 % of frames; bf16 27.4 %
    # of codes, 3.9 % of frames. Random codebooks overstate both (98.7 %
    # and 74.2 % of codes), so neither mode is near parity.
    matmul_precision: str = "highest"

    @property
    def frame_rate(self) -> float:
        # MimiConfig.frame_rate: ceil over encodec hop, 12.5 Hz for defaults
        hop_length = int(math.prod(self.upsampling_ratios))
        return self.sampling_rate / (hop_length * 2)

    @property
    def encoder_strides(self) -> Tuple[int, ...]:
        """SEANet encoder downsample strides in order (reversed ratios):
        (4, 5, 6, 8) for defaults. transformers modeling_mimi.py:456."""
        return tuple(reversed(self.upsampling_ratios))

    @property
    def samples_per_frame(self) -> int:
        return int(math.prod(self.upsampling_ratios)) * 2  # x2: 25->12.5 Hz

    @property
    def num_acoustic_quantizers(self) -> int:
        return self.num_quantizers - self.num_semantic_quantizers
