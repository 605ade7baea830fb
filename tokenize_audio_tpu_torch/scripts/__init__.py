"""The repository's qualification scripts, ported: each is run as
``python -m tokenize_audio_tpu_torch.scripts.<name>``, keeps the JAX
script's flags, defaults, printed lines and result keys (``scripts/<name>``),
runs on the card unless ``--device cpu`` is given, and imports nothing of
JAX or the JAX package.

bf16_qualification     : residual k-means codebooks trained on the model's own
                         pre-RVQ activations (the stand-in for a checkpoint),
                         then f32 vs bf16 code match
precision_probe        : "high" (TF32) and bf16 against parity on those
                         codebooks, with interleaved encode timings
split_boundary_census  : fused split-then-resample against
                         resample-whole-then-split at 16 and 48 kHz
resampler_sensitivity  : code match between two polyphase filter designs
seanet_backend_probe   : kernel vs plain SEANet backends, speed and codes
stream_policy_probe    : the split and stream long-audio policies, speed and
                         codes
parity_census          : multi-seed engine vs HF census with flip margins
parity_sweep           : engine vs HF over many utterances
pipeline_bench         : ``benchmark --pipeline``
probe_common           : the A/B probes' workload, warm check and
                         interleaved rounds
drain_policy_probe     : fifo vs ready drains
fetch_ahead_probe      : the YODAS2 processor at fetch_ahead 0 vs 1
fetch_dtype_probe      : int32 vs uint16 codes to the host, raw and end to end
fetch_pack_probe       : padded vs packed wire formats
growth_probe           : bucket-lattice growth factors
pipeline_depth_probe   : in-flight batches 12 vs 18 vs 24
samples_budget_probe   : 128 vs 192 vs 288 s of audio per batch
warmup_tails_receipt   : the provisioning warmup's batch shapes and wall
conv_layout_probe      : encode stages, and NCL vs channels-last SEANet convs
run_yodas2_pod.sh      : the YODAS2 shard launcher of a GPU host
monitor.sh             : the progress dashboard

``device_name`` and ``device_params`` are the scripts' shared helpers.
"""

import torch

from tokenize_audio_tpu_torch.mimi import MimiConfig, params_to_torch
from tokenize_audio_tpu_torch.mimi.weights import pack_kernel_weights


def device_name(dev: torch.device) -> str:
    """The card's name, or the device type off the card."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def device_params(params, cfg: MimiConfig, device: torch.device):
    """The param tree on ``device`` with the kernels' packed weights and
    codebooks (as the engine holds them), built from ``params`` as they are
    now: after ``bf16_qualification.train_codebooks`` the codebooks pack
    anew."""
    return pack_kernel_weights(params_to_torch(params, device), cfg)
