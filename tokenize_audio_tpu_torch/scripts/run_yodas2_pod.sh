#!/usr/bin/env bash
# Launch YODAS2 shard encoding across the GPUs of a host (PyTorch/CUDA port).
#
# Replaces the reference's Slurm job templates (yodas2-mimi/submit/
# job_template.sh, submit_all_shards_limited.sh): one shard per worker, the
# pod runner throttles concurrency, progress files + the hub keep
# everything restart-anywhere idempotent. Run this on each GPU host (or via
# your cluster launcher); state lives entirely under $DATA_DIR and the hub.
#
# Multi-GPU hosts: the pod runner counts the GPUs (the /dev/nvidia<N>
# nodes, narrowed by CUDA_VISIBLE_DEVICES where that is set), gives every
# concurrent shard job an EXCLUSIVE GPU through CUDA_VISIBLE_DEVICES — the
# one-GPU-per-job isolation of the reference's `#SBATCH --gres=gpu:1` —
# and caps max_concurrent at the GPU count. So on an 8-GPU host pass
# max_concurrent=8; override the count with TOKENIZE_AUDIO_TPU_DEVICES=N or
# `--chips N`, customize the env template with `--chip-env VAR={chip}`.
set -euo pipefail

DATA_DIR="${DATA_DIR:-/data/tokenize-audio}"
SHARD_LIST="${1:?usage: run_yodas2_pod.sh <shard_list.txt> [max_concurrent]}"
MAX_CONCURRENT="${2:-1}"
PARAMS="${PARAMS:-$DATA_DIR/mimi/model.safetensors}"
SOURCE_HUB="${SOURCE_HUB:-hf:espnet/yodas2}"
TARGET_HUB="${TARGET_HUB:?set TARGET_HUB, e.g. hf:me/yodas2-mimi-codes}"

exec python -m tokenize_audio_tpu_torch.runner.pod_runner run \
    --shard-list "$SHARD_LIST" \
    --max-concurrent "$MAX_CONCURRENT" \
    --run-dir "$DATA_DIR/pod" \
    --log-dir "$DATA_DIR/logs" \
    --progress-dir "$DATA_DIR/progress" \
    --wait \
    -- python -m tokenize_audio_tpu_torch.datasets.yodas2 \
        --shard-id '{shard}' \
        --source "$SOURCE_HUB" \
        --hub "$TARGET_HUB" \
        --work-dir "$DATA_DIR/work" \
        --progress-dir "$DATA_DIR/progress" \
        --params "$PARAMS" \
        --samples-per-batch $((192 * 24000)) \
        --upload-batch-size 10
