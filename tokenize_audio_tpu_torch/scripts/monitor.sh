#!/usr/bin/env bash
# Live progress dashboard (reference: */monitor_progress.py --watch).
set -euo pipefail
DATA_DIR="${DATA_DIR:-/data/tokenize-audio}"
exec python -m tokenize_audio_tpu_torch.runner.monitor status \
    --progress-dir "$DATA_DIR/progress" \
    ${EXPECTED:+--expected "$EXPECTED"} \
    --watch "${1:-30}"
