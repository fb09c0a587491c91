#!/usr/bin/env bash
# Shared launcher environment of the PyTorch port (the JAX package's
# launchers/common.sh for its TPU hosts): one process on one CUDA card, the
# kernels built from the checkout at first use; accounting via the metrics
# JSONL each run writes. Every launcher passes its extra arguments on, so
# "--device cpu" runs it on the CPU (the kernels' plain versions).
set -euo pipefail
export REPO="${REPO:-$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)}"
export PYTHONPATH="$REPO:${PYTHONPATH:-}"
run() { echo "+ $*"; "$@"; }
