#!/usr/bin/env bash
# Profiling harness run (reference slurm/benchmark): per-phase timers and a
# torch.profiler Chrome trace under TRACE_DIR
source "$(dirname "$0")/../common.sh"
run python -m rmm_tpu_torch.cli.benchmark \
  --data "${DATA:?set DATA=<csv>}" --model "${MODEL:-tabgnn}" \
  --iters "${ITERS:-100}" --profile \
  --trace_dir "${TRACE_DIR:-${TMPDIR:-/tmp}/rmm_torch_trace}" "$@"
