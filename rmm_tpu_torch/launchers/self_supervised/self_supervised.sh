#!/usr/bin/env bash
# Joint self-supervised pretraining, config of record
# (reference slurm/self_supervised/self_supervised.sh → self_supervised.py:
# 30 epochs, group "self_supervised"). Saves per-epoch + best-metric
# checkpoints for the two-stage SSL→supervised workflow.
source "$(dirname "$0")/../common.sh"
run python -m rmm_tpu_torch.cli.fused \
  --dataset "${DATA:?set DATA=<aml csv>}" --mode "${MODE:-mcm-lp}" \
  --epochs "${EPOCHS:-30}" --group self_supervised --save_model "$@"
