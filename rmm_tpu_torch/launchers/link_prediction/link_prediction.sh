#!/usr/bin/env bash
# Link-prediction-only pretraining (reference
# slurm/link_prediction/link_prediction.sh): the LP leg of the fused
# objective, MRR/Hits metrics per epoch.
source "$(dirname "$0")/../common.sh"
run python -m rmm_tpu_torch.cli.fused \
  --dataset "${DATA:?set DATA=<aml csv>}" --mode lp \
  --num_neg_samples "${NEGS:-64}" --epochs "${EPOCHS:-50}" \
  --group link_prediction "$@"
