#!/usr/bin/env bash
# Masking-objective comparison (reference slurm/mask_analysis/
# mask_analysis.sh): the tabular SSL trainer twice on the same data and
# seed, plain MCM, then MCM with the VIME mask-vector head.
source "$(dirname "$0")/../common.sh"
run python -m rmm_tpu_torch.cli.fttransformer \
  --dataset "${DATA:?set DATA=<aml csv>}" --epochs "${EPOCHS:-20}" "$@"
run python -m rmm_tpu_torch.cli.fttransformer \
  --dataset "$DATA" --epochs "${EPOCHS:-20}" --mask_vector "$@"
