#!/usr/bin/env bash
# Joint MCM+LP pretraining of TABGNNFused (reference slurm/fused/*.sh)
source "$(dirname "$0")/../common.sh"
# The JAX launcher adds --scan_layers (a smaller program for its AOT
# compile) and DP=N's --dp (data parallelism over N chips); the port runs
# its layers eagerly on one card and refuses both flags by name, so they
# are left out.
run python -m rmm_tpu_torch.cli.fused \
  --dataset "${DATA:?set DATA=<aml csv>}" --mode "${MODE:-mcm-lp}" \
  --batch_size 200 --lr 2e-4 --channels 128 --num_layers 3 \
  --dropout 0.5 --num_neg_samples 64 --epochs "${EPOCHS:-50}" "$@"
