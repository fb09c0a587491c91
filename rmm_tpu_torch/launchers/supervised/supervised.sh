#!/usr/bin/env bash
# Supervised AML edge classification (reference slurm/supervised/supervised.sh)
source "$(dirname "$0")/../common.sh"
run python -m rmm_tpu_torch.cli.main \
  --data "${DATA:?set DATA=<aml csv>}" \
  --model "${MODEL:-pna}" --task edge_classification \
  --batch_size 200 --epochs "${EPOCHS:-100}" --num_neighs 100 100 \
  --n_hidden 32 --n_gnn_layers 2 "$@"
