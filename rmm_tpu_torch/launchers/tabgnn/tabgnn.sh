#!/usr/bin/env bash
# TABGNN supervised run (reference slurm/tabgnn/tabgnn.sh)
source "$(dirname "$0")/../common.sh"
MODEL=tabgnn exec "$(dirname "$0")/../supervised/supervised.sh" "$@"
