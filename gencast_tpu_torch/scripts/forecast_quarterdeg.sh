#!/usr/bin/env bash
# One-command 0.25-degree 30-step (15-day) GenCast forecast on one CUDA
# card (the card counterpart of scripts/forecast_quarterdeg.sh):
#   * bf16 compute (float32 master weights)  -> the preset's default
#   * NaNCleaner on sea_surface_temperature (NaNs reintroduced over land,
#     reference semantics)                   -> --clean_sst_nans
#   * chunked rollout, one step per chunk, each chunk's predictions copied
#     to the host while the next computes    -> --chunk_size 1
# A translated published checkpoint (tools.translate_checkpoint --preset
# 0.25deg) serves as CKPT_DIR; add `--stats_path` with DeepMind's NetCDF
# statistics after the positional arguments.
#
# Usage, from the repository root:
#   gencast_tpu_torch/scripts/forecast_quarterdeg.sh DATA_DIR CKPT_DIR \
#       [OUT_DIR] [STEPS] [more evaluate flags]
set -euo pipefail

DATA_DIR=${1:?usage: forecast_quarterdeg.sh DATA_DIR CKPT_DIR [OUT_DIR] [STEPS]}
CKPT_DIR=${2:?usage: forecast_quarterdeg.sh DATA_DIR CKPT_DIR [OUT_DIR] [STEPS]}
OUT_DIR=${3:-/tmp/gencast_qdeg_forecast}
STEPS=${4:-30}
shift $(( $# < 4 ? $# : 4 ))

exec python -m gencast_tpu_torch.training.evaluate \
  --preset 0.25deg \
  --data "$DATA_DIR" \
  --ckpt_dir "$CKPT_DIR" \
  --out_dir "$OUT_DIR" \
  --max_rollout_steps "$STEPS" \
  --chunk_size 1 \
  --clean_sst_nans \
  "$@"
