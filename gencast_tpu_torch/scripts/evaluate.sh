#!/usr/bin/env bash
# 30-step rollout evaluation with an 8-member ensemble on one CUDA card
# (the card counterpart of scripts/evaluate_tpu.sh and of the reference's
# scripts/evaluation.sh). The plots need matplotlib and imageio: where they
# are missing, pass `--plot_vars` with no names. Run from the repository
# root; arguments after the script's own override them.
set -euo pipefail

DATA_DIR=${DATA_DIR:-/data/era5}
CKPT_DIR=${CKPT_DIR:-/ckpt/gencast_nano}
OUT_DIR=${OUT_DIR:-/tmp/gencast_eval}

python -m gencast_tpu_torch.training.evaluate \
  --preset nano \
  --data "$DATA_DIR" \
  --ckpt_dir "$CKPT_DIR" \
  --stats_path "$CKPT_DIR/stats.npz" \
  --max_rollout_steps 30 \
  --num_members 8 \
  --clean_sst_nans \
  --plot_vars 2m_temperature mean_sea_level_pressure \
      10m_u_component_of_wind 10m_v_component_of_wind \
  --out_dir "$OUT_DIR" \
  "$@"
