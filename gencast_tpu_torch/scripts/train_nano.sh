#!/usr/bin/env bash
# Train nano-GenCast on one CUDA card (the card counterpart of
# scripts/train_nano_tpu.sh and of the reference's scripts/train.sh SLURM
# job). DATA_DIR holds ERA5 monthly NetCDF files (h5py) or the npz shards
# of `python -m gencast_tpu_torch.tools.convert_era5`; run from the
# repository root. Arguments after the script's own override them.
set -euo pipefail

DATA_DIR=${DATA_DIR:-/data/era5}
CKPT_DIR=${CKPT_DIR:-/ckpt/gencast_nano}
STEPS=${STEPS:-30000}

python -m gencast_tpu_torch.training.train \
  --preset nano \
  --data "$DATA_DIR" \
  --steps "$STEPS" \
  --batch_size 1 \
  --learning_rate 3e-4 \
  --warmup_steps 1000 \
  --clean_sst_nans \
  --ckpt_dir "$CKPT_DIR" \
  --stats_path "$CKPT_DIR/stats.npz" \
  --save_every 500 --eval_every 500 --do_sampling_eval \
  "$@"
