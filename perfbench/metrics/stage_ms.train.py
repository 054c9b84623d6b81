"""Median host time (ms) of the program's `train.stage` spans in the traced
window: a step's address check and staging (its pool row, rate and draws)
before its graph replay. Read in the training cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.host_median_ms(ctx, 'train', 'train.stage')
