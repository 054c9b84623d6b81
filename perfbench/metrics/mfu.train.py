"""Model FLOPs of the traced window's work over its wall, as a share of the
H100's dense bf16 peak (%). Read in the training cells."""

from perfbench.lib import readers


def read(ctx):
  return readers.mfu(ctx, 'train')
