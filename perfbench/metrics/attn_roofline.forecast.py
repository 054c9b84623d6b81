"""The block-sparse attention kernels' least possible time over their device
time in the traced window (%). Read in the forecast cells."""

from perfbench.lib import readers


def read(ctx):
  return readers.attn_roofline(ctx, 'forecast')
