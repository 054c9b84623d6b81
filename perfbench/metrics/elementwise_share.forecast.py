"""Device time of ATen's elementwise kernels over all device time in the traced
window (%). Read in the forecast cells."""

from perfbench.lib import readers


def read(ctx):
  return readers.elementwise_share(ctx, 'forecast')
