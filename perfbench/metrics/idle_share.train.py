"""Share of the traced window's wall in which no kernel, copy or set ran on the
device (%), the time the host spent in the profiler's own operations left
out. Read in the training cells."""

from perfbench.lib import readers


def read(ctx):
  return readers.idle_share(ctx, 'train')
