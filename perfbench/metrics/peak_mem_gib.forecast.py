"""Peak device memory of the run: the allocator's high mark from process start
to the window's close, the captured graphs' pools included (GiB). Read in
the forecast cells."""

from perfbench.lib import readers


def read(ctx):
  return readers.peak_mem_gib(ctx, 'forecast')
