"""Share of the traced window's device seconds inside the forward pass's
`remat` regions (%): what the backward pass computes again, up to the tail
where a checkpoint stops its recomputation early. Read in the training
cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'train', 'remat')
