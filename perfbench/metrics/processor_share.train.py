"""Share of the traced window's device seconds inside the program's `processor`
span (%): the mesh transformer's forward, its gradient region and its
recomputation. Read in the training cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'train', 'processor')
