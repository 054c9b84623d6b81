"""Share of the traced window's device seconds inside the program's `mesh2grid`
span (%): the mesh-to-grid GNN's forward, its gradient region and its
recomputation. Read in the training cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'train', 'mesh2grid')
