"""Share of the traced window's device seconds inside the program's `grid2mesh`
span (%): the grid-to-mesh GNN's forward, its gradient region and its
recomputation. Read in the forecast cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'forecast', 'grid2mesh')
