"""Share of the traced window's device seconds inside the program's `noise`
span (%): the sphere noise synthesis (`ops.sph_harm`) of the draws. Read in
the forecast cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'forecast', 'noise')
