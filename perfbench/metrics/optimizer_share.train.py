"""Share of the traced window's device seconds inside the program's
`optimizer` span (%): the gradient clip and the AdamW update. Read in the
training cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.layer_share(ctx, 'train', 'optimizer')
