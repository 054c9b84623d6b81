"""Share of the traced window's device seconds inside the program's `denoiser`
span and outside its three layers (%): preconditioning, input assembly, the
noise encoder and casts. Read in the training cells."""

from perfbench.lib import spans


def read(ctx):
  return spans.self_share(ctx, 'train', 'denoiser')
