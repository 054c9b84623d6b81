"""Plotting: prediction/truth/error triptychs and rollout GIFs.

A copy of `gencast_tpu.training.plotting` (the port imports nothing of the
JAX package). matplotlib and imageio are imported inside the functions, so
the CLIs import this module on machines without them; asking for a plot
there raises ImportError.
"""

from __future__ import annotations


import numpy as np


def plot_triptych(pred: np.ndarray, truth: np.ndarray, lat: np.ndarray,
                  lon: np.ndarray, var_name: str, path: str) -> None:
  """Writes a Pred / Truth / Error PNG for one [lat, lon] field."""
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt

  err = pred - truth
  fig, axes = plt.subplots(1, 3, figsize=(16, 4), constrained_layout=True)
  vmin = np.nanmin(truth)
  vmax = np.nanmax(truth)
  extent = (lon.min(), lon.max(), lat.min(), lat.max())
  for ax, (data, title, cmap, norm) in zip(axes, (
      (pred, 'Prediction', 'viridis', (vmin, vmax)),
      (truth, 'Ground truth', 'viridis', (vmin, vmax)),
      (err, 'Error', 'RdBu_r',
       (-np.nanmax(np.abs(err)), np.nanmax(np.abs(err)))))):
    im = ax.imshow(data, origin='lower', extent=extent, cmap=cmap,
                   vmin=norm[0], vmax=norm[1], aspect='auto')
    ax.set_title(f'{var_name}: {title}')
    fig.colorbar(im, ax=ax, shrink=0.8)
  fig.savefig(path, dpi=110)
  plt.close(fig)


def rollout_gif(fields: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                var_name: str, path: str, fps: int = 4) -> None:
  """Animates a [K, lat, lon] rollout into a GIF."""
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  import imageio.v2 as imageio

  vmin, vmax = np.nanmin(fields), np.nanmax(fields)
  frames = []
  for k in range(fields.shape[0]):
    fig, ax = plt.subplots(figsize=(7, 4), constrained_layout=True)
    im = ax.imshow(fields[k], origin='lower',
                   extent=(lon.min(), lon.max(), lat.min(), lat.max()),
                   vmin=vmin, vmax=vmax, cmap='viridis', aspect='auto')
    ax.set_title(f'{var_name} — step {k + 1}')
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    frames.append(buf.copy())
    plt.close(fig)
  imageio.mimsave(path, frames, fps=fps, loop=0)
