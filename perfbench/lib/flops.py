"""Model FLOPs of GenCast: a frozen copy of the program's analytic count
(`training/flops.py`), over the reference's graph counts.

One multiply-add is 2 operations and every linear layer adds 2 * rows *
in * out; attention counts only the k-hop mask's allowed (query, key)
entries; elementwise work, the FiLM projections and remat's recomputation
are not counted; a training step is 3 forwards, a forecast step 2N - 1
denoiser calls. The yardstick is the H100 SXM's dense bf16 peak.
"""

from __future__ import annotations

from perfbench.reference import graph as graph_lib
from perfbench.reference import layout as layout_lib

H100_SXM_BF16_DENSE_PEAK_FLOPS = 989.4e12


def mlp_flops(rows: float, widths) -> float:
  return 2.0 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def _interaction(edge_rows, node_rows, received, latent, hidden_layers):
  h = [latent] * hidden_layers
  total = 0.0
  for rows in edge_rows:
    total += mlp_flops(rows, [3 * latent] + h + [latent])
  for name, rows in node_rows.items():
    total += mlp_flops(rows, [latent * (1 + received.get(name, 0))] + h
                       + [latent])
  return total


def denoiser_forward(config: dict, graph: graph_lib.Graph,
                     batch: int = 1) -> float:
  t = layout_lib.task(config)
  num_data = (t.inputs.num_channels + t.forcings.num_channels
              + t.targets.num_channels)
  latent = config['d_model']
  h = [latent] * config['hidden_layers']
  g, m = graph.num_grid * batch, graph.num_mesh * batch
  e_g2m = graph.grid2mesh.senders.size * batch
  e_m2g = graph.mesh2grid.senders.size * batch
  gnn = (mlp_flops(g, [3 + num_data] + h + [latent])
         + mlp_flops(m, [3] + h + [latent])
         + mlp_flops(e_g2m, [4] + h + [latent])
         + _interaction([e_g2m], {'grid': g, 'mesh': m}, {'mesh': 1}, latent,
                        config['hidden_layers'])
         + mlp_flops(e_m2g, [4] + h + [latent])
         + _interaction([e_m2g], {'grid': g, 'mesh': m}, {'grid': 1}, latent,
                        config['hidden_layers'])
         + mlp_flops(g, [latent] + h + [t.targets.num_channels]))
  d, f = config['d_model'], config['ffw_hidden']
  per_layer = (8.0 * graph.num_mesh * d * d
               + 4.0 * graph.attention_pairs * d
               + 4.0 * graph.num_mesh * d * f)
  return gnn + batch * config['num_layers'] * per_layer


def forecast_step(config: dict, graph: graph_lib.Graph, members: int
                  ) -> float:
  """One forecast step of `members` members: 2N - 1 denoiser calls."""
  calls = 2.0 * config['sampler']['num_noise_levels'] - 1.0
  return calls * denoiser_forward(config, graph, members)


def train_step(config: dict, graph: graph_lib.Graph, batch: int = 1
               ) -> float:
  return 3.0 * denoiser_forward(config, graph, batch)
