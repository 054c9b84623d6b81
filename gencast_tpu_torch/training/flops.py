"""Analytic model-FLOP accounting and MFU.

Counterpart of `gencast_tpu.training.flops`, formula for formula; the peak
is the H100's. Counts MODEL FLOPs: the matrix-multiply work the
architecture requires, independent of how it is executed. Conventions
(the standard MFU accounting, e.g. the PaLM appendix):

* One multiply-add = 2 FLOPs; every linear layer contributes
  2 * rows * in * out.
* Attention einsums count only USEFUL attended (query, key) pairs — the
  true entries of the k-hop mask. Padding/masked-tile waste the kernels
  execute on top of this is deliberately NOT counted, so low MFU
  correctly indicts masked waste as much as stalls. The count is the
  mask's, so the tri-block mask and a tile plan at any tile give the same.
* The backward pass is 2x the forward matmul work (dX and dW per
  matmul), so train_step = 3x forward. Rematerialized recompute is NOT
  counted (it is execution overhead, not model work) — MFU under remat
  honestly reads lower.
* Elementwise work (LayerNorm, FiLM scale/offset, activations,
  softmax normalization, the EDM loss, spherical-harmonic noise
  synthesis, AdamW) is excluded: sub-1% of matmul FLOPs at every
  production scale. The FiLM *projections* (cond [B,16] -> [B,2C]) are
  similarly negligible (rows = batch) and excluded for simplicity.

The per-component formulas mirror the constructors they account for:
models/denoiser.py (DenoiserArchitecture), models/graphcast.py
(GraphCast), nn/gnn.py (TypedGraphNet/InteractionNetwork),
nn/transformer.py (MeshTransformer). tests/test_torch_flops.py holds them
to the JAX package's counts and bounds them by
torch.utils.flop_counter's count of a forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Peak dense matmul throughput of one NVIDIA H100 SXM5 (NVIDIA's H100
# data sheet: 989.4 TFLOP/s bf16 tensor core without sparsity, at the
# 700 W power limit). MFU is always reported against the bf16 peak,
# including for float32-compute configs — their true utilization of the
# (slower) float32 path is higher than the printed number, which keeps the
# metric a single conservative yardstick across presets. A card set below
# 700 W runs slower under load; write its power limit beside any MFU.
H100_SXM_BF16_DENSE_PEAK_FLOPS = 989.4e12


@dataclasses.dataclass(frozen=True)
class Flops:
  """Model-FLOP breakdown of one forward (or one train) step."""
  transformer: float
  gnn: float

  @property
  def total(self) -> float:
    return self.transformer + self.gnn

  def scaled(self, k: float) -> 'Flops':
    return Flops(self.transformer * k, self.gnn * k)

  def __add__(self, other: 'Flops') -> 'Flops':
    return Flops(self.transformer + other.transformer,
                 self.gnn + other.gnn)


def mlp_flops(rows: float, widths) -> float:
  """2 * rows * sum of kernel sizes for an MLP with the given layer
  widths ([in, hidden..., out]); matches nn/mlp.py MLP."""
  return 2.0 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def _interaction_flops(edge_rows, node_rows_by_set, recv_edge_sets,
                       latent: int, hidden_layers: int) -> float:
  """One InteractionNetwork step (nn/gnn.py:126-229).

  edge_rows: {edge set name: rows}; node_rows_by_set: {node set: rows};
  recv_edge_sets: {node set: number of edge sets received} (drives the
  node-MLP input width: latent * (1 + num_received)).
  """
  h = [latent] * hidden_layers
  total = 0.0
  for rows in edge_rows.values():
    total += mlp_flops(rows, [3 * latent] + h + [latent])
  for name, rows in node_rows_by_set.items():
    in_size = latent * (1 + recv_edge_sets.get(name, 0))
    total += mlp_flops(rows, [in_size] + h + [latent])
  return total


def attention_pairs(statics) -> float:
  """Useful attended (q, k) pairs of the k-hop mask per layer.

  Prefers the banded mask's true count; falls back to the tile plan's
  referenced mask tiles (deduplicated patterns, summed per active slot).
  """
  if statics.attention_mask is not None:
    return float(statics.attention_mask.blocks.sum())
  plan = statics.attention_tile_plan
  if plan is None:
    raise ValueError('statics carry neither a banded mask nor a tile plan')
  per_tile = plan.mask_tiles.astype(np.int64).sum(axis=(1, 2))
  return float(per_tile[plan.fwd_pair_ids].sum())


def transformer_forward_flops(num_nodes: int, pairs: float, d_model: int,
                              ffw_hidden: int, num_layers: int,
                              batch: int = 1) -> float:
  """Per-layer: q/k/v/out projections (4 * 2*N*D^2), score + weighted-sum
  einsums over useful pairs (2 * 2*P*D), FFW (2 * 2*N*D*F); matches
  nn/transformer.py TransformerBlock."""
  n = num_nodes
  per_layer = (8.0 * n * d_model * d_model
               + 4.0 * pairs * d_model
               + 4.0 * n * d_model * ffw_hidden)
  return batch * num_layers * per_layer


def denoiser_forward_flops(spec, statics, batch: int = 1,
                           task=None) -> Flops:
  """One preconditioned-denoiser forward at a ModelSpec's configuration.

  Mirrors models/denoiser.py construction: grid2mesh TypedGraphNet
  (embeds grid/mesh nodes + g2m edges, 1 MP step), the mesh transformer,
  mesh2grid TypedGraphNet (embeds m2g edges, 1 MP step, decodes grid).
  `task` overrides spec.task (the config builders may substitute one).
  """
  from gencast_tpu_torch.data import layout as layout_lib

  task = task if task is not None else spec.task
  in_lay = layout_lib.build_layout(task.input_variables,
                                   task.pressure_levels,
                                   task.num_input_frames)
  tgt_lay = layout_lib.build_layout(task.target_variables,
                                    task.pressure_levels, 1)
  frc_lay = layout_lib.build_layout(task.forcing_variables,
                                    task.pressure_levels, 1)
  # Denoiser grid-data channels: inputs + (forcings merged with noisy
  # targets) (models/denoiser.py:235).
  num_data = (in_lay.num_channels + frc_lay.num_channels
              + tgt_lay.num_channels)
  c_out = tgt_lay.num_channels

  latent = spec.d_model
  h = [latent] * spec.hidden_layers
  g = statics.num_grid_nodes * batch
  m = statics.num_mesh_nodes * batch
  e_g2m = statics.grid2mesh.num_edges * batch
  e_m2g = statics.mesh2grid.num_edges * batch

  gnn = 0.0
  # grid2mesh: embedders (grid, mesh, g2m edges) + 1 interaction step.
  gnn += mlp_flops(g, [3 + num_data] + h + [latent])
  gnn += mlp_flops(m, [3] + h + [latent])
  gnn += mlp_flops(e_g2m, [4] + h + [latent])
  gnn += _interaction_flops({'g2m': e_g2m}, {'grid': g, 'mesh': m},
                            {'mesh': 1}, latent, spec.hidden_layers)
  # mesh2grid: edge embedder + 1 interaction step + grid decoder.
  gnn += mlp_flops(e_m2g, [4] + h + [latent])
  gnn += _interaction_flops({'m2g': e_m2g}, {'grid': g, 'mesh': m},
                            {'grid': 1}, latent, spec.hidden_layers)
  gnn += mlp_flops(g, [latent] + h + [c_out])

  tr = transformer_forward_flops(
      statics.num_mesh_nodes, attention_pairs(statics), spec.d_model,
      spec.ffw_hidden, spec.num_layers, batch)
  return Flops(transformer=tr, gnn=gnn)


def graphcast_forward_flops(spec, statics, batch: int = 1,
                            task=None) -> Flops:
  """One GraphCast forward (models/graphcast.py): grid2mesh encoder,
  `num_layers` multimesh GNN message-passing steps (the reference's
  gnn_msg_steps), mesh2grid decoder. The 'transformer' slot carries the
  multimesh processor so the breakdown stays encoder/decoder vs
  processor. `task` overrides spec.task (build_graphcast substitutes the
  GraphCast variable set for GenCast-task presets)."""
  from gencast_tpu_torch.data import layout as layout_lib

  task = task if task is not None else spec.task
  in_lay = layout_lib.build_layout(task.input_variables,
                                   task.pressure_levels,
                                   task.num_input_frames)
  tgt_lay = layout_lib.build_layout(task.target_variables,
                                    task.pressure_levels, 1)
  frc_lay = layout_lib.build_layout(task.forcing_variables,
                                    task.pressure_levels, 1)
  num_data = in_lay.num_channels + frc_lay.num_channels
  c_out = tgt_lay.num_channels

  latent = spec.d_model
  h = [latent] * spec.hidden_layers
  g = statics.num_grid_nodes * batch
  m = statics.num_mesh_nodes * batch
  e_g2m = statics.grid2mesh.num_edges * batch
  e_m2g = statics.mesh2grid.num_edges * batch
  if statics.multimesh_edges is None:
    raise ValueError('GraphCast flops need statics built with multimesh')
  e_mm = statics.multimesh_edges.num_edges * batch

  gnn = 0.0
  gnn += mlp_flops(g, [3 + num_data] + h + [latent])
  gnn += mlp_flops(m, [3] + h + [latent])
  gnn += mlp_flops(e_g2m, [4] + h + [latent])
  gnn += _interaction_flops({'g2m': e_g2m}, {'grid': g, 'mesh': m},
                            {'mesh': 1}, latent, spec.hidden_layers)
  gnn += mlp_flops(e_m2g, [4] + h + [latent])
  gnn += _interaction_flops({'m2g': e_m2g}, {'grid': g, 'mesh': m},
                            {'grid': 1}, latent, spec.hidden_layers)
  gnn += mlp_flops(g, [latent] + h + [c_out])

  # Multimesh processor: one edge embedder + num_layers unshared steps.
  proc = mlp_flops(e_mm, [4] + h + [latent])
  proc += spec.num_layers * _interaction_flops(
      {'mesh': e_mm}, {'mesh': m}, {'mesh': 1}, latent, spec.hidden_layers)
  return Flops(transformer=proc, gnn=gnn)


def train_step_flops(forward: Flops) -> Flops:
  """fwd + bwd = 3x forward matmul work (dX and dW per matmul); remat
  recompute and the optimizer update are execution overhead, excluded."""
  return forward.scaled(3.0)


def sampler_step_flops(forward: Flops, num_noise_levels: int) -> Flops:
  """One DPM-Solver++2S forecast step: 2 denoiser calls per noise level,
  the last level short-circuits (models/gencast.py; reference
  dpm_solver_plus_plus_2s.py:140-153)."""
  return forward.scaled(2.0 * num_noise_levels - 1.0)


def mfu(flops_total: float, seconds: float,
        peak: float = H100_SXM_BF16_DENSE_PEAK_FLOPS) -> float:
  """Model-FLOPs utilization: achieved model FLOP/s over the card's
  peak."""
  return flops_total / seconds / peak
