"""A training step and ensemble sampling over an (ensemble, data, model)
grid of ranks, then the kernel paths under the same grid.

Counterpart of the reference's `__graft_entry__.dryrun_multichip` and
`dryrun_production_kernels` for the port's ranks (processes over
`torch.distributed`, parallel/meshes.py): `dryrun_multichip(n)` starts n
local ranks (gloo on the CPU or when they share a card, NCCL when each has
its own) and factors them as the reference does, e.g. 4 -> (1, 2, 2) and
8 -> (2, 2, 2). Each rank then runs:

- the reference's toy GenCast (a 30-degree grid, mesh splits 1, d_model
  32, 2 layers, 2 heads, ffw 64, the einsum tri-block attention,
  'save_attention' remat, churn 2.5), its attention heads and MLP hidden
  widths sharded over the model axis (parallel/tensor.py) and, as the
  reference's, its grid nodes too (`DenoiserConfig.node_sharding_axis`,
  when the model axis has more than one rank): one training
  step on a global batch of max(2, dp) rows split over the data axis, with
  a finite loss, then an ensemble sample of max(2, 2e) members over the
  ensemble axis, gathered and finite;
- the kernel paths: TINY on the fused tri-block backend (kernels C and D on
  the card) with aggregation plans forced (`agg_plan_min_degree=1`: kernel
  B, on plans of each rank's edges under the grid-node axis) and streamed
  edges (`edge_chunk_size=1024`), its grid nodes sharded as the toy's, loss
  and every gradient finite; and a 2-layer block-sparse transformer over a tile plan (kernels
  A and F) at the port's tile 64 (the reference's is 32: the tile is the
  kernels' design) and d_model 64 (the reference's 32 gives a head dim of
  16, which the kernels are not built for), loss and gradients finite.

  python -m gencast_tpu_torch.tools.dryrun_multichip 8      # on one card
  python -m gencast_tpu_torch.tools.dryrun_multichip 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import List, Tuple

import numpy as np
import torch

# The reference's factoring of n ranks into (ensemble, data, model).
FACTORS = {1: (1, 1, 1), 2: (1, 1, 2), 4: (1, 2, 2), 8: (2, 2, 2),
           16: (4, 2, 2), 32: (8, 2, 2), 64: (16, 2, 2)}


def factor(n: int) -> Tuple[int, int, int]:
  return FACTORS.get(n, (n, 1, 1))


def toy_model(device, node_sharding_axis=None):
  """The reference dryrun's toy GenCast, wrapped with unit statistics:
  (stack, model, lat, lon)."""
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.data import registry
  from gencast_tpu_torch.graph import compiler
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.models.denoiser import DenoiserConfig
  from gencast_tpu_torch.models.gencast import GenCast, SamplerConfig
  from gencast_tpu_torch.nn.transformer import TransformerConfig
  task = registry.TaskSpec(
      input_variables=('2m_temperature', 'temperature', 'year_progress_sin',
                       'land_sea_mask'),
      target_variables=('2m_temperature', 'temperature'),
      forcing_variables=('year_progress_sin',),
      pressure_levels=(500, 1000),
      num_input_frames=2)
  lat = np.arange(-90.0, 90.0 + 1e-6, 30.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 30.0, dtype=np.float32)
  # cache_dir=None: the ranks would all build and write the same cache.
  statics = compiler.build_graph_statics(1, lat, lon, attention_k_hop=2,
                                         build_triblock_mask=True,
                                         cache_dir=None)
  model = GenCast(
      task, statics,
      TransformerConfig(d_model=32, num_layers=2, num_heads=2, ffw_hidden=64,
                        attention_type='triblock',
                        remat_policy='save_attention'),
      denoiser_config=DenoiserConfig(latent_size=32,
                                     node_sharding_axis=node_sharding_axis),
      sampler_config=SamplerConfig(num_noise_levels=2,
                                   stochastic_churn_rate=2.5),
      rng=torch.Generator().manual_seed(0))
  stats = layout_lib.Stats.unit(
      sorted(set(task.input_variables) | set(task.target_variables)),
      task.pressure_levels)
  return wrappers.InputsAndResiduals(model, stats).to(device), model, lat, lon


def node_axis(mp: int):
  """The reference dryrun's `node_sharding_axis`: 'model' on a model axis
  of more than one rank."""
  return 'model' if mp > 1 else None


def _batch(rng, denoiser, batch, lat_size, lon_size, rows, device):
  """Seeded standard-normal inputs, targets and forcings of the global
  batch, this rank's rows of each."""
  out = []
  for c in (denoiser.input_layout.num_channels,
            denoiser.target_layout.num_channels,
            denoiser.forcing_layout.num_channels):
    x = rng.standard_normal((batch, lat_size, lon_size, c)).astype(np.float32)
    out.append(torch.as_tensor(x[rows[0]:rows[1]]).to(device))
  return out


def _draws(model, seed: int, batch: int, rows, device) -> dict:
  """The noise level and noise of the generator of (seed, 0) for the global
  batch, this rank's rows."""
  from gencast_tpu_torch.models import diffusion_utils
  sigma, noise = model.training_draws(
      diffusion_utils.keyed_generator(seed, 0, device=device), batch)
  return {'sigma': sigma[rows[0]:rows[1]], 'noise': noise[rows[0]:rows[1]]}


def _finite_grads(model) -> int:
  grads = [p.grad for p in model.parameters() if p.grad is not None]
  if not grads or not all(bool(torch.isfinite(g).all()) for g in grads):
    raise AssertionError('a gradient is missing or not finite')
  return len(grads)


def _toy_step(mesh, device) -> dict:
  """The toy's training step and ensemble sample (module docstring)."""
  from gencast_tpu_torch.parallel import ensemble, meshes, tensor
  from gencast_tpu_torch.training import steps
  e, dp, mp = mesh.shape
  wrapped, model, lat, lon = toy_model(device, node_axis(mp))
  tensor.shard_model(wrapped, tensor.axis_of(mesh))
  optimizer = steps.create_optimizer(
      wrapped, steps.OptimizerConfig(),
      data_group=mesh.group('data') if dp > 1 else None)
  batch = max(2, dp)
  rows = meshes.data_rows(mesh, batch)
  inputs, targets, forcings = _batch(np.random.default_rng(0),
                                     model.denoiser, batch, lat.size,
                                     lon.size, rows, device)
  loss, _ = steps.train_step(wrapped, optimizer, inputs, targets, forcings,
                             **_draws(model, 0, batch, rows, device))
  loss = float(loss)
  if not np.isfinite(loss):
    raise AssertionError(f'toy training step: loss {loss}')
  members = max(2, 2 * e)
  samples = ensemble.gather_members(ensemble.ensemble_sample(
      wrapped, inputs, forcings, seed=1, num_members=members, mesh=mesh),
      mesh)
  if samples.shape[0] != members or not bool(torch.isfinite(samples).all()):
    raise AssertionError(f'toy ensemble: {tuple(samples.shape)}, finite '
                         f'{bool(torch.isfinite(samples).all())}')
  return {'loss': loss, 'samples': list(samples.shape)}


def _kernel_paths(mesh, device) -> dict:
  """TINY on the fused tri-block backend with forced plans and streamed
  edges, and a 2-layer block-sparse transformer (module docstring)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.graph import compiler
  from gencast_tpu_torch.nn import transformer as tr
  from gencast_tpu_torch.parallel import meshes, tensor
  from gencast_tpu_torch.training import steps
  axis = tensor.axis_of(mesh)
  dp = mesh.axis_size('data')
  batch = max(2, dp)
  rows = meshes.data_rows(mesh, batch)
  spec = dataclasses.replace(
      configs.TINY, attention_type='triblock_pallas',
      remat_policy='save_attention', use_agg_plans=True,
      agg_plan_min_degree=1, edge_chunk_size=1024, num_noise_levels=2)
  model, statics = configs.build_gencast(
      spec, seed=0, statics=configs.build_statics(spec, cache_dir=None),
      device=device, node_sharding_axis=node_axis(mesh.axis_size('model')))
  tensor.shard_model(model, axis)
  # Only to average the loss and gradients over the data axis.
  optimizer = steps.create_optimizer(
      model, steps.OptimizerConfig(),
      data_group=mesh.group('data') if dp > 1 else None)
  rng = np.random.default_rng(1)
  inputs, targets, forcings = _batch(
      rng, model.denoiser, batch, statics.grid_lat.size,
      statics.grid_lon.size, rows, device)
  loss, _ = model.loss(inputs, targets, forcings,
                       **_draws(model, 2, batch, rows, device))
  loss.mean().backward()
  loss = float(optimizer.average_over_ranks(loss.mean().detach()))
  leaves = _finite_grads(model)
  tiny_launches = _launches()
  if not np.isfinite(loss):
    raise AssertionError(f'tiny triblock_pallas: loss {loss}')

  small = compiler.build_graph_statics(
      2, np.arange(-90.0, 90.0 + 1e-6, 15.0, dtype=np.float32),
      np.arange(0.0, 360.0, 15.0, dtype=np.float32), attention_k_hop=4,
      attention_tile_size=64, cache_dir=None)
  flash = tr.MeshTransformer(
      tr.TransformerConfig(d_model=64, num_layers=2, num_heads=2,
                           ffw_hidden=64, attention_type='pallas'),
      tile_plan=small.attention_tile_plan,
      rng=torch.Generator().manual_seed(3)).to(device)
  tensor.shard_model(flash, axis)
  x = rng.standard_normal((small.num_mesh_nodes, batch, 64)).astype(
      np.float32)
  cond = rng.standard_normal((batch, 16)).astype(np.float32)
  out = flash(torch.as_tensor(x[:, rows[0]:rows[1]]).to(device),
              torch.as_tensor(cond[rows[0]:rows[1]]).to(device))
  flash_loss = (out ** 2).mean()
  flash_loss.backward()
  flash_leaves = _finite_grads(flash)
  if not bool(torch.isfinite(flash_loss)):
    raise AssertionError(f'tile-plan transformer: loss {flash_loss}')
  return {'kernels_loss': loss, 'grad_leaves': leaves,
          'flash_loss': float(flash_loss.detach()),
          'flash_grad_leaves': flash_leaves, 'tiny_launches': tiny_launches}


def _launches() -> dict:
  """Every kernel's launches in this process so far."""
  from gencast_tpu_torch.ops import cuda_lib
  return {c.name: c.launches for c in cuda_lib.COUNTERS}


def _rank(rank: int, world: int, coordinator: str, device: str,
          out_dir: str) -> None:
  """One rank of the dryrun; writes its numbers to out_dir/rank<r>.json."""
  from gencast_tpu_torch.parallel import meshes
  t0 = time.perf_counter()
  backend, dev = meshes.initialize(coordinator, world, rank, device=device)
  try:
    e, dp, mp = factor(world)
    mesh = meshes.make_mesh(e, dp, mp)
    if rank == 0:
      print(f'[dryrun] {world} ranks, backend {backend}, mesh (ensemble, '
            f'data, model) = ({e}, {dp}, {mp}); grid nodes sharded over the '
            f'model axis: {node_axis(mp) is not None}', flush=True)
    out = {'rank': rank, 'mesh': [e, dp, mp], 'backend': backend}
    out.update(_toy_step(mesh, dev))
    toy_launches = _launches()
    if rank == 0:
      print(f'dryrun_multichip ok: mesh=({e},{dp},{mp}) loss='
            f'{out["loss"]:.4f} samples={tuple(out["samples"])} '
            f'({time.perf_counter() - t0:.0f}s)', flush=True)
    out.update(_kernel_paths(mesh, dev))
    out['launches'] = _launches()
    # The TINY kernel path's launches alone (a loss and its backward).
    out['tiny_launches'] = {k: v - toy_launches[k]
                            for k, v in out['tiny_launches'].items()}
    if rank == 0:
      print(f'dryrun kernels ok: tiny-shaped triblock_pallas mesh=({e},{dp},'
            f'{mp}) loss={out["kernels_loss"]:.4f} grad_leaves='
            f'{out["grad_leaves"]}', flush=True)
      print(f'dryrun kernels ok: tile-plan flash backend loss='
            f'{out["flash_loss"]:.4f}', flush=True)
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
      json.dump(out, f)
  finally:
    meshes.shutdown()


def dryrun_multichip(n: int, device: str = 'cuda') -> List[dict]:
  """Runs the dryrun on n local ranks (module docstring) and returns each
  rank's numbers: its mesh, the toy's loss and sample shape, the kernel
  paths' losses and gradient counts, and its kernel launches."""
  from gencast_tpu_torch.parallel import meshes
  t0 = time.perf_counter()
  with tempfile.TemporaryDirectory() as tmp:
    meshes.spawn(_rank, n, (device, tmp))
    ranks = []
    for r in range(n):
      with open(os.path.join(tmp, f'rank{r}.json')) as f:
        ranks.append(json.load(f))
  print(f'[dryrun] all done in {time.perf_counter() - t0:.0f}s', flush=True)
  return ranks


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('n', type=int, nargs='?', default=8,
                 help='ranks to start (default 8: mesh (2, 2, 2))')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (the card) or 'cpu'")
  args = p.parse_args(argv)
  if args.device != 'cpu' and not torch.cuda.is_available():
    raise SystemExit('--device cuda: no CUDA card is available; pass '
                     '--device cpu to run on the CPU')
  for out in dryrun_multichip(args.n, args.device):
    # One write per line: the ranks' output may interleave.
    for what, key in (('launches', 'launches'),
                      ('TINY kernel path launches', 'tiny_launches')):
      print(f'[dryrun] rank {out["rank"]} {what} ' + json.dumps(
          {k: v for k, v in out[key].items() if v}) + '\n', end='',
            flush=True)


if __name__ == '__main__':
  main()
