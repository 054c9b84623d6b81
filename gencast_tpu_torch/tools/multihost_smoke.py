"""Multi-process smoke: N ranks on localhost train one data-parallel step
and sample a 2-member ensemble over an (ensemble, data) grid.

Counterpart of the reference's `tools/multihost_smoke.py` for the port's
ranks (`torch.distributed`, parallel/meshes.py): it starts N local
processes itself (gloo on the CPU or when they share a card, NCCL when each
has its own), builds in each the same toy GenCast as the reference's (a
45-degree grid, mesh splits 1, d_model 32, 2 layers, the einsum tri-block
attention), and runs over a mesh of ensemble 2 x data N/2:

- one training step on a global batch of N/2 rows, one per data rank, the
  noise level and noise drawn for the global batch and cut to each rank's
  row, the gradient and the loss averaged over the data axis;
- a 2-member ensemble sample of the first row, one member per ensemble
  rank, gathered on every rank.

Every rank must end with the same loss and the same sum of the samples:
each checks it against the others (an all_reduce of the value and its
negation under MAX) and prints `MULTIHOST_OK p<rank>/<N> loss=... sum=...`.

  python -m gencast_tpu_torch.tools.multihost_smoke --num_processes 4 \
      --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def toy_model(device):
  """The toy GenCast of the reference's smoke, wrapped: (stack, model, lat,
  lon)."""
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
  lat = np.arange(-90.0, 90.0 + 1e-6, 45.0, dtype=np.float32)
  lon = np.arange(0.0, 360.0, 45.0, dtype=np.float32)
  # cache_dir=None: the ranks would race on the on-disk statics cache.
  statics = compiler.build_graph_statics(1, lat, lon, attention_k_hop=2,
                                         build_triblock_mask=True,
                                         cache_dir=None)
  model = GenCast(
      task, statics,
      TransformerConfig(d_model=32, num_layers=2, num_heads=2,
                        ffw_hidden=64, attention_type='triblock'),
      denoiser_config=DenoiserConfig(latent_size=32),
      sampler_config=SamplerConfig(num_noise_levels=2,
                                   stochastic_churn_rate=2.5),
      rng=torch.Generator().manual_seed(0))
  stats = layout_lib.Stats.unit(
      sorted(set(task.input_variables) | set(task.target_variables)),
      task.pressure_levels)
  return wrappers.InputsAndResiduals(model, stats).to(device), model, lat, lon


def _same_everywhere(value: float, device) -> bool:
  import torch.distributed as dist
  t = torch.tensor([value, -value], dtype=torch.float64, device=device)
  dist.all_reduce(t, op=dist.ReduceOp.MAX)
  return float(t[0]) == value == -float(t[1])


def rank_main(rank: int, world: int, coordinator: str, device: str) -> None:
  """One rank of the smoke (see the module docstring)."""
  from gencast_tpu_torch.models import diffusion_utils
  from gencast_tpu_torch.parallel import ensemble, meshes
  from gencast_tpu_torch.training import steps
  backend, dev = meshes.initialize(coordinator, world, rank, device=device)
  try:
    mesh = meshes.make_mesh(ensemble=2, data=world // 2)
    print(f'[mh p{rank}] backend {backend}, device {dev}, mesh '
          f'{mesh.shape}, coordinates {mesh.coords}', flush=True)
    wrapped, model, lat, lon = toy_model(dev)
    optimizer = steps.create_optimizer(wrapped, steps.OptimizerConfig(),
                                       data_group=mesh.group('data'))
    batch = mesh.axis_size('data')
    rng = np.random.default_rng(0)  # the same global batch on every rank
    d = model.denoiser

    def arr(c):
      return torch.as_tensor(rng.standard_normal(
          (batch, lat.size, lon.size, c)).astype(np.float32)).to(dev)

    inputs = arr(d.input_layout.num_channels)
    targets = arr(d.target_layout.num_channels)
    forcings = arr(d.forcing_layout.num_channels)
    lo, hi = meshes.data_rows(mesh, batch)
    sigma, noise = model.training_draws(
        diffusion_utils.keyed_generator(0, 0, device=dev), batch)
    loss, _ = steps.train_step(wrapped, optimizer, inputs[lo:hi],
                               targets[lo:hi], forcings[lo:hi],
                               sigma=sigma[lo:hi], noise=noise[lo:hi])
    loss = float(loss)
    if not (np.isfinite(loss) and _same_everywhere(loss, dev)):
      raise AssertionError(f'rank {rank}: loss {loss} differs across ranks')
    print(f'[mh p{rank}] train step ok loss={loss:.6f}', flush=True)

    local = ensemble.ensemble_sample(wrapped, inputs[:1], forcings[:1],
                                     seed=1, num_members=2, mesh=mesh)
    samples = ensemble.gather_members(local, mesh)
    total = float(samples.double().sum())
    if not (bool(torch.isfinite(samples).all())
            and _same_everywhere(total, dev)):
      raise AssertionError(f'rank {rank}: samples not finite or differ')
    print(f'[mh p{rank}] ensemble sample ok shape={tuple(samples.shape)} '
          f'sum={total:.6f}', flush=True)
    # One write: the ranks share a stdout.
    print(f'MULTIHOST_OK p{rank}/{world} loss={loss:.6f} sum={total:.6f}\n',
          end='', flush=True)
  finally:
    meshes.shutdown()


def main(argv=None) -> None:
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('--num_processes', type=int, default=4,
                 help='ranks to start: an even number (ensemble 2 x data '
                      'N/2)')
  p.add_argument('--device', default='cuda',
                 help="'cuda' (rank r on cuda:(r mod cards)) or 'cpu'")
  args = p.parse_args(argv)
  if args.num_processes < 2 or args.num_processes % 2:
    p.error(f'--num_processes must be even and >= 2, got '
            f'{args.num_processes}')
  from gencast_tpu_torch.parallel import meshes
  meshes.spawn(rank_main, args.num_processes, (args.device,))


if __name__ == '__main__':
  main()
