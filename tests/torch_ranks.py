"""Spawned ranks for the port's multi-process tests (no JAX here: each rank
imports this module and the port only).

`run_ranks` starts `world` 'spawn' processes on localhost, each running
fn(rank, world, coordinator, *args), and fails the test if one fails or if
they are not all done within `timeout` seconds (then it kills them).
`run_cli` runs a module of the port as a command in its own session with a
timeout, killing its whole process group (its ranks too) when it runs out.
"""

import multiprocessing
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Seconds each spawned process, or command, may take.
RANK_TIMEOUT = 60


def run_ranks(fn, world, args=(), timeout=RANK_TIMEOUT):
  from gencast_tpu_torch.parallel import meshes
  ctx = multiprocessing.get_context('spawn')
  coordinator = f'127.0.0.1:{meshes.free_port()}'
  procs = [ctx.Process(target=fn, args=(rank, world, coordinator) + tuple(args))
           for rank in range(world)]
  for p in procs:
    p.start()
  deadline = time.monotonic() + timeout
  try:
    for p in procs:
      p.join(max(0.0, deadline - time.monotonic()))
  finally:
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
      p.kill()
      p.join()
  assert not alive, f'{len(alive)} ranks still running after {timeout} s'
  assert [p.exitcode for p in procs] == [0] * world, [p.exitcode
                                                       for p in procs]


def run_cli(module, argv, timeout=RANK_TIMEOUT):
  """`python -m module argv` from the repository root, one CPU thread per
  process; returns its stdout, and fails with its output if it fails."""
  env = dict(os.environ, OMP_NUM_THREADS='1')
  proc = subprocess.Popen([sys.executable, '-m', module] + list(argv),
                          cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True,
                          start_new_session=True)
  try:
    out, err = proc.communicate(timeout=timeout)
  except subprocess.TimeoutExpired:
    os.killpg(proc.pid, signal.SIGKILL)
    proc.communicate()
    raise AssertionError(f'{module} {argv}: not done in {timeout} s')
  assert proc.returncode == 0, f'{module} exit {proc.returncode}\n{out}\n{err}'
  return out


def parallel_rank(rank, world, coordinator, out_dir):
  """One rank of tests/test_torch_parallel.py: the member-sharded functions
  over an ensemble axis of `world` ranks on the CPU; writes what it got to
  out_dir/rank<r>.npz."""
  import numpy as np
  import torch
  from gencast_tpu_torch.parallel import ensemble, meshes
  torch.set_num_threads(1)  # the parent's summation order
  meshes.initialize(coordinator, world, rank, device='cpu')
  try:
    mesh = meshes.make_mesh(ensemble=world)
    members, truth, lat_w = scoring_data()
    lo, hi = ensemble.member_range(members.shape[0], mesh)
    local = torch.as_tensor(members[lo:hi])
    scores = ensemble.ensemble_scores(local, torch.as_tensor(truth),
                                      torch.as_tensor(lat_w), mesh)
    mean, std = ensemble.ensemble_statistics(local, mesh)
    out = {f'score_{k}': v.numpy() for k, v in scores.items()}
    out.update(gathered=ensemble.gather_members(local, mesh).numpy(),
               mean=mean.numpy(), std=std.numpy())
    wrapped, _, inputs, forcings = sampling_inputs()
    samples = ensemble.ensemble_sample(wrapped, inputs, forcings[0],
                                       seed=1, num_members=3, mesh=mesh)
    run = ensemble.make_ensemble_rollout(wrapped, mesh)
    rollouts = run(inputs, forcings, 2, range(3))
    out.update(local_samples=samples.numpy(),
               samples=ensemble.gather_members(samples, mesh).numpy(),
               rollouts=ensemble.gather_members(rollouts, mesh).numpy())
    np.savez(os.path.join(out_dir, f'rank{rank}.npz'), **out)
  finally:
    meshes.shutdown()


def scoring_data():
  """Seeded members [5, 2, 19, 36, 3], truth and the 10-degree grid's
  latitude weights (float32)."""
  import numpy as np
  from gencast_tpu_torch.data import layout
  rng = np.random.default_rng(0)
  members = rng.standard_normal((5, 2, 19, 36, 3)).astype(np.float32)
  truth = rng.standard_normal((2, 19, 36, 3)).astype(np.float32)
  lat = np.arange(-90.0, 90.0 + 5.0, 10.0, dtype=np.float32)
  return members, truth, layout.latitude_weights(lat).astype(np.float32)


def sampling_inputs():
  """The toy GenCast of tools/multihost_smoke.py (wrapped), with seeded
  inputs [1, lat, lon, C] and forcings of 2 steps [2, 1, lat, lon, C]."""
  import numpy as np
  import torch
  from gencast_tpu_torch.tools import multihost_smoke
  wrapped, model, lat, lon = multihost_smoke.toy_model('cpu')
  d = model.denoiser
  rng = np.random.default_rng(3)
  inputs = torch.as_tensor(rng.standard_normal(
      (1, lat.size, lon.size, d.input_layout.num_channels)).astype(np.float32))
  forcings = torch.as_tensor(rng.standard_normal(
      (2, 1, lat.size, lon.size, d.forcing_layout.num_channels)).astype(
          np.float32))
  return wrapped, model, inputs, forcings


def model_axis_rank(rank, world, coordinator, work):
  """One rank of tests/test_torch_model_axis.py, over a model axis of
  `world` ranks on the CPU: for each case of work/cases.json (its bridged
  weights and data in work/<case>.npz), the forward, the loss and its
  gradients, and the parameters and clip norm after one AdamW step, the
  sharded tensors gathered; the bf16 stack's loss and gradients; the
  draws of a step; clip_by_global_norm_ on a replicated and a sharded
  gradient; and a checkpoint written under the axis, with this rank's
  slices of the parameters and moments. Rank r writes work/rank<r>.npz."""
  import json
  import numpy as np
  import torch
  from gencast_tpu_torch.parallel import meshes, tensor
  from gencast_tpu_torch.training import checkpoint, steps, train
  torch.set_num_threads(1)  # the parent's summation order
  meshes.initialize(coordinator, world, rank, device='cpu')
  try:
    axis = tensor.axis_of(meshes.make_mesh(model=world))
    with open(os.path.join(work, 'cases.json')) as f:
      cases = json.load(f)
    out = {}
    for name, case in cases.items():
      data = dict(np.load(os.path.join(work, f'{name}.npz')))
      flat = {k[len('param:'):]: v for k, v in data.items()
              if k.startswith('param:')}
      for bf16 in (False, True) if case.get('bf16') else (False,):
        model, stack = model_axis_stack(case, flat, bf16)
        if case['model'] == 'gencast':
          gencast = model
        tensor.shard_model(stack, axis)
        tag = f'{name}_bf16' if bf16 else name
        out.update(model_axis_step(tag, case, model, stack, data, axis,
                                   with_step=not bf16))
        if case.get('checkpoint') and not bf16:
          manager = checkpoint.create_manager(os.path.join(work, 'ckpt'))
          checkpoint.save(manager, 0, stack, stack.optimizer,
                          write=rank == 0)
          out.update({f'local:{k}': v.detach().numpy()
                      for k, v in stack.named_parameters()})
          for i, p in enumerate(stack.optimizer.params):
            for k in ('exp_avg', 'exp_avg_sq'):
              out[f'moment:{i}:{k}'] = stack.optimizer.adamw.state[p][
                  k].numpy()
    # Every rank of the model group draws a step's sigma and noise.
    sigma, noise = gencast.training_draws(
        train.step_generator(5, 3, 'cpu'), 1)
    out.update(draw_sigma=sigma.numpy(), draw_noise=noise.numpy())
    # The clip: a replicated gradient (the same on every rank) and this
    # rank's slice of a sharded one.
    full = torch.arange(1.0, 2.0 * world + 1.0)
    grads = [torch.tensor([3.0, 4.0]), tensor.local_slice(full, 0,
                                                          axis).clone()]
    norm = steps.clip_by_global_norm_(grads, 1.0, [False, True], axis)
    out.update(clip_norm=norm.numpy(), clip_replicated=grads[0].numpy(),
               clip_sharded=tensor.gather(grads[1], 0, axis).numpy())
    np.savez(os.path.join(work, f'rank{rank}.npz'), **out)
  finally:
    meshes.shutdown()


def model_axis_stack(case, flat, bf16=False):
  """The port model of a case of model_axis_rank (GenCast at a TINY preset,
  or TINY GraphCast) holding the bridged weights `flat`, and its wrapper
  stack (unit statistics; bf16 or float32)."""
  import dataclasses
  import numpy as np
  import torch
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout, registry
  from gencast_tpu_torch.graph import compiler
  from gencast_tpu_torch.models import graphcast, wrappers
  lat, lon = (np.asarray(case[k], np.float32) for k in ('lat', 'lon'))
  if case['model'] == 'graphcast':
    task = registry.TaskSpec(**{k: tuple(v) if isinstance(v, list) else v
                                for k, v in case['task'].items()})
    statics = compiler.build_graph_statics(case['splits'], lat, lon,
                                           build_multimesh=True)
    model = graphcast.GraphCast(
        task, statics, graphcast.GraphCastConfig(
            latent_size=case['latent'], gnn_msg_steps=case['steps']),
        rng=torch.Generator().manual_seed(0))
  else:
    spec = dataclasses.replace(configs.SPECS[case['preset']],
                               attention_tile_size=case['tile'])
    statics = compiler.build_graph_statics(
        spec.mesh_splits, lat, lon, attention_k_hop=spec.attention_k_hop,
        attention_tile_size=case['tile'], build_triblock_mask=True)
    model, _ = configs.build_gencast(spec, seed=1, statics=statics,
                                     device='cpu')
  bridge.load_reference_params(model, flat)
  task = model.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables) | set(task.target_variables)),
      task.pressure_levels)
  return model, wrappers.build_stack(model, stats, bf16=bf16)


def model_axis_step(tag, case, model, stack, data, axis, with_step=True):
  """The forward (GenCast), loss, gathered gradients and, `with_step`, the
  gathered parameters and clip norm after one AdamW step of the case's
  optimizer, keyed `<tag>:...`; sets stack.optimizer."""
  import torch
  from gencast_tpu_torch.parallel import tensor
  from gencast_tpu_torch.training import steps
  batch = [torch.as_tensor(data[k]) for k in ('inputs', 'targets',
                                              'forcings')]
  draws = ({} if case['model'] == 'graphcast' else
           {'sigma': torch.as_tensor(data['sigma']),
            'noise': torch.as_tensor(data['noise'])})
  out = {}
  if case['model'] != 'graphcast':
    with torch.no_grad():
      out[f'{tag}:forward'] = stack(batch[0], torch.as_tensor(data['noisy']),
                                    draws['sigma'], batch[2]).numpy()
  stack.optimizer = steps.create_optimizer(
      stack, steps.OptimizerConfig(**case['optimizer']))
  stack.optimizer.zero_grad()
  loss, _ = stack.loss(*batch, **draws)
  loss.mean().backward()
  dims = tensor.sharded_dims(model)
  grads = tensor.gather_state_dict(
      {n: p.grad if p.grad is not None else torch.zeros_like(p)
       for n, p in model.named_parameters()}, dims, axis)
  out[f'{tag}:loss'] = loss.detach().numpy()
  out.update({f'{tag}:grad:{k}': v
              for k, v in _reference_keys(model, grads).items()})
  if with_step:
    out[f'{tag}:norm'] = stack.optimizer.update().numpy()
    params = tensor.gather_state_dict(
        {n: p.detach() for n, p in model.named_parameters()}, dims, axis)
    out.update({f'{tag}:param:{k}': v
                for k, v in _reference_keys(model, params).items()})
  return out


def _reference_keys(model, named):
  """Tensors named and shaped as `model`'s parameters would be unsharded
  (gathered over the model axis) in the reference's keys and layouts."""
  from gencast_tpu_torch import bridge
  return bridge._export(iter(named.items()), bridge._scales(model))


def model_axis_calls_rank(rank, world, coordinator, work):
  """One rank of tests/test_torch_model_axis.py's count of the model
  axis's all_reduces: a TINY_PALLAS training step (seeded weights, unit
  statistics) under each remat policy, with the checkpoints' early stop
  (PyTorch's default) and without it, sharded over `world` ranks. Rank 0
  writes work/calls.json: the sharded modules, the layers, and for each
  policy and early stop the calls of the loss's forward and of its
  backward, and the sharded modules none of whose parameters got a
  gradient."""
  import dataclasses
  import json
  import numpy as np
  import torch
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.parallel import meshes, tensor
  torch.set_num_threads(1)
  meshes.initialize(coordinator, world, rank, device='cpu')
  try:
    axis = tensor.axis_of(meshes.make_mesh(model=world))
    out = {'steps': {}}
    for policy in ('full', 'save_attention'):
      spec = dataclasses.replace(configs.TINY_PALLAS, remat_policy=policy)
      model, statics = configs.build_gencast(spec, seed=0, device='cpu')
      task = model.task
      stack = wrappers.build_stack(model, layout.Stats.unit(
          sorted(set(task.input_variables) | set(task.target_variables)),
          task.pressure_levels), bf16=False)
      sharded, _ = tensor.shard_model(stack, axis)
      out.update(sharded=sharded, layers=spec.num_layers)
      d = model.denoiser
      rng = np.random.default_rng(0)
      grid = (1, len(statics.grid_lat), len(statics.grid_lon))
      batch = [torch.as_tensor(rng.standard_normal(
          grid + (lay.num_channels,)).astype(np.float32))
               for lay in (d.input_layout, d.target_layout,
                           d.forcing_layout)]
      for early in (True, False):
        stack.zero_grad(set_to_none=True)
        calls = [axis.traffic['calls']]
        with torch.utils.checkpoint.set_checkpoint_early_stop(early):
          loss, _ = stack.loss(*batch,
                               generator=torch.Generator().manual_seed(1))
          calls.append(axis.traffic['calls'])
          loss.mean().backward()
        calls.append(axis.traffic['calls'])
        no_grad = [n for n in sharded if all(
            p.grad is None for p in stack.get_submodule(n).parameters())]
        out['steps'][f'{policy}:{early}'] = {
            'forward': calls[1] - calls[0], 'backward': calls[2] - calls[1],
            'no_grad': no_grad}
    if rank == 0:
      with open(os.path.join(work, 'calls.json'), 'w') as f:
        json.dump(out, f)
  finally:
    meshes.shutdown()


def node_axis_rank(rank, world, coordinator, work):
  """One rank of tests/test_torch_node_axis.py, over a model axis of
  `world` ranks on the CPU with the grid nodes sharded over it
  (`DenoiserConfig.node_sharding_axis='model'`): for each case of
  work/cases.json (its weights and data in work/<case>.npz), the forward,
  the loss and every gradient (the processor's sharded ones gathered);
  then the all_reduce calls of the forward and of the backward of a
  TINY_PALLAS step under each remat policy. Rank r writes
  work/rank<r>.npz, rank 0 also work/calls.json."""
  import json
  import numpy as np
  import torch
  from gencast_tpu_torch.parallel import meshes, tensor
  torch.set_num_threads(1)  # the parent's summation order
  meshes.initialize(coordinator, world, rank, device='cpu')
  try:
    axis = tensor.axis_of(meshes.make_mesh(model=world))
    with open(os.path.join(work, 'cases.json')) as f:
      cases = json.load(f)
    out = {}
    for name, case in cases.items():
      data = dict(np.load(os.path.join(work, f'{name}.npz')))
      model, stack = node_axis_stack(case, data, 'model')
      tensor.shard_model(stack, axis)
      out.update(node_axis_step(name, model, stack, data, axis))
      out[f'{name}:rows'] = np.asarray(
          model.denoiser.architecture.node_rows)
      if name == 'dense':
        out.update(node_axis_accumulate(model, stack, data, axis))
    calls = {'layers': 2}
    for policy in ('full', 'save_attention'):
      case = dict(preset='tiny_pallas', remat_policy=policy,
                  remat_gnns=False, use_agg_plans=False,
                  agg_plan_min_degree=32, edge_chunk_size=None)
      model, stack = node_axis_stack(case, None, 'model')
      tensor.shard_model(stack, axis)
      rng = np.random.default_rng(0)
      d = model.denoiser
      grid = (1, d.num_lat, d.num_lon)
      batch = [torch.as_tensor(rng.standard_normal(
          grid + (lay.num_channels,)).astype(np.float32))
               for lay in (d.input_layout, d.target_layout,
                           d.forcing_layout)]
      counts = [axis.traffic['calls']]
      loss, _ = stack.loss(*batch, generator=torch.Generator().manual_seed(1))
      counts.append(axis.traffic['calls'])
      loss.mean().backward()
      counts.append(axis.traffic['calls'])
      calls[policy] = {'forward': counts[1] - counts[0],
                       'backward': counts[2] - counts[1]}
    np.savez(os.path.join(work, f'rank{rank}.npz'), **out)
    if rank == 0:
      with open(os.path.join(work, 'calls.json'), 'w') as f:
        json.dump(calls, f)
  finally:
    meshes.shutdown()


def node_axis_accumulate(model, stack, data, axis):
  """Every gradient (gathered over `axis`, in the reference's keys, keyed
  `accumulate:grad:...`) after a backward pass of the case's loss that
  raises midway (in the processor, after the GNNs' gradient sum was
  queued), the gradients set to None, then two passes with no zeroing in
  between: twice one pass's gradients, as each pass sums over the axis only
  what it adds, and the raised pass leaves no sum behind."""
  import torch
  from gencast_tpu_torch.parallel import tensor
  inputs, targets, forcings = (torch.as_tensor(data[k]) for k in (
      'inputs', 'targets', 'forcings'))
  draws = {k: torch.as_tensor(data[k]) for k in ('sigma', 'noise')}

  def backward():
    loss, _ = stack.loss(inputs, targets, forcings, **draws)
    loss.mean().backward()

  def abort(grad):
    raise RuntimeError('the pass aborted here')

  processor = next(p for n, p in model.named_parameters()
                   if '.architecture.processor.' in n)
  handle = processor.register_hook(abort)
  try:
    backward()
  except RuntimeError as e:
    if 'the pass aborted here' not in str(e):
      raise
  else:
    raise AssertionError('the backward pass did not raise')
  finally:
    handle.remove()
  model.zero_grad(set_to_none=True)
  backward()
  backward()
  grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
  grads = tensor.gather_state_dict(grads, tensor.sharded_dims(model), axis)
  return {f'accumulate:grad:{k}': v
          for k, v in _reference_keys(model, grads).items()}


def node_axis_stack(case, data, node_sharding_axis=None):
  """The port's GenCast of a case of node_axis_rank (a TINY preset with
  the case's GNN layout fields; the weights of data's 'param:' entries,
  in the reference's keys, when `data` is given) and its float32 wrapper
  stack with unit statistics."""
  import dataclasses
  import torch  # noqa: F401
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  fields = ('remat_policy', 'remat_gnns', 'use_agg_plans',
            'agg_plan_min_degree', 'edge_chunk_size')
  spec = dataclasses.replace(configs.SPECS[case['preset']],
                             **{k: case[k] for k in fields})
  model, _ = configs.build_gencast(spec, seed=0, device='cpu',
                                   node_sharding_axis=node_sharding_axis)
  if data is not None:
    bridge.load_reference_params(model, {
        k[len('param:'):]: v for k, v in data.items()
        if k.startswith('param:')})
  task = model.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables) | set(task.target_variables)),
      task.pressure_levels)
  return model, wrappers.build_stack(model, stats, bf16=False)


def node_axis_step(tag, model, stack, data, axis):
  """The forward, the loss and every gradient (in the reference's keys;
  the processor's sharded ones gathered over `axis` when it is given) of
  one step on the case's data, keyed `<tag>:...`."""
  import torch
  from gencast_tpu_torch.parallel import tensor
  inputs, targets, forcings = (torch.as_tensor(data[k]) for k in (
      'inputs', 'targets', 'forcings'))
  draws = {k: torch.as_tensor(data[k]) for k in ('sigma', 'noise')}
  out = {}
  with torch.no_grad():
    out[f'{tag}:forward'] = stack(inputs, torch.as_tensor(data['noisy']),
                                  draws['sigma'], forcings).numpy()
  loss, _ = stack.loss(inputs, targets, forcings, **draws)
  loss.mean().backward()
  grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
           for n, p in model.named_parameters()}
  if axis is not None:
    grads = tensor.gather_state_dict(grads, tensor.sharded_dims(model), axis)
  out[f'{tag}:loss'] = loss.detach().numpy()
  out.update({f'{tag}:grad:{k}': v
              for k, v in _reference_keys(model, grads).items()})
  return out
