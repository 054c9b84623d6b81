"""The reference's TINY (`--preset tiny`: the einsum 'triblock' attention)
and a 'dense' TINY in the port against the JAX package on the CPU, end to
end: one denoiser call, the training loss and every parameter gradient on
the same perturbed weights, data and draws; and both through the training
and evaluate CLIs. The modules themselves: tests/test_torch_attention_
backends.py.
"""

import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.models import wrappers
from gencast_tpu_torch.ops import banded_attention, sparse_attention
from gencast_tpu_torch.training import evaluate, train
from tests.test_torch_training import _draws, _flat, _stats
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# The whole TINY, float32, as tests/test_torch_gencast.py and
# tests/test_torch_training.py hold the kernels' backends: the denoiser,
# the loss, and the gradients per parameter.
DENOISER_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4
BACKENDS = ('triblock', 'dense')


def _rel(got, want):
  return float(np.abs(got - want).max() / np.abs(want).max())


def _tiny_pair(kind):
  """The reference's TINY with attention `kind` built by each package
  (the JAX one by its own build_gencast), with the same perturbed
  weights."""
  jspec = dataclasses.replace(jax_configs.TINY, attention_type=kind)
  tspec = dataclasses.replace(configs.TINY, attention_type=kind)
  lat, lon = jax_configs.grid_for_resolution(jspec.resolution_deg)
  jstatics = jax_compiler.build_graph_statics(
      jspec.mesh_splits, lat, lon, attention_k_hop=jspec.attention_k_hop,
      build_triblock_mask=True, cache_dir=None)
  jmodel, _ = jax_configs.build_gencast(jspec, rngs=nnx.Rngs(0),
                                        statics=jstatics)
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  flat = bridge.perturbed(_flat(nnx.state(jmodel, nnx.Param)), seed=7)
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(flat['/'.join(map(str, p))])))
       for p, v in flat_state]))
  tmodel, _ = configs.build_gencast(tspec, seed=1, device='cpu')
  bridge.load_reference_params(tmodel, flat)
  d = tmodel.denoiser
  rng = np.random.default_rng(0)
  shape = (1, lat.shape[0], lon.shape[0])
  data = [rng.standard_normal(shape + (lay.num_channels,)).astype(np.float32)
          for lay in (d.input_layout, d.target_layout, d.forcing_layout)]
  return jmodel, tmodel, data


@pytest.mark.parametrize('kind', BACKENDS)
def test_tiny_denoiser_loss_and_gradients_match_jax(kind):
  """The reference's TINY ('triblock': its own preset) and a 'dense' TINY:
  one denoiser call, then the training loss and every parameter gradient
  through the wrapper stack (the JAX side under its 'full' remat), against
  gencast_tpu on the same weights, data and draws. No kernel is launched on
  the CPU, and the einsum backends call no kernel's plain version."""
  jmodel, tmodel, (inputs, targets, forcings) = _tiny_pair(kind)
  sigma = np.asarray([1.9], np.float32)
  want = np.asarray(jmodel(*map(jnp.asarray,
                                (inputs, targets, sigma, forcings))))
  with torch.no_grad():
    got = tmodel(*map(torch.as_tensor,
                      (inputs, targets, sigma, forcings))).numpy()
  assert _rel(got, want) <= DENOISER_RTOL

  jstats, tstats = _stats(configs.TINY.task, seed=3)
  jstack = jax_wrappers.build_stack(jmodel, jstats, bf16=False)
  tstack = wrappers.build_stack(tmodel, tstats, bf16=False)
  key = jax.random.PRNGKey(5)

  @nnx.jit
  def jax_loss_and_grads(stack, inputs, targets, forcings, key):
    def loss_fn(m):
      return m.loss(inputs, targets, forcings, key)[0].mean()
    return nnx.value_and_grad(loss_fn)(stack)

  jloss, jgrads = jax_loss_and_grads(
      jstack, *map(jnp.asarray, (inputs, targets, forcings)), key)
  jgrads = {k[len('predictor/'):]: v for k, v in _flat(jgrads).items()}
  for counter in (banded_attention.KERNEL, sparse_attention.KERNEL):
    counter.reset()
  loss, _ = tstack.loss(*map(torch.as_tensor, (inputs, targets, forcings)),
                        **_draws(jmodel, key))
  loss.mean().backward()
  assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
      float(jloss))
  tgrads = bridge.export_reference_grads(tmodel)
  assert sorted(tgrads) == sorted(jgrads)
  for k, w in jgrads.items():
    scale = np.abs(w).max()
    if scale == 0:  # the decoder's unused mesh-node update
      assert np.abs(tgrads[k]).max() == 0, k
      continue
    assert np.abs(tgrads[k] - w).max() <= GRAD_RTOL * scale, k
  assert banded_attention.KERNEL.launches == 0
  assert sparse_attention.KERNEL.launches == 0


@pytest.mark.parametrize('kind', BACKENDS)
def test_cli_trains_and_evaluates_the_einsum_backend(kind, tmp_path, capsys):
  """--preset tiny (the einsum tri-block) and --attention_type dense
  train 2 steps with a checkpoint and evaluate a 2-member ensemble from it
  on the CPU."""
  ckpt = str(tmp_path / 'ckpt')
  argv = ['--preset', 'tiny', '--device', 'cpu']
  if kind == 'dense':
    argv += ['--attention_type', 'dense']
  run = train.main(argv + ['--data', 'synthetic', '--steps', '2',
                           '--ckpt_dir', ckpt])
  ev = evaluate.main(argv + ['--ckpt_dir', ckpt, '--num_members', '2',
                             '--max_rollout_steps', '2', '--out_dir',
                             str(tmp_path / 'eval'), '--plot_vars'])
  out = capsys.readouterr().out
  assert f'attention={kind}' in out
  assert len(run.losses) == 2 and np.isfinite(run.losses).all()
  assert ev.predictions.shape[:2] == (2, 2)
  assert np.isfinite(ev.predictions).all()
  assert set(ev.results) == {'rmse', 'steps', 'members', 'crps', 'spread'}
