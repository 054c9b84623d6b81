"""The port's GenCast training step against the JAX package, on CPU.

TINY at d_model 128 (so the JAX LN+FiLM gate, which needs C % 128 == 0,
takes its Pallas backward under GENCAST_FUSED_LN_FILM=1), with the
block-sparse ('pallas') attention at tile 32 and aggregation plans gated at
max degree 2: every kernel of the port's training path (A, B, E, F) and
every Pallas kernel it replaces (interpret mode) is on the path. Weights
are perturbed (a fresh model's zero output projections would give the
attention a zero cotangent). The JAX model draws sigma and the noise from
its key; the port gets the same draws injected.
"""

import dataclasses

import flax.nnx as nnx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import diffusion_utils as jax_diffusion
from gencast_tpu.models import gencast as jax_gencast
from gencast_tpu.models import wrappers as jax_wrappers
from gencast_tpu.models.denoiser import DenoiserConfig as JaxDenoiserConfig
from gencast_tpu.nn.transformer import TransformerConfig as JaxTransformer
from gencast_tpu.training import steps as jax_steps
from gencast_tpu_torch import bridge, configs
from gencast_tpu_torch.data import layout
from gencast_tpu_torch.models import casting, wrappers
from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
from gencast_tpu_torch.training import steps, train

SPEC = dataclasses.replace(configs.TINY, d_model=128, attention_tile_size=32,
                           use_agg_plans=True, agg_plan_min_degree=2)
# 'full' is TINY's remat policy; 'save_attention' is ONE_DEG's.
REMAT_POLICIES = ('full', 'save_attention')

# Loss, max relative difference: float32 on both sides, one denoiser call.
LOSS_RTOL = 1e-5
# Gradients, per parameter: max|port - jax| <= GRAD_RTOL * max|jax|.
# float32 through two GNNs and two attention layers, with the attention
# and LN+FiLM backwards and the planned sums in other summation orders.
GRAD_RTOL = 2e-4
# Parameter updates after 3 AdamW steps, per parameter:
# max|dp_port - dp_jax| <= STEP_RTOL * max|dp_jax|. Adam divides each
# gradient by its own running RMS, so a gradient entry near zero carries
# its relative float32 noise into a full-size update.
STEP_RTOL = 2e-2
# bf16 stack against the float32 gradients, per parameter, relative to the
# largest float32 gradient entry: bf16 activations and weights.
BF16_GRAD_RTOL = 0.1


def _stats(task, seed):
  rng = np.random.default_rng(seed)
  names = sorted(set(task.input_variables + task.target_variables
                     + task.forcing_variables))
  nl = len(task.pressure_levels)

  def table(lo, hi):
    return {n: rng.uniform(lo, hi, (nl,) if n in
                           layout.registry.ALL_ATMOSPHERIC_VARS else ())
            for n in names}
  mean, std, diffs = table(-1, 1), table(0.5, 2), table(0.5, 2)
  return jax_layout.Stats(mean, std, diffs), layout.Stats(mean, std, diffs)


def _jax_model(statics, remat_policy='full'):
  return jax_gencast.GenCast(
      SPEC.task, statics,
      JaxTransformer(d_model=SPEC.d_model, num_layers=SPEC.num_layers,
                     num_heads=SPEC.num_heads, ffw_hidden=SPEC.ffw_hidden,
                     attention_type='pallas',
                     use_gradient_checkpointing=True,
                     remat_policy=remat_policy),
      denoiser_config=JaxDenoiserConfig(
          latent_size=SPEC.d_model, use_agg_plans=True,
          agg_plan_min_degree=SPEC.agg_plan_min_degree),
      rngs=nnx.Rngs(0))


def _flat(state):
  return {'/'.join(map(str, p)): np.asarray(v.get_value())
          for p, v in nnx.to_flat_state(state)}


@pytest.fixture(scope='module')
def setup():
  lat, lon = jax_configs.grid_for_resolution(SPEC.resolution_deg)
  jstatics = jax_compiler.build_graph_statics(
      SPEC.mesh_splits, lat, lon, attention_k_hop=SPEC.attention_k_hop,
      attention_tile_size=SPEC.attention_tile_size,
      build_triblock_mask=False)
  flat = bridge.perturbed(_flat(nnx.state(_jax_model(jstatics), nnx.Param)),
                          seed=7)
  statics = configs.build_statics(SPEC)
  jstats, tstats = _stats(SPEC.task, seed=3)
  tmodel, _ = configs.build_gencast(SPEC, seed=1, statics=statics)
  d = tmodel.denoiser
  rng = np.random.default_rng(0)
  shape = (1, lat.shape[0], lon.shape[0])
  data = {
      'inputs': rng.standard_normal(shape + (d.input_layout.num_channels,)),
      'targets': rng.standard_normal(shape + (d.target_layout.num_channels,)),
      'forcings': rng.standard_normal(
          shape + (d.forcing_layout.num_channels,)),
  }
  data = {k: v.astype(np.float32) for k, v in data.items()}
  return dict(jstatics=jstatics, statics=statics, flat=flat, jstats=jstats,
              tstats=tstats, data=data)


def _pair(setup, remat_policy='full'):
  """Fresh JAX and port stacks (InputsAndResiduals, float32) holding the
  same perturbed weights, both with `remat_policy`."""
  jmodel = _jax_model(setup['jstatics'], remat_policy)
  flat_state = nnx.to_flat_state(nnx.state(jmodel, nnx.Param))
  nnx.update(jmodel, nnx.from_flat_state(
      [(p, v.replace(jnp.asarray(setup['flat']['/'.join(map(str, p))])))
       for p, v in flat_state]))
  tmodel, _ = configs.build_gencast(
      dataclasses.replace(SPEC, remat_policy=remat_policy), seed=1,
      statics=setup['statics'])
  bridge.load_reference_params(tmodel, setup['flat'])
  return (jmodel, jax_wrappers.build_stack(jmodel, setup['jstats'],
                                           bf16=False),
          tmodel, wrappers.build_stack(tmodel, setup['tstats'], bf16=False))


def _draws(jmodel, key):
  """The sigma and noise the JAX loss draws from `key`, as torch tensors."""
  nc = jmodel.noise_config
  k_sigma, k_noise = jax.random.split(key)
  sigma = jax_diffusion.rho_inverse_cdf(
      nc.training_min_noise_level, nc.training_max_noise_level,
      nc.training_noise_level_rho,
      jax.random.uniform(k_sigma, (1,), dtype=jnp.float32))
  noise = jmodel._sphere_noise(k_noise, 1, jnp.float32)
  return {'sigma': torch.as_tensor(np.array(sigma)),
          'noise': torch.as_tensor(np.array(noise))}


def _batch(data, framework):
  if framework == 'jax':
    return [jnp.asarray(data[k]) for k in ('inputs', 'targets', 'forcings')]
  return [torch.as_tensor(data[k]) for k in ('inputs', 'targets', 'forcings')]


@pytest.mark.parametrize('remat_policy', REMAT_POLICIES)
def test_loss_and_gradients_match_jax(setup, monkeypatch, remat_policy):
  monkeypatch.setenv('GENCAST_FUSED_LN_FILM', '1')
  jmodel, jstack, tmodel, tstack = _pair(setup, remat_policy)
  key = jax.random.PRNGKey(5)

  @nnx.jit
  def jax_loss_and_grads(stack, inputs, targets, forcings, key):
    def loss_fn(m):
      loss, diags = m.loss(inputs, targets, forcings, key)
      return loss.mean(), diags
    return nnx.value_and_grad(loss_fn, has_aux=True)(stack)

  (jloss, jdiags), jgrads = jax_loss_and_grads(
      jstack, *_batch(setup['data'], 'jax'), key)
  jgrads = {k[len('predictor/'):]: v for k, v in _flat(jgrads).items()}

  for counter in (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
                  sparse_attention.KERNEL_DKV, segment.KERNEL,
                  ln_film.KERNEL):
    counter.reset()
  loss, diags = tstack.loss(*_batch(setup['data'], 'torch'),
                            **_draws(jmodel, key))
  loss.mean().backward()
  assert abs(float(loss.detach()) - float(jloss)) <= LOSS_RTOL * abs(
      float(jloss))
  for k in jdiags:
    np.testing.assert_allclose(diags[k].detach().numpy(),
                               np.asarray(jdiags[k]), rtol=1e-4)

  tgrads = bridge.export_reference_grads(tmodel)
  assert sorted(tgrads) == sorted(jgrads)
  dead = []
  for k, want in jgrads.items():
    got, scale = tgrads[k], np.abs(want).max()
    if scale == 0:  # the decoder's unused mesh-node update
      assert np.abs(got).max() == 0, k
      dead.append(k)
      continue
    assert np.abs(got - want).max() <= GRAD_RTOL * scale, k
  assert len(dead) == 6, dead
  # On the CPU no kernel is launched: the plain versions ran instead.
  assert all(c.launches == 0 for c in (
      sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
      sparse_attention.KERNEL_DKV, segment.KERNEL, ln_film.KERNEL))


def test_three_adamw_steps_match_optax(setup, monkeypatch):
  monkeypatch.setenv('GENCAST_FUSED_LN_FILM', '1')
  jmodel, jstack, tmodel, tstack = _pair(setup)
  before = bridge.export_reference_params(tmodel)
  config = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)
  jopt = jax_steps.create_optimizer(
      jstack, jax_steps.OptimizerConfig(**config))
  topt = steps.create_optimizer(tstack, steps.OptimizerConfig(**config))
  keys = [jax.random.PRNGKey(20 + i) for i in range(3)]
  jlosses, tlosses = [], []
  for key in keys:
    jloss, _ = jax_steps.train_step(jstack, jopt,
                                    *_batch(setup['data'], 'jax'), key)
    tloss, _ = steps.train_step(tstack, topt,
                                *_batch(setup['data'], 'torch'),
                                **_draws(jmodel, key))
    jlosses.append(float(jloss))
    tlosses.append(float(tloss))
  np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
  want = _flat(nnx.state(jmodel, nnx.Param))
  got = bridge.export_reference_params(tmodel)
  for k in want:
    moved = want[k] - before[k]
    assert np.abs(moved).max() > 0, k  # weight decay moves every parameter
    assert (np.abs((got[k] - before[k]) - moved).max()
            <= STEP_RTOL * np.abs(moved).max()), k


@pytest.mark.parametrize('remat_policy', REMAT_POLICIES)
def test_bf16_stack_gradients_reach_f32_masters(setup, remat_policy):
  """Bfloat16Cast.loss runs in bf16 with parameters cast inside the autograd
  graph: the float32 master parameters get gradients, near the float32
  stack's. Under either remat policy the backward's recomputation binds the
  bf16 casts the forward saw."""
  _, _, tmodel, f32_stack = _pair(setup, remat_policy)
  bf16_stack = wrappers.build_stack(tmodel, setup['tstats'], bf16=True)
  assert any(isinstance(m, casting.Bfloat16Cast) for m in bf16_stack.modules())
  draws = _draws(_jax_model(setup['jstatics']), jax.random.PRNGKey(9))
  batch = _batch(setup['data'], 'torch')
  f32_stack.loss(*batch, **draws)[0].mean().backward()
  want = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
          for n, p in tmodel.named_parameters()}
  tmodel.zero_grad()
  loss, diags = bf16_stack.loss(*batch, **draws)
  assert loss.dtype == torch.float32 and torch.isfinite(loss).all()
  assert all(v.dtype == torch.float32 for v in diags.values())
  loss.mean().backward()
  live = 0
  for n, p in tmodel.named_parameters():
    scale = float(want[n].abs().max())
    if scale == 0:  # the decoder's unused mesh-node update
      continue
    live += 1
    assert p.grad is not None and p.grad.dtype == torch.float32, n
    assert float((p.grad - want[n]).abs().max()) <= BF16_GRAD_RTOL * scale, n
  assert live == sum(1 for _ in tmodel.parameters()) - 6


def test_train_cli_tiny_on_cpu():
  run = train.main(['--preset', 'tiny', '--steps', '3', '--data',
                    'synthetic'])
  assert len(run.losses) == 3 and np.isfinite(run.losses).all()
  assert len(run.step_seconds) == 3


@pytest.mark.parametrize('argv,match', [
    (['--preset', 'nano'], 'Nano'),
    (['--preset', '0.25deg'], '0.25 degree'),
    (['--data', '/some/era5'], 'ERA5'),
])
def test_train_cli_rejects_what_is_not_ported(argv, match, capsys):
  with pytest.raises(SystemExit):
    train.parse_args(['--preset', 'tiny'] + argv)
  assert match in capsys.readouterr().err
