"""The port's analytic FLOP accounting (`gencast_tpu_torch.training.flops`)
against the JAX package's:

1. the exact hand-computed primitive counts of tests/test_flops.py;
2. the port's counts equal to the JAX package's exactly at TINY and NANO
   (the denoiser) and TINY (GraphCast), each from its own package's
   statics;
3. the tile-plan branch of `attention_pairs` (the port's block-sparse
   statics carry no banded mask) equal to the JAX package's count, from
   its banded mask and from its own tile plan, at TINY (the port at tiles
   32 and 64, JAX at 128) and live at ONE_DEG (the port at tile 64, JAX at
   768: the count is of the mask's true entries, not of tiles); ONE_DEG
   also pinned to the JAX package's count;
4. torch.utils.flop_counter's count of a TINY forward, which counts the
   executed matmuls (the einsum tri-block's masked entries too, not the
   GNN sums), just above the analytic model count, as tests/test_flops.py
   bounds it by XLA's cost analysis.
"""

import dataclasses

import flax.nnx as nnx
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gencast_tpu import configs as jax_configs
from gencast_tpu.training import flops as jax_flops
from gencast_tpu_torch import configs
from gencast_tpu_torch.training import flops as F
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)

# ONE_DEG's forward, from the JAX package's formula on its own statics.
ONE_DEG_TRANSFORMER = 1_299_117_047_808
ONE_DEG_GNN = 1_075_569_211_392
ONE_DEG_PAIRS = 8_182_482


def test_mlp_flops_exact():
  # rows=10, widths 4 -> 8 -> 3: 2*10*(4*8 + 8*3) = 1120.
  assert F.mlp_flops(10, [4, 8, 3]) == 1120.0


def test_transformer_flops_exact():
  # N=8, P=16 pairs, D=4, F=6, 2 layers:
  # per layer 8*8*16 + 4*16*4 + 4*8*4*6 = 1024 + 256 + 768 = 2048.
  assert F.transformer_forward_flops(8, 16, 4, 6, 2) == 4096.0


def test_peak_is_the_h100_sxm_dense_bf16():
  assert F.H100_SXM_BF16_DENSE_PEAK_FLOPS == 989.4e12
  assert F.mfu(989.4e12, 2.0) == 0.5
  assert not hasattr(F, 'V5E_PEAK_FLOPS')


@pytest.mark.parametrize('name', ['TINY', 'NANO'])
def test_denoiser_forward_equals_jax(name):
  jspec, spec = getattr(jax_configs, name), getattr(configs, name)
  jstatics = jax_configs.build_statics(jspec, cache_dir=None)
  statics = configs.build_statics(spec, cache_dir=None)
  for batch in (1, 3):
    want = jax_flops.denoiser_forward_flops(jspec, jstatics, batch)
    got = F.denoiser_forward_flops(spec, statics, batch)
    assert (got.transformer, got.gnn) == (want.transformer, want.gnn)
  assert F.attention_pairs(statics) == jax_flops.attention_pairs(jstatics)
  fwd = F.denoiser_forward_flops(spec, statics)
  jfwd = jax_flops.denoiser_forward_flops(jspec, jstatics)
  for ours, theirs in ((F.train_step_flops(fwd),
                        jax_flops.train_step_flops(jfwd)),
                       (F.sampler_step_flops(fwd, 20),
                        jax_flops.sampler_step_flops(jfwd, 20))):
    assert (ours.transformer, ours.gnn) == (theirs.transformer, theirs.gnn)
  assert F.train_step_flops(fwd).total == 3 * fwd.total
  assert F.sampler_step_flops(fwd, 20).total == 39 * fwd.total


def test_graphcast_forward_equals_jax():
  jmodel, jstatics = jax_configs.build_graphcast(
      jax_configs.TINY, rngs=nnx.Rngs(0), cache_dir=None)
  model, statics = configs.build_graphcast(configs.TINY, device='cpu',
                                           cache_dir=None)
  want = jax_flops.graphcast_forward_flops(jax_configs.TINY, jstatics,
                                           task=jmodel.task)
  got = F.graphcast_forward_flops(configs.TINY, statics, task=model.task)
  assert (got.transformer, got.gnn) == (want.transformer, want.gnn)


def _jax_pair_counts(jstatics) -> list:
  """JAX's pair count from its banded mask and from its tile plan alone."""
  assert jstatics.attention_mask is not None
  assert jstatics.attention_tile_plan is not None
  return [jax_flops.attention_pairs(jstatics),
          jax_flops.attention_pairs(
              dataclasses.replace(jstatics, attention_mask=None))]


@pytest.mark.parametrize('tile', [32, 64])
def test_tile_plan_pairs_equal_jax_at_tiny(tile):
  spec = dataclasses.replace(configs.TINY_PALLAS, attention_tile_size=tile)
  statics = configs.build_statics(spec, cache_dir=None)
  assert statics.attention_mask is None
  assert statics.attention_tile_plan.tile == tile
  jspec = dataclasses.replace(jax_configs.TINY, attention_type='pallas',
                              attention_tile_size=128)
  jstatics = jax_configs.build_statics(jspec, cache_dir=None)
  pairs = F.attention_pairs(statics)
  assert _jax_pair_counts(jstatics) == [pairs, pairs]
  for batch in (1, 3):
    want = jax_flops.denoiser_forward_flops(jspec, jstatics, batch)
    got = F.denoiser_forward_flops(spec, statics, batch)
    assert (got.transformer, got.gnn) == (want.transformer, want.gnn)


def test_one_deg_equals_jax_over_the_tile64_plan():
  spec, jspec = configs.ONE_DEG, jax_configs.ONE_DEG
  statics = configs.build_statics(spec)
  jstatics = jax_configs.build_statics(jspec, cache_dir=None)
  assert statics.attention_mask is None
  assert (statics.attention_tile_plan.tile,
          jstatics.attention_tile_plan.tile) == (64, 768)
  pairs = F.attention_pairs(statics)
  assert _jax_pair_counts(jstatics) == [pairs, pairs]
  want = jax_flops.denoiser_forward_flops(jspec, jstatics)
  got = F.denoiser_forward_flops(spec, statics)
  assert (got.transformer, got.gnn) == (want.transformer, want.gnn)


def test_one_deg_pinned_over_the_tile64_plan():
  spec = configs.ONE_DEG
  statics = configs.build_statics(spec)
  plan = statics.attention_tile_plan
  assert statics.attention_mask is None and plan.tile == 64
  assert F.attention_pairs(statics) == ONE_DEG_PAIRS
  fwd = F.denoiser_forward_flops(spec, statics)
  assert (fwd.transformer, fwd.gnn) == (ONE_DEG_TRANSFORMER, ONE_DEG_GNN)
  assert fwd.total == 2_374_686_259_200


def _counted(fn) -> float:
  with torch.no_grad(), FlopCounterMode(display=False) as counter:
    fn()
  return float(counter.get_total_flops())


def test_denoiser_forward_bounded_by_flop_counter():
  """FlopCounterMode counts the executed matmuls: the analytic model count
  plus the tri-block's masked entries and the FiLM projections, without
  the GNN sums. Measured ratio 1.088 at TINY (the einsum 'triblock')."""
  spec = configs.TINY
  model, statics = configs.build_gencast(spec, seed=0, device='cpu')
  analytic = F.denoiser_forward_flops(spec, statics).total
  d = model.denoiser
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  x = [torch.zeros(grid + (lay.num_channels,))
       for lay in (d.input_layout, d.target_layout, d.forcing_layout)]
  counted = _counted(lambda: model(x[0], x[1], torch.ones(1), x[2]))
  assert analytic <= counted <= 1.35 * analytic, (analytic, counted)


def test_graphcast_forward_bounded_by_flop_counter():
  """As above for GraphCast at TINY: no attention and no FiLM, so the
  executed matmuls are the model's; measured ratio 1.000 (equal counts)."""
  model, statics = configs.build_graphcast(configs.TINY, device='cpu')
  analytic = F.graphcast_forward_flops(configs.TINY, statics,
                                       task=model.task).total
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.zeros(grid + (model.input_layout.num_channels,))
  forcings = torch.zeros(grid + (model.forcing_layout.num_channels,))
  counted = _counted(lambda: model.predict(inputs, forcings))
  assert analytic <= counted <= 1.35 * analytic, (analytic, counted)
