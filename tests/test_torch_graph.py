"""The port's carried-over host code against the JAX package: graph statics,
tile and aggregation plans, channel layouts, noise schedules and the
spherical-harmonic basis must be equal, array for array."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import sparse as sp

from gencast_tpu import configs as jax_configs
from gencast_tpu.data import layout as jax_layout
from gencast_tpu.graph import compiler as jax_compiler
from gencast_tpu.models import diffusion_utils as jax_diffusion
from gencast_tpu.nn import gnn as jax_gnn
from gencast_tpu.ops import sparse_attention as jax_sa
from gencast_tpu.ops import sph_harm as jax_sph
from gencast_tpu_torch import configs
from gencast_tpu_torch.data import layout, registry
from gencast_tpu_torch.graph import compiler, plans
from gencast_tpu_torch.models import diffusion_utils
from gencast_tpu_torch.nn import gnn
from gencast_tpu_torch.ops import sph_harm
from tests.torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _assert_same(a, b, what):
  a, b = np.asarray(a), np.asarray(b)
  assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
  np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.fixture(scope='module')
def statics_pair():
  """TINY's statics with both the tri-block mask ([3, 2, 88, 88]) and the
  tile plan."""
  lat, lon = configs.grid_for_resolution(10.0)
  kwargs = dict(attention_k_hop=4, attention_tile_size=32)
  ref = jax_compiler.build_graph_statics(2, lat, lon, cache_dir=None,
                                         **kwargs)
  port = compiler.build_graph_statics(2, lat, lon, build_triblock_mask=True,
                                     **kwargs)
  return ref, port


def test_graph_statics_equal(statics_pair):
  ref, port = statics_pair
  assert port.attention_mask.blocks.shape == (3, 2, 88, 88)
  for field in dataclasses.fields(port):
    mine = getattr(port, field.name)
    theirs = getattr(ref, field.name)
    if dataclasses.is_dataclass(mine):
      for sub in dataclasses.fields(mine):
        _assert_same(getattr(theirs, sub.name), getattr(mine, sub.name),
                     f'{field.name}.{sub.name}')
    else:
      _assert_same(theirs, mine, field.name)


@pytest.mark.parametrize('edge_set', ['grid2mesh', 'mesh2grid'])
@pytest.mark.parametrize('min_degree', [2, 32])
def test_agg_plans_equal(statics_pair, edge_set, min_degree):
  """Same gate decisions, and the port's CSR plan encodes the reference's
  sorted order and permutation."""
  ref, port = statics_pair
  es = getattr(ref, edge_set)
  sets = (('grid', 'mesh') if edge_set == 'grid2mesh' else ('mesh', 'grid'))
  sizes = {'grid': ref.num_grid_nodes, 'mesh': ref.num_mesh_nodes}
  jt = jax_gnn.EdgeTopology('e', *sets, es.senders, es.receivers)
  jt = jt.with_agg_plans(sizes[sets[0]], sizes[sets[1]],
                         min_max_degree=min_degree)
  tt = gnn.EdgeTopology('e', *sets, es.senders, es.receivers)
  tt = tt.with_agg_plans(sizes[sets[0]], sizes[sets[1]],
                         min_max_degree=min_degree)
  for side in ('recv_plan', 'sender_plan'):
    jp, tp = getattr(jt, side), getattr(tt, side)
    assert (jp is None) == (tp is None), side
    if tp is None:
      continue
    _assert_same(jp.segment_ids, tp.segment_ids, side)
    e = tp.num_edges
    assert (jp.perm is None) == (tp.perm is None)
    if tp.perm is not None:
      _assert_same(jp.perm[:e], tp.perm, side)
    sorted_ids = jp.mxu.recv_blocked.reshape(-1)[:e]
    np.testing.assert_array_equal(
        np.searchsorted(sorted_ids, np.arange(tp.num_segments + 1)),
        tp.row_ptr)
  if min_degree == 2:
    # The grid2mesh receiver side is the one the slice plans.
    assert edge_set != 'grid2mesh' or tt.recv_plan is not None


def test_nano_triblock_mask_equal():
  """Nano's statics: the tri-block mask ([3, 4, 656, 656], 62 padding
  nodes, 542,922 allowed entries) and the edge sets."""
  lat, lon = configs.grid_for_resolution(2.5)
  ref = jax_compiler.build_graph_statics(4, lat, lon, attention_k_hop=8,
                                         cache_dir=None)
  port = configs.build_statics(configs.NANO)
  assert port.attention_tile_plan is None
  mask = port.attention_mask
  assert (mask.blocks.shape, mask.block_size, mask.num_padding_nodes) == (
      (3, 4, 656, 656), 656, 62)
  assert int(mask.blocks.sum()) == 542922
  for field in ('blocks', 'block_size', 'num_padding_nodes'):
    _assert_same(getattr(ref.attention_mask, field), getattr(mask, field),
                 field)
  for es in ('grid2mesh', 'mesh_edges', 'mesh2grid'):
    for f in ('senders', 'receivers', 'features'):
      _assert_same(getattr(getattr(ref, es), f), getattr(getattr(port, es), f),
                   f'{es}.{f}')


@pytest.mark.parametrize('n,bandwidth', [(70, 9), (64, 20)])
def test_banded_mask_from_csr_equal(n, bandwidth):
  mask = _random_mask(n, bandwidth, seed=n, explicit_zeros=True)
  ref = jax_compiler._banded_mask_from_csr(mask)
  port = compiler.banded_mask_from_csr(mask)
  for field in ('blocks', 'block_size', 'num_padding_nodes'):
    _assert_same(getattr(ref, field), getattr(port, field), field)


def test_native_helper_is_the_ports_copy():
  """The mesh2grid containing-triangle query builds from the port's own
  source and gives the JAX package's faces, point for point."""
  from gencast_tpu.graph import connectivity as jax_connectivity
  from gencast_tpu.graph import icosahedron as jax_icosahedron
  from gencast_tpu_torch.graph import connectivity, icosahedron, native
  assert native.SOURCE.startswith(os.path.dirname(compiler.__file__))
  assert os.path.exists(native.SOURCE)
  assert native.get_lib() is not None
  lat, lon = configs.grid_for_resolution(10.0)
  points = connectivity.grid_lat_lon_to_xyz(lat, lon).reshape(-1, 3)
  _assert_same(
      jax_connectivity.containing_triangle(
          points, jax_icosahedron.finest_mesh(2)),
      connectivity.containing_triangle(points, icosahedron.finest_mesh(2)),
      'containing triangle')


def _random_mask(n, bandwidth, seed, explicit_zeros=False):
  rng = np.random.default_rng(seed)
  rows = np.repeat(np.arange(n), 6)
  cols = np.clip(rows + rng.integers(-bandwidth, bandwidth + 1, rows.size),
                 0, n - 1)
  data = np.ones(rows.size, bool)
  if explicit_zeros:
    data[::7] = False
  m = sp.csr_matrix((data, (rows, cols)), shape=(n, n))
  m.sum_duplicates()
  return m


@pytest.mark.parametrize('n,bandwidth,tile,zeros', [
    (100, 20, 16, False), (130, 60, 32, False), (96, 10, 8, True)])
def test_tile_plan_equal(n, bandwidth, tile, zeros):
  mask = _random_mask(n, bandwidth, seed=n, explicit_zeros=zeros)
  ref = jax_sa.build_tile_plan(mask, tile=tile)
  port = plans.build_tile_plan(mask, tile=tile)
  for field in dataclasses.fields(port):
    _assert_same(getattr(ref, field.name), getattr(port, field.name),
                 field.name)


@pytest.mark.parametrize('task', ['gencast', 'gencast_full'])
def test_layouts_equal(task):
  jtask = jax_layout.registry.TASKS[task]
  ttask = registry.TASKS[task]
  assert dataclasses.asdict(jtask) == dataclasses.asdict(ttask)

  def layouts(lib, t):
    inp = lib.build_layout(t.input_variables, t.pressure_levels,
                           t.num_input_frames)
    tgt = lib.build_layout(t.target_variables, t.pressure_levels, 1)
    frc = lib.build_layout(t.forcing_variables, t.pressure_levels, 1)
    return inp, tgt, frc

  jl, tl = layouts(jax_layout, jtask), layouts(layout, ttask)
  for a, b in zip(jl, tl):
    assert a.var_names == b.var_names
    for f in ('channel_var', 'channel_time', 'channel_level'):
      _assert_same(getattr(a, f), getattr(b, f), f)
  _assert_same(jax_layout.merge_permutation(jl[2], jl[1])[1],
               layout.merge_permutation(tl[2], tl[1])[1], 'merge')
  _assert_same(jax_layout.residual_channel_map(jl[1], jl[0]),
               layout.residual_channel_map(tl[1], tl[0]), 'residual map')
  rng = np.random.default_rng(0)
  names = sorted(set(ttask.input_variables + ttask.target_variables))
  table = {n: rng.uniform(0.5, 2, (len(ttask.pressure_levels),)
                          if registry.is_atmospheric(n) else ())
           for n in names}
  jst = jax_layout.Stats(table, table, table)
  tst = layout.Stats(table, table, table)
  for f in ('channel_locations', 'channel_scales', 'channel_residual_scales'):
    _assert_same(getattr(jax_layout, f)(jl[1], jst),
                 getattr(layout, f)(tl[1], tst), f)


@pytest.mark.parametrize('deg', [1.0, 10.0])
def test_latitude_weights_and_schedules_equal(deg):
  lat, _ = jax_configs.grid_for_resolution(deg)
  _assert_same(jax_layout.latitude_weights(lat), layout.latitude_weights(lat),
               'latitude weights')
  s = jax_diffusion.noise_schedule(80.0, 0.03, 20, 7.0)
  _assert_same(s, diffusion_utils.noise_schedule(80.0, 0.03, 20, 7.0),
               'schedule')
  _assert_same(
      jax_diffusion.stochastic_churn_rate_schedule(s, 2.5, 0.75, np.inf),
      diffusion_utils.stochastic_churn_rate_schedule(s, 2.5, 0.75, np.inf),
      'churn')


def test_noise_basis_equal():
  lat, lon = configs.grid_for_resolution(10.0)
  ref = jax_sph.basis_for_grid(lat, lon)
  port = sph_harm.basis_for_grid(lat, lon)
  assert ref.max_l == port.max_l
  _assert_same(np.asarray(ref.legendre), port.legendre, 'legendre')
  _assert_same(np.asarray(ref.fourier), port.fourier, 'fourier')


def test_port_imports_without_jax():
  """The port and its card-side check never import jax, flax or the JAX
  package."""
  code = ('import sys\n'
          'for m in ("jax", "flax", "gencast_tpu"): sys.modules[m] = None\n'
          'import gencast_tpu_torch.configs, gencast_tpu_torch.bridge\n'
          'import gencast_tpu_torch.models.wrappers\n'
          'import gencast_tpu_torch.models.casting\n'
          'import gencast_tpu_torch.rollout\n'
          'import gencast_tpu_torch.training.train\n'
          'import gencast_tpu_torch.training.profile_step\n'
          'import chip_smoke\n')
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  done = subprocess.run([sys.executable, '-c', code], cwd=root,
                        capture_output=True, text=True, timeout=120)
  assert done.returncode == 0, done.stderr
