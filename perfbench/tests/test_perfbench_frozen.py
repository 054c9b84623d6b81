"""The benchmark's frozen copies agree with the program's originals today:
the graph construction, the FLOP count, the kernel families and the bound
arithmetic (the originals may change later; the copies may not)."""

import os

import numpy as np
import pytest
import torch

from perfbench.lib import families, flops, harness, roofline
from perfbench.reference import graph as graph_lib
from perfbench.reference import layout as layout_lib

TINY = harness.read_json(os.path.join(harness.BENCH_DIR, 'tests', 'data',
                                      'configs', 'tiny.json'))


@pytest.fixture(scope='module')
def port_statics():
  from gencast_tpu_torch.graph import compiler
  lat, lon = graph_lib.grid_for_resolution(TINY['resolution_deg'])
  return compiler.build_graph_statics(
      TINY['mesh_splits'], lat, lon,
      attention_k_hop=TINY['attention_k_hop'],
      attention_tile_size=TINY['attention_tile_size'], cache_dir=None)


@pytest.fixture(scope='module')
def graph(tmp_path_factory):
  return graph_lib.build(TINY['resolution_deg'], TINY['mesh_splits'],
                         TINY['attention_k_hop'], 0.6,
                         build_dir=str(tmp_path_factory.mktemp('native')))


def test_graph_is_the_programs(graph, port_statics):
  from gencast_tpu_torch.graph import compiler
  st = port_statics
  for ours, theirs in ((graph.grid2mesh, st.grid2mesh),
                       (graph.mesh2grid, st.mesh2grid)):
    assert np.array_equal(ours.senders, theirs.senders)
    assert np.array_equal(ours.receivers, theirs.receivers)
    assert np.array_equal(ours.features, theirs.features)
  assert np.array_equal(graph.grid_features, st.grid_node_features)
  assert np.array_equal(graph.mesh_features, st.mesh_node_features)
  mask = compiler.khop_mask_csr(st.mesh_edges.senders, st.mesh_edges.receivers,
                                st.num_mesh_nodes, TINY['attention_k_hop'])
  assert graph.attention_pairs == mask.nnz


def test_flops_are_the_programs(graph, port_statics):
  from gencast_tpu_torch.training import flops as port
  from perfbench.lib import program
  spec = program.spec(TINY)
  for batch in (1, 3):
    want = port.denoiser_forward_flops(spec, port_statics, batch).total
    assert flops.denoiser_forward(TINY, graph, batch) == pytest.approx(
        want, rel=1e-12)
  one = port.denoiser_forward_flops(spec, port_statics, 2)
  assert flops.forecast_step(TINY, graph, 2) == pytest.approx(
      port.sampler_step_flops(one, spec.num_noise_levels).total, rel=1e-12)
  assert flops.train_step(TINY, graph) == pytest.approx(
      port.train_step_flops(port.denoiser_forward_flops(
          spec, port_statics)).total, rel=1e-12)
  assert (flops.H100_SXM_BF16_DENSE_PEAK_FLOPS
          == port.H100_SXM_BF16_DENSE_PEAK_FLOPS)


def test_families_are_the_programs():
  from gencast_tpu_torch.training import profile_step
  assert families.FAMILIES == profile_step._FAMILIES
  for name in ('void sparse_attention_fwd_mma_kernel<128>',
               'sparse_attention_dkv_mma_kernel', 'nvjet_tst_128x64',
               'vectorized_elementwise_kernel<4>', 'segment_sum_kernel',
               'something else'):
    assert families.family(name) == profile_step.family(name)


def test_bound_is_chip_smokes():
  import chip_smoke
  for ops, moved in ((1e12, 1e9), (1e9, 1e10), (3.3e10, 7.7e7)):
    for bf16, dtype in ((True, torch.bfloat16), (False, torch.float32)):
      ms, binds = chip_smoke.bound(ops, moved, dtype)
      assert 1e3 * roofline.bound_s(ops, moved, bf16) == pytest.approx(
          ms, rel=1e-12)
      assert roofline.binds(ops, moved, bf16) == binds


def test_attention_costs():
  """Operations as chip_smoke counts them for A and F (4, 6 and 8 d a
  head and allowed entry); bytes each operand once."""
  c = roofline.attention_costs(batch=2, nodes=10, heads=4, head_dim=8,
                               pairs=30)
  assert c['A'][0] == 4 * 8 * 30 * 4 * 2
  assert c['F-dq'][0] == 6 * 8 * 30 * 4 * 2
  assert c['F-dk/dv'][0] == 8 * 8 * 30 * 4 * 2
  t = 2 * 10 * 4 * 8 * 2
  assert c['A'][1] == 4 * t + 2 * 4 * 10 * 4


def test_layout_is_the_programs():
  from gencast_tpu_torch.data import layout as port
  from gencast_tpu_torch.data import registry
  from gencast_tpu_torch.models import gencast
  from perfbench.lib import program, synthetic
  task = program.spec(TINY).task
  ours = layout_lib.task(TINY)
  ins = port.build_layout(task.input_variables, task.pressure_levels, 2)
  tgt = port.build_layout(task.target_variables, task.pressure_levels, 1)
  frc = port.build_layout(task.forcing_variables, task.pressure_levels, 1)
  assert np.array_equal(ours.inputs.var, ins.channel_var)
  assert np.array_equal(ours.inputs.level, ins.channel_level)
  _, perm = port.merge_permutation(frc, tgt)
  assert np.array_equal(ours.cond_perm, perm)
  stats = synthetic.stats(TINY, 2 ** 32 + 5)
  st = port.Stats(**stats)
  norm = layout_lib.normalization(ours, stats)
  assert np.array_equal(norm.in_scale, port.channel_scales(ins, st))
  assert np.array_equal(norm.residual_from,
                        port.residual_channel_map(tgt, ins))
  want, _ = port.loss_channel_weights(tgt, gencast.LOSS_WEIGHTS_SURFACE)
  assert np.allclose(layout_lib.loss_weights(ours.targets), want, rtol=1e-6)
  lat, _ = graph_lib.grid_for_resolution(1.0)
  assert np.allclose(layout_lib.latitude_weights(lat),
                     port.latitude_weights(lat), rtol=1e-6)
  assert registry.GENCAST_TASK_FULL.input_variables == task.input_variables
