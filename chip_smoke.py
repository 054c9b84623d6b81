"""Card-side check of the PyTorch/CUDA port: 1-degree GenCast serving.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. setup: card name and power limit, build of the CUDA kernels;
  2. statics: the 1-degree graph, attention tile plan and aggregation plans;
  3. kernel A (block-sparse attention) against its plain PyTorch version at
     the 1-degree shapes (the mesh's n and the transformer's padded n),
     float32 and bfloat16, with timings;
  4. kernel B (planned segment sum) against its plain version on the
     1-degree grid2mesh receiver plan, with timings;
  5. the ONE_DEG denoiser (random seeded weights, perturbed, bf16 stack)
     through the kernels against the same call through the plain path, and
     a small (TINY, float32) forecast on the card against the CPU;
  6. serving: two forecast requests of one 12-hour step (39 denoiser calls
     each), with kernel launch counts checked;
then one JSON line of kernel results, the card's name and power limit, and
a last JSON line {"ok": true, "device": {...}}.

TF32 is off for matmuls and cuDNN: float32 products run in full float32.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

# Tolerances, each with its reason.
# Kernel A, float32: the same f32 arithmetic in another summation order.
ATTN_F32_ATOL = 1e-4
# Kernel A, bf16: the kernel rounds the probabilities to bf16 before P.V (as
# the reference kernel); the plain version stays f32 until the output.
ATTN_BF16_ATOL = 2e-2
# Kernel B, float32 sums in another order (the plain index_add_ uses atomics).
SEGMENT_RTOL = 1e-5
# Denoiser, bf16 stack, max|kernels - plain| / max|plain|: the two attention
# paths differ by bf16 roundings of the probabilities, and 16 bf16 layers
# carry a flipped rounding onward.
DENOISER_BF16_RTOL = 5e-2
# TINY float32 forecast (3 denoiser calls), card kernels vs CPU plain path.
TINY_SAMPLE_RTOL = 1e-3


def log(*args):
  print(*args, flush=True)


def card_line() -> str:
  done = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return done.stdout.strip().splitlines()[0]


def time_in_turns(fns, reps):
  """ms per call of each fn, timed with CUDA events in the order
  plain, kernel, kernel, plain (the mean of both turns)."""
  names = list(fns)
  order = names + names[::-1]
  samples = {n: [] for n in names}
  for n in names:
    fns[n]()  # warm-up
  torch.cuda.synchronize()
  for n in order:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
      fns[n]()
    end.record()
    torch.cuda.synchronize()
    samples[n].append(start.elapsed_time(end) / reps)
  return {n: float(np.mean(v)) for n, v in samples.items()}


def check_attention(shape, dtype, atol, mt, ids, pids, tile, g):
  """Kernel A against its plain version on seeded q/k/v [1, *shape]:
  returns (max abs err, {'kernel': ms, 'plain': ms})."""
  from gencast_tpu_torch.ops import sparse_attention
  q, k, v = (torch.randn((1,) + shape, generator=g, device=mt.device)
             .to(dtype) for _ in range(3))
  plain = sparse_attention.sparse_banded_attention_plain(
      q, k, v, mt, ids, pids, tile)
  got, lse = sparse_attention.sparse_attention_fwd_cuda(
      q, k, v, mt, ids, pids, tile)
  torch.cuda.synchronize()
  err = float((got.float() - plain.float()).abs().max())
  if not (err <= atol and torch.isfinite(lse).all()):
    raise AssertionError(f'kernel A {dtype} {shape}: max abs err {err} > '
                         f'{atol}')
  ms = time_in_turns({
      'plain': lambda: sparse_attention.sparse_banded_attention_plain(
          q, k, v, mt, ids, pids, tile),
      'kernel': lambda: sparse_attention.sparse_attention_fwd_cuda(
          q, k, v, mt, ids, pids, tile)}, reps=10)
  log(f'[kernel A] {dtype} [1, {", ".join(map(str, shape))}]: max abs err '
      f'{err:.3e} (tol {atol}); kernel {ms["kernel"]:.3f} ms, plain '
      f'{ms["plain"]:.3f} ms per layer call')
  return err, ms


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs on the card only',
          file=sys.stderr)
    return 1
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.graph import plans
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import cuda_lib, segment, sparse_attention

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = card_line()
  results = {}

  # --- 1. setup ---
  log(f'[setup] {card}; torch {torch.__version__}, CUDA {torch.version.cuda};'
      ' TF32 off for matmul and cuDNN')
  cuda_lib.library()
  log(f'[setup] kernels built in {cuda_lib.LIBRARY.build_seconds:.2f} s')
  entry = ''
  for line in cuda_lib.LIBRARY.compiler_log.splitlines():
    m = re.search(r'(sparse_attention_fwd_kernel|segment_sum_kernel)'
                  r'(?:I(.*?)EEv)?', line)
    if 'Compiling entry function' in line and m:
      entry = m.group(1) + (f'<{m.group(2)}>' if m.group(2) else '')
    elif 'registers' in line or ('spill' in line
                                 and ' 0 bytes spill stores' not in line):
      log(f'[setup] ptxas {entry}: {line.split(":", 1)[-1].strip()}')

  # --- 2. statics ---
  spec = configs.ONE_DEG
  t0 = time.perf_counter()
  statics = configs.build_statics(spec)
  plan = statics.attention_tile_plan
  log(f'[statics] {spec.name}: {time.perf_counter() - t0:.1f} s; mesh '
      f'{statics.num_mesh_nodes} nodes, grid {statics.num_grid_nodes} nodes,'
      f' grid2mesh {statics.grid2mesh.num_edges} edges, mesh2grid '
      f'{statics.mesh2grid.num_edges} edges; tile plan tile {plan.tile}: '
      f'{plan.num_q_tiles} q tiles x {plan.num_active_fwd} slots, '
      f'{plan.num_pairs} mask-tile pairs')
  g2m_plan = plans.plan_if_profitable(
      statics.grid2mesh.receivers, statics.num_mesh_nodes,
      min_max_degree=spec.agg_plan_min_degree)
  log(f'[statics] grid2mesh receiver plan: {g2m_plan.num_segments} segments,'
      f' max degree {g2m_plan.max_degree}, perm '
      f'{"yes" if g2m_plan.perm is not None else "no"}')

  # --- 3. kernel A vs plain ---
  # At the mesh's n, and at the plan's padded_n, the shape the transformer
  # gives the kernel (its padded rows carry values after the first layer,
  # so they are random here too: the mask must hide them).
  n, h = statics.num_mesh_nodes, spec.num_heads
  d = spec.d_model // h
  mt = torch.as_tensor(plan.mask_tiles, device=dev)
  ids = torch.as_tensor(plan.fwd_kv_ids, device=dev)
  pids = torch.as_tensor(plan.fwd_pair_ids, device=dev)
  g = torch.Generator(device=dev).manual_seed(0)
  for rows in (n, plan.padded_n):
    for dtype, atol in ((torch.float32, ATTN_F32_ATOL),
                        (torch.bfloat16, ATTN_BF16_ATOL)):
      results[('A', dtype, rows)] = check_attention(
          (rows, h, d), dtype, atol, mt, ids, pids, plan.tile, g)

  # --- 4. kernel B vs plain ---
  e, f = statics.grid2mesh.num_edges, spec.d_model
  data = torch.randn(e, f, generator=g, device=dev)
  row_ptr = torch.as_tensor(g2m_plan.row_ptr, device=dev)
  perm = (None if g2m_plan.perm is None
          else torch.as_tensor(g2m_plan.perm, device=dev))
  plain = segment.planned_segment_sum_plain(data, row_ptr, perm)
  got = segment.planned_segment_sum_cuda(data, row_ptr, perm)
  torch.cuda.synchronize()
  rel = float((got - plain).abs().max() / plain.abs().max())
  if not rel <= SEGMENT_RTOL:
    raise AssertionError(f'kernel B: relative err {rel} > {SEGMENT_RTOL}')
  ms = time_in_turns({
      'plain': lambda: segment.planned_segment_sum_plain(data, row_ptr, perm),
      'kernel': lambda: segment.planned_segment_sum_cuda(data, row_ptr, perm)},
      reps=20)
  log(f'[kernel B] float32 [{e}, {f}] -> [{g2m_plan.num_segments}, {f}]: '
      f'relative err {rel:.3e} (tol {SEGMENT_RTOL}); kernel '
      f'{ms["kernel"]:.3f} ms, plain {ms["plain"]:.3f} ms')
  max_abs_b = float((got - plain).abs().max())
  results['B'] = (max_abs_b, ms)
  del got, plain, data

  # --- 5. denoiser: kernel path vs plain path; small forecast vs CPU ---
  t0 = time.perf_counter()
  model, _ = configs.build_gencast(spec, seed=0, statics=statics, device=dev)
  flat = bridge.perturbed(bridge.export_reference_params(model), seed=1)
  bridge.load_reference_params(model, flat)
  plain_model, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                         device=dev, use_kernels=False)
  bridge.load_reference_params(plain_model, flat)
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=spec.cast_bf16).to(dev)
  plain_stack = wrappers.build_stack(plain_model, stats,
                                     bf16=spec.cast_bf16).to(dev)
  num_params = sum(p.numel() for p in model.parameters())
  log(f'[denoiser] built two {spec.name} models ({num_params} parameters '
      f'each, seeded and perturbed) in {time.perf_counter() - t0:.1f} s')

  den = model.denoiser
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.randn(grid + (den.input_layout.num_channels,), generator=g,
                       device=dev)
  forcings = torch.randn(grid + (den.forcing_layout.num_channels,),
                         generator=g, device=dev)
  noisy = torch.randn(grid + (den.target_layout.num_channels,), generator=g,
                      device=dev) * 3.0
  sigma = torch.full((1,), 3.0, device=dev)
  with torch.no_grad():
    for counter in (sparse_attention.KERNEL, segment.KERNEL):
      counter.reset()
    out_k = stack(inputs, noisy, sigma, forcings)
    torch.cuda.synchronize()
    launched = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
    if launched != (spec.num_layers, 1):
      raise AssertionError(f'denoiser call launched {launched}, expected '
                           f'({spec.num_layers}, 1)')
    out_p = plain_stack(inputs, noisy, sigma, forcings)
    torch.cuda.synchronize()
    rel = float((out_k - out_p).abs().max() / out_p.abs().max())
    mean_rel = float((out_k - out_p).abs().mean() / out_p.abs().mean())
    if not (torch.isfinite(out_k).all() and rel <= DENOISER_BF16_RTOL):
      raise AssertionError(f'denoiser kernels vs plain: {rel} > '
                           f'{DENOISER_BF16_RTOL} or not finite')
    ms = time_in_turns({
        'plain': lambda: plain_stack(inputs, noisy, sigma, forcings),
        'kernel': lambda: stack(inputs, noisy, sigma, forcings)}, reps=3)
  log(f'[denoiser] bf16 {tuple(out_k.shape)}: max rel err {rel:.3e} (tol '
      f'{DENOISER_BF16_RTOL}), mean rel err {mean_rel:.3e}; kernel path '
      f'{ms["kernel"]:.2f} ms, plain path {ms["plain"]:.2f} ms per call')
  denoiser_ms = ms
  del out_k, out_p, plain_stack, plain_model

  tiny = dataclasses.replace(configs.TINY, attention_tile_size=64,
                             use_agg_plans=True, agg_plan_min_degree=2,
                             stochastic_churn_rate=2.5, num_noise_levels=2)
  tiny_cpu, _ = configs.build_gencast(tiny, seed=3)
  bridge.load_reference_params(tiny_cpu, bridge.perturbed(
      bridge.export_reference_params(tiny_cpu), seed=4))
  tiny_gpu, _ = configs.build_gencast(tiny, seed=3, device=dev)
  tiny_gpu.load_state_dict(tiny_cpu.state_dict())
  cpu_gen = torch.Generator().manual_seed(5)
  tgrid = (1, tiny_cpu.denoiser.num_lat, tiny_cpu.denoiser.num_lon)
  t_in = torch.randn(tgrid + (tiny_cpu.denoiser.input_layout.num_channels,),
                     generator=cpu_gen)
  t_frc = torch.randn(
      tgrid + (tiny_cpu.denoiser.forcing_layout.num_channels,),
      generator=cpu_gen)
  t_noise = [tiny_cpu.sphere_noise(cpu_gen, 1)
             for _ in range(tiny.num_noise_levels + 1)]
  want = tiny_cpu.sample(t_in, t_frc, noise=t_noise)
  for counter in (sparse_attention.KERNEL, segment.KERNEL):
    counter.reset()
  got = tiny_gpu.sample(t_in.to(dev), t_frc.to(dev), noise=t_noise).cpu()
  calls = 2 * tiny.num_noise_levels - 1
  launched = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
  rel = float((got - want).abs().max() / want.abs().max())
  if not (rel <= TINY_SAMPLE_RTOL and torch.isfinite(got).all()
          and launched == (calls * tiny.num_layers, calls)):
    raise AssertionError(f'tiny forecast card vs CPU: rel err {rel}, '
                         f'launches {launched}')
  log(f'[denoiser] tiny f32 forecast ({calls} calls), card kernels vs CPU '
      f'plain path: max rel err {rel:.3e} (tol {TINY_SAMPLE_RTOL})')

  # --- 6. serving: two forecast requests ---
  calls = 2 * spec.num_noise_levels - 1
  for counter in (sparse_attention.KERNEL, segment.KERNEL):
    counter.reset()
  seconds = []
  for seed in (1, 2):
    before = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecast = stack.sample(inputs, forcings, gen)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    added = (sparse_attention.KERNEL.launches - before[0],
             segment.KERNEL.launches - before[1])
    expected_shape = grid + (den.target_layout.num_channels,)
    if (tuple(forecast.shape) != expected_shape
        or forecast.dtype != torch.float32
        or not torch.isfinite(forecast).all()):
      raise AssertionError(f'forecast {seed}: {tuple(forecast.shape)} '
                           f'{forecast.dtype}, finite '
                           f'{bool(torch.isfinite(forecast).all())}')
    if added != (calls * spec.num_layers, calls):
      raise AssertionError(f'forecast {seed}: launches {added}, expected '
                           f'{(calls * spec.num_layers, calls)}')
    log(f'[serve] request {seed}: {tuple(forecast.shape)} float32, finite; '
        f'{seconds[-1]:.2f} s ({1e3 * seconds[-1] / calls:.1f} ms per '
        f'denoiser call); launches A {added[0]}, B {added[1]}')
  serve_launches = {'A': sparse_attention.KERNEL.launches,
                    'B': segment.KERNEL.launches}
  if min(serve_launches.values()) == 0:
    raise AssertionError(f'a kernel was not launched: {serve_launches}')

  # Kernel A's row: bf16 at padded_n, the dtype and shape serving runs.
  err_a, ms_a = results[('A', torch.bfloat16, plan.padded_n)]
  err_b, ms_b = results['B']
  kernels = [
      {'name': sparse_attention.KERNEL.name, 'route': 'cuda',
       'source': sparse_attention.KERNEL.source,
       'replaces': sparse_attention.KERNEL.replaces,
       'launches': serve_launches['A'], 'max_abs_err': err_a,
       'ms': ms_a['kernel'], 'plain_ms': ms_a['plain']},
      {'name': segment.KERNEL.name, 'route': 'cuda',
       'source': segment.KERNEL.source, 'replaces': segment.KERNEL.replaces,
       'launches': serve_launches['B'], 'max_abs_err': err_b,
       'ms': ms_b['kernel'], 'plain_ms': ms_b['plain']},
  ]
  log(f'[summary] seconds per request {seconds}; denoiser call kernel path '
      f'{denoiser_ms["kernel"]:.2f} ms, plain path {denoiser_ms["plain"]:.2f}'
      ' ms')
  print(json.dumps({'kernels': kernels}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
