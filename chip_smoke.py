"""Card-side check of the PyTorch/CUDA port: 1-degree GenCast serving and
training.

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
  7. kernel F (block-sparse attention backward: dq, then dk/dv) against its
     plain version at the transformer's padded shape [1, 10304, 4, 128],
     float32 and bfloat16, from kernel A's lse, with timings;
  8. kernel E (LN+FiLM backward) against its plain version at the 1-degree
     transformer shape [1, 10304, 512] and mesh2grid edge shape
     [195480, 1, 512], float32 and bfloat16, with timings;
  9. a TINY float32 training step (perturbed weights, batch 2) on the card
     through the kernels against the CPU's plain path: loss, every
     parameter gradient, and the parameters after 3 AdamW steps; then the
     bf16 stack's gradients on the card against the float32 ones. Under
     both remat policies: 'full' (TINY's) and 'save_attention' (ONE_DEG's);
 10. training: `gencast_tpu_torch.training.train.main` for 3 full-width
     1-degree steps on synthetic data, with finite losses, changed
     parameters and the per-step launches of A, B, E and F checked against
     counts derived from the model's structure;
then one JSON line of kernel results (launches from the training run), the
card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.

TF32 is off for matmuls and cuDNN: float32 products run in full float32.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from typing import Tuple

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
# Kernels E and F, max|kernel - plain| / max|plain|. float32: the same f32
# arithmetic in another summation order. bf16: both round their outputs
# (and F its w/ds operands) to bf16, so a flipped rounding of one ulp
# (2^-8 of the element) shows.
BWD_F32_RTOL = 1e-5
BWD_BF16_RTOL = 1e-2
# TINY float32 training step, card kernels vs CPU plain path: the loss
# (max relative), each gradient (max|card - cpu| / max|cpu| per parameter,
# float32 sums in other orders through 2 GNNs and 2 attention layers), and
# each parameter's change after 3 AdamW steps (relative to its largest
# change: Adam divides a near-zero gradient entry by its own RMS, so its
# relative noise becomes a full-size update).
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEP_RTOL = 2e-2
# The bf16 stack's gradients (reaching the float32 masters) against the
# float32 stack's on the card, per parameter, relative to its largest
# float32 entry: bf16 activations and weights. At TINY (d_model 64) the
# plain path on the CPU reads 0.104 at worst (the q/k projections, through
# the softmax), 0.017 in the median; a gradient that misses the masters or
# binds the wrong parameters reads near 1.
TRAIN_BF16_GRAD_RTOL = 0.25


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


def rel_err(got, want) -> Tuple[float, float]:
  """(max |got - want| / max |want|, max |got - want|) in float32."""
  diff = float((got.float() - want.float()).abs().max())
  return diff / max(float(want.float().abs().max()), 1e-30), diff


def check_attention_bwd(shape, dtype, rtol, mt, plan_t, tile, g):
  """Kernel F (dq, then dk/dv) against the plain backward on seeded q/k/v
  and dO [1, *shape], from kernel A's lse: returns ({'dq': (rel, abs),
  'dkv': (rel, abs)}, {'dq': ms, 'dq_plain': ms, 'dkv': ms,
  'dkv_plain': ms})."""
  from gencast_tpu_torch.ops import sparse_attention as sa
  fwd_ids, fwd_pids, bwd_ids, bwd_pids = plan_t
  q, k, v, dout = (torch.randn((1,) + shape, generator=g, device=mt.device)
                   .to(dtype) for _ in range(4))
  o, lse = sa.sparse_attention_fwd_cuda(q, k, v, mt, fwd_ids, fwd_pids, tile)
  delta = sa.attention_delta(o, dout)
  dq_args = (q, k, v, dout, lse, delta, mt, fwd_ids, fwd_pids, tile)
  dkv_args = (q, k, v, dout, lse, delta, mt, bwd_ids, bwd_pids, tile)
  errs = {}
  want = sa.sparse_attention_dq_plain(*dq_args)
  got = sa.sparse_attention_dq_cuda(*dq_args)
  torch.cuda.synchronize()
  errs['dq'] = rel_err(got, want)
  want = sa.sparse_attention_dkv_plain(*dkv_args)
  got = sa.sparse_attention_dkv_cuda(*dkv_args)
  torch.cuda.synchronize()
  dk_err, dv_err = rel_err(got[0], want[0]), rel_err(got[1], want[1])
  errs['dkv'] = max(dk_err, dv_err)
  for name, (rel, _) in errs.items():
    if not rel <= rtol:
      raise AssertionError(f'kernel F {name} {dtype} {shape}: max rel err '
                           f'{rel} > {rtol}')
  del got, want
  ms = time_in_turns({
      'dq_plain': lambda: sa.sparse_attention_dq_plain(*dq_args),
      'dq': lambda: sa.sparse_attention_dq_cuda(*dq_args)}, reps=5)
  ms.update(time_in_turns({
      'dkv_plain': lambda: sa.sparse_attention_dkv_plain(*dkv_args),
      'dkv': lambda: sa.sparse_attention_dkv_cuda(*dkv_args)}, reps=5))
  log(f'[kernel F] {dtype} [1, {", ".join(map(str, shape))}]: dq max rel err '
      f'{errs["dq"][0]:.3e}, dk/dv {dk_err[0]:.3e}/{dv_err[0]:.3e} (tol '
      f'{rtol}); dq kernel {ms["dq"]:.3f} ms, plain {ms["dq_plain"]:.3f} ms;'
      f' dk/dv kernel {ms["dkv"]:.3f} ms, plain {ms["dkv_plain"]:.3f} ms')
  return errs, ms


def check_ln_film_bwd(shape, batch_axis, dtype, rtol, g):
  """Kernel E against its plain version on seeded x, dy [shape] and scale
  [B, C]: returns ((max rel err, max abs err) over dx, dscale, doffset,
  {'kernel': ms, 'plain': ms})."""
  from gencast_tpu_torch.ops import ln_film
  dev = torch.device('cuda', 0)
  b, c = shape[batch_axis], shape[2]
  x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
  dy = torch.randn(shape, generator=g, device=dev).to(dtype)
  scale = (1 + 0.1 * torch.randn((b, c), generator=g, device=dev)).to(dtype)
  want = ln_film.ln_film_bwd_plain(x, dy, scale, batch_axis)
  got = ln_film.ln_film_bwd_cuda(x, dy, scale, batch_axis)
  torch.cuda.synchronize()
  errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
  worst = max(errs)
  if not worst[0] <= rtol:
    raise AssertionError(f'kernel E {dtype} {shape}: max rel errs (dx, '
                         f'dscale, doffset) {errs} > {rtol}')
  del got, want
  ms = time_in_turns({
      'plain': lambda: ln_film.ln_film_bwd_plain(x, dy, scale, batch_axis),
      'kernel': lambda: ln_film.ln_film_bwd_cuda(x, dy, scale, batch_axis)},
      reps=10)
  log(f'[kernel E] {dtype} {list(shape)} (batch axis {batch_axis}): max rel '
      f'err dx {errs[0][0]:.3e}, dscale {errs[1][0]:.3e}, doffset '
      f'{errs[2][0]:.3e} (tol {rtol}); kernel {ms["kernel"]:.3f} ms, plain '
      f'{ms["plain"]:.3f} ms')
  return worst, ms


def counters():
  """The five kernels' launch counters, A, F-dq, F-dkv, B, E."""
  from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
  return (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
          sparse_attention.KERNEL_DKV, segment.KERNEL, ln_film.KERNEL)


def expected_step_launches(gencast) -> dict:
  """Launches of each kernel in one training step, derived from the model:
  A once per layer under 'save_attention' (the attention half is not
  recomputed) and twice under 'full'; F-dq and F-dkv once per layer; B once
  per planned receiver aggregation (forward) and once per planned gather
  (its backward); E once per LN+FiLM whose output reaches the loss."""
  from gencast_tpu_torch.nn import gnn, mlp
  from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
  arch = gencast.denoiser.architecture
  cfg = arch.processor.cfg
  layers = cfg.num_layers
  recompute = cfg.remat_policy == 'full'
  planned = 0
  for net in arch.modules():
    if isinstance(net, gnn.InteractionNetwork):
      for topo in net.topologies:
        send_k, recv_k = net._uniform[topo.name]
        if topo.recv_plan is not None and recv_k is None:
          planned += 2  # the forward sum and the receiver gather's backward
        if topo.sender_plan is not None and send_k is None:
          planned += 1  # the sender gather's backward
  cond_mlps = sum(isinstance(m, mlp.CondMLP) for m in arch.modules())
  # The decoder updates mesh nodes it never decodes: no gradient there.
  decoded = set(arch.mesh2grid.node_decoders)
  unused = sum(len(set(p.node_mlps) - decoded)
               for p in arch.mesh2grid.processors)
  return {
      sparse_attention.KERNEL.name: layers * (2 if recompute else 1),
      sparse_attention.KERNEL_DQ.name: layers,
      sparse_attention.KERNEL_DKV.name: layers,
      segment.KERNEL.name: planned,
      ln_film.KERNEL.name: 2 * layers + 1 + cond_mlps - unused,
  }


def train_tiny_against_cpu(dev, remat_policy) -> None:
  """Phase 9: one TINY float32 loss and gradient at batch 2, then 3 AdamW
  steps, on the card through the kernels and on the CPU through the plain
  versions, from the same perturbed weights, data, sigma and noise; and the
  bf16 stack's gradients on the card against the float32 ones."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.training import steps
  spec = dataclasses.replace(configs.TINY, attention_tile_size=64,
                             use_agg_plans=True, agg_plan_min_degree=2,
                             remat_policy=remat_policy)
  statics = configs.build_statics(spec)
  flat = None
  stacks, models = {}, {}
  task = spec.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  for where in ('cpu', dev):
    model, _ = configs.build_gencast(spec, seed=3, statics=statics,
                                     device=where)
    if flat is None:
      flat = bridge.perturbed(bridge.export_reference_params(model), seed=4)
    bridge.load_reference_params(model, flat)
    models[str(where)] = model
    stacks[str(where)] = wrappers.build_stack(model, stats,
                                              bf16=False).to(where)
  den = models['cpu'].denoiser
  gen = torch.Generator().manual_seed(6)
  # Batch 2: every kernel indexes past the first batch element.
  grid = (2, den.num_lat, den.num_lon)
  batch = [torch.randn(grid + (lay.num_channels,), generator=gen)
           for lay in (den.input_layout, den.target_layout,
                       den.forcing_layout)]
  draws = [{'sigma': torch.rand(2, generator=gen) * 10 + 0.1,
            'noise': models['cpu'].sphere_noise(gen, 2)} for _ in range(3)]

  def step_losses(where, optimizer):
    out = []
    for dr in draws:
      args = [t.to(where) for t in batch]
      loss, _ = steps.train_step(stacks[str(where)], optimizer, *args,
                                 **{k: v.to(where) for k, v in dr.items()})
      out.append(float(loss))
    return out

  grads, launched = {}, {}
  for where in ('cpu', dev):
    for c in counters():
      c.reset()
    loss, _ = stacks[str(where)].loss(*[t.to(where) for t in batch],
                                      **{k: v.to(where)
                                         for k, v in draws[0].items()})
    loss.mean().backward()
    grads[str(where)] = (loss.detach().cpu().numpy(),
                         bridge.export_reference_grads(models[str(where)]))
    launched[str(where)] = [c.launches for c in counters()]
    models[str(where)].zero_grad()
  (loss_cpu, g_cpu), (loss_gpu, g_gpu) = grads['cpu'], grads[str(dev)]
  # The CPU runs the plain versions; the card every kernel.
  if max(launched['cpu']) != 0 or min(launched[str(dev)]) == 0:
    raise AssertionError(f'TINY training step launches (A, F-dq, F-dkv, B, '
                         f'E): CPU {launched["cpu"]}, card '
                         f'{launched[str(dev)]}')
  bf16_stack = wrappers.build_stack(models[str(dev)], stats,
                                    bf16=True).to(dev)
  loss, _ = bf16_stack.loss(*[t.to(dev) for t in batch],
                            **{k: v.to(dev) for k, v in draws[0].items()})
  loss.mean().backward()
  g_bf16 = bridge.export_reference_grads(models[str(dev)])
  models[str(dev)].zero_grad()
  del bf16_stack
  bf16_rel = max(float(np.abs(g_bf16[k] - w).max() / np.abs(w).max())
                 for k, w in g_gpu.items() if np.abs(w).max() > 0)
  if not bf16_rel <= TRAIN_BF16_GRAD_RTOL:
    raise AssertionError(f'TINY bf16 gradients vs float32 on the card: worst '
                         f'rel {bf16_rel} > {TRAIN_BF16_GRAD_RTOL}')
  loss_rel = float(np.abs(loss_gpu - loss_cpu).max()
                   / np.abs(loss_cpu).max())
  grad_rel = max(float(np.abs(g_gpu[k] - w).max() / np.abs(w).max())
                 for k, w in g_cpu.items() if np.abs(w).max() > 0)
  if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL):
    raise AssertionError(f'TINY training step card vs CPU: loss rel {loss_rel}'
                         f', worst gradient rel {grad_rel}')
  before = bridge.export_reference_params(models['cpu'])
  config = steps.OptimizerConfig(learning_rate=1e-3, warmup_steps=1,
                                 total_steps=3)
  losses = {str(w): step_losses(w, steps.create_optimizer(stacks[str(w)],
                                                          config))
            for w in ('cpu', dev)}
  after = {w: bridge.export_reference_params(m) for w, m in models.items()}
  step_rel = 0.0
  for k, p0 in before.items():
    want = after['cpu'][k] - p0
    got = after[str(dev)][k] - p0
    step_rel = max(step_rel, float(np.abs(got - want).max()
                                   / np.abs(want).max()))
  if not step_rel <= TRAIN_STEP_RTOL:
    raise AssertionError(f'TINY 3 AdamW steps card vs CPU: worst parameter '
                         f'change rel {step_rel} > {TRAIN_STEP_RTOL}')
  log(f'[train tiny] {remat_policy} remat, f32 card kernels vs CPU plain: '
      f'loss rel {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}), worst gradient rel '
      f'{grad_rel:.3e} (tol {TRAIN_GRAD_RTOL}), worst 3-step parameter '
      f'change rel {step_rel:.3e} (tol {TRAIN_STEP_RTOL}); losses card '
      f'{losses[str(dev)]}, CPU {losses["cpu"]}; launches of one loss and '
      f'gradient (A, F-dq, F-dkv, B, E) {launched[str(dev)]}; bf16 card '
      f'gradients vs f32: worst rel {bf16_rel:.3e} (tol '
      f'{TRAIN_BF16_GRAD_RTOL})')


def train_one_deg(spec, statics, dev, card) -> dict:
  """Phase 10: three full-width 1-degree training steps through the CLI;
  returns each kernel's launches in that run."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.training import train
  steps_run = 3
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  run = train.main(['--preset', '1deg', '--steps', str(steps_run), '--data',
                    'synthetic', '--clean_sst_nans', '--log_every', '1'])
  wall = time.perf_counter() - t0
  launches = {c.name: c.launches for c in counters()}
  peak = torch.cuda.max_memory_allocated()
  if not (len(run.losses) == steps_run and np.isfinite(run.losses).all()):
    raise AssertionError(f'1-degree training losses {run.losses}')
  initial, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                     device=dev)
  changed = max(float((p.detach() - p0.detach()).abs().max())
                for p, p0 in zip(run.model.parameters(),
                                 initial.parameters()))
  if not changed > 0:
    raise AssertionError('1-degree training left the parameters unchanged')
  from gencast_tpu_torch.models.gencast import GenCast
  gencast = next(m for m in run.model.modules() if isinstance(m, GenCast))
  per_step = expected_step_launches(gencast)
  expected = {k: v * steps_run for k, v in per_step.items()}
  if launches != expected:
    raise AssertionError(f'1-degree training launches {launches}, expected '
                         f'{expected} ({per_step} per step)')
  log(f'[train 1deg] {steps_run} steps, losses {run.losses}; seconds per '
      f'step {[round(x, 4) for x in run.step_seconds]} (wall {wall:.1f} s '
      f'with set-up and data); max |parameter change| {changed:.3e}; '
      f'launches per step {per_step}, as derived; peak memory '
      f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); {card}')
  return launches


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs on the card only',
          file=sys.stderr)
    return 1
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.graph import plans
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import cuda_lib, ln_film, segment, \
      sparse_attention

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
    m = re.search(r'(sparse_attention_(?:fwd|dq|dkv)_kernel|segment_sum_kernel'
                  r'|ln_film_(?:bwd|reduce)_kernel)(?:I(.*?)EEv)?', line)
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
  results['B'] = (float((got - plain).abs().max()), ms)
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

  # --- 7. kernel F vs plain ---
  plan_t = tuple(torch.as_tensor(a, device=dev) for a in (
      plan.fwd_kv_ids, plan.fwd_pair_ids, plan.bwd_q_ids, plan.bwd_pair_ids))
  for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                      (torch.bfloat16, BWD_BF16_RTOL)):
    results[('F', dtype)] = check_attention_bwd(
        (plan.padded_n, h, d), dtype, rtol, mt, plan_t, plan.tile, g)

  # --- 8. kernel E vs plain ---
  m2g_edges = statics.mesh2grid.num_edges
  for shape, axis in (((1, plan.padded_n, spec.d_model), 0),
                      ((m2g_edges, 1, spec.d_model), 1)):
    for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                        (torch.bfloat16, BWD_BF16_RTOL)):
      results[('E', dtype, shape)] = check_ln_film_bwd(shape, axis, dtype,
                                                       rtol, g)

  # --- 9. TINY training step: card kernels vs CPU plain path ---
  for remat_policy in ('full', 'save_attention'):
    train_tiny_against_cpu(dev, remat_policy)

  # --- 10. training: three full-width 1-degree steps through the CLI ---
  train_launches = train_one_deg(spec, statics, dev, card)

  # Rows: A and F at the transformer's padded shape in bf16 (the dtype
  # training and serving run), B in float32 on the grid2mesh plan, E in
  # bf16 at the largest shape it gets (the mesh2grid edges).
  err_a, ms_a = results[('A', torch.bfloat16, plan.padded_n)]
  err_b, ms_b = results['B']
  err_e, ms_e = results[('E', torch.bfloat16,
                         (m2g_edges, 1, spec.d_model))]
  errs_f, ms_f = results[('F', torch.bfloat16)]
  rows = [
      (sparse_attention.KERNEL, err_a, ms_a['kernel'], ms_a['plain']),
      (segment.KERNEL, err_b, ms_b['kernel'], ms_b['plain']),
      (ln_film.KERNEL, err_e[1], ms_e['kernel'], ms_e['plain']),
      (sparse_attention.KERNEL_DQ, errs_f['dq'][1], ms_f['dq'],
       ms_f['dq_plain']),
      (sparse_attention.KERNEL_DKV, errs_f['dkv'][1], ms_f['dkv'],
       ms_f['dkv_plain']),
  ]
  kernels = [{'name': k.name, 'route': 'cuda', 'source': k.source,
              'replaces': k.replaces, 'launches': train_launches[k.name],
              'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
             for k, err, ms, plain_ms in rows]
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
