"""Card-side check of the PyTorch/CUDA port: 1-degree GenCast and nano
GenCast, served and trained, and the 1-degree train, resume and evaluate
path with the fused attention backward.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. setup: card name and power limit, build of the CUDA kernels, ptxas's
     registers and spills per kernel (a tensor-core kernel must not spill),
     and the count of tensor-core products and asynchronous copies in the
     attention kernels' machine code (the bf16 kernels A, C, D, F and G
     must hold both), and the dynamic shared memory of F's and G's dk/dv
     launches;
  2. statics: the 1-degree graph, attention tile plan and aggregation plans;
  3. kernel A (block-sparse attention) against its plain PyTorch version at
     the 1-degree shapes (the mesh's ragged n, 2 rows in the last tile, and
     the transformer's padded n) and at head dim 32 on TINY's plan, float32
     (FMA kernel) and bfloat16 (tensor-core kernel): o, and lse on the rows
     that see a key (~-1e30 on the others), with NaN behind the last row
     that must not reach the results, with timings;
  4. kernel B (planned segment sum) against its plain version on the plans
     of the 1-degree training step (the grid2mesh receivers, the grid2mesh
     senders with perm, the mesh2grid senders with perm and an 845-edge
     row), float32 and bf16 in: bf16 in bitwise equal to the kernel on the
     float32 upcast, equal bits twice; timings beside the old path (a
     float32 copy, then the kernel), segment_reduce, the kernel without its
     long-row split and the plan with its rows capped;
  5. the ONE_DEG denoiser (random seeded weights, perturbed, bf16 stack)
     through the kernels against the same call through the plain path, and
     a small (TINY, float32) forecast on the card against the CPU;
  6. serving: two forecast requests of one 12-hour step (39 denoiser calls
     each), with kernel launch counts checked;
  7. kernel F (block-sparse attention backward: dq, then dk/dv) against its
     plain version at the transformer's padded shape [1, 10304, 4, 128], at
     the mesh's ragged [1, 10242, 4, 128] (2 rows in the last tile) and at
     head dim 32 on TINY's plan, float32 (FMA kernels) and bfloat16
     (tensor-core kernels), from kernel A's lse, with NaN behind the last
     row that must not reach the results, with timings;
  8. kernel E (LN+FiLM backward) against its plain version at every shape
     the 1-degree and nano training steps give it (the transformer's
     [1, n, C], the GNNs' [rows, 1, C] on nodes and edges; phases 10 and 15
     check that they gave no other) and at batch 2 in both layouts, float32
     and bfloat16, equal bits twice, with timings; one kernel per call under
     torch.profiler; a call captured in a CUDA graph replays to the same
     bits;
  9. a TINY float32 training step (perturbed weights, batch 2) on the card
     through the kernels against the CPU's plain path: loss, every
     parameter gradient, and the parameters after 3 AdamW steps; then the
     bf16 stack's gradients on the card against the float32 ones. Under
     both remat policies: 'full' (TINY's) and 'save_attention' (ONE_DEG's);
 10. training: `gencast_tpu_torch.training.train.main` for 3 full-width
     1-degree steps on synthetic data, with finite losses, changed
     parameters and the per-step launches of every kernel checked against
     counts derived from the model's structure;
 11. kernel C (tri-block attention forward) against its plain version at
     nano's shape [1, 2624, 4, 64] on the nano mask and at TINY's tri-block
     shape [1, 176, 2, 32], float32 (FMA kernel) and bfloat16 (tensor-core
     kernel), o exactly 0 and lse exactly +1e30 on rows without a key, NaN
     behind the last row, with timings;
 12. kernel D (tri-block attention backward: dq, then dk/dv) against its
     plain version at the same shapes, from kernel C's lse, with timings;
 13. the NANO denoiser (random seeded weights, perturbed, bf16 stack)
     through the kernels against the plain path; then two forecast requests
     of a 10-step (5-day) `rollout.sample_rollout`, with 6,240 launches of C
     and 390 of B each, finite float32 output of the right shape, seconds
     per request;
 14. phase 9 on the tri-block backend: a TINY_TRIBLOCK float32 training
     step (batch 2) on the card against the CPU, 3 AdamW steps, and the
     bf16 gradients against the float32 ones ('full' remat, nano's);
 15. training: `train.main` for 3 full-width nano steps, as phase 10;
 16. kernel G (the fused block-sparse attention backward) and its dq
     reduce kernel at the transformer's padded [1, 10304, 4, 128], at the
     mesh's ragged [1, 10242, 4, 128] and at head dim 32 on TINY's plan,
     float32 and bfloat16, from kernel A's lse, with NaN behind the last
     row: G alone against its plain version (dk, dv and the partials on the
     real slots), the reduce against its plain version on the same
     partials with NaN in every pad slot, G with the reduce against the
     plain fused backward and against kernel F (bf16 dk and dv bitwise
     F's), and twice for equal bits; timings of G alone, the reduce alone,
     G with the reduce, F and the library's backward;
 17. the 1-degree path under GENCAST_SPARSE_FUSED_BWD=1: `train.main` for 3
     steps with checkpoints every 2 steps and a metrics file, then a run to
     step 5 that resumes at step 3 from the newest checkpoint (G and its
     reduce 16 times per step each, F never, launches checked per step),
     seconds per step and peak memory beside phase 10's; then
     `evaluate.main` on the checkpoint:
     a 2-member, 2-step 1-degree ensemble (A 2,496 and B 156 launches) from
     the parameters saved, with finite scores and predictions
     [2, 2, 181, 360, C];
 18. reproducibility: two full-width nano training steps through
     `train.main`, run twice from the same seed, leave bitwise equal losses
     and parameters (no aggregation adds atomically); before them, two
     steps under torch.profiler cast no planned edge array (kernel B reads
     the bf16 edges itself);
then one JSON line of kernel results (launches from the training runs of
each kernel's paths), the card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.

Each kernel's row also gives its bound (the least time the card could take
for the same work: the larger of the bytes it must move over 3.35 TB/s and
the operations on the allowed entries over 989 TFLOP/s bf16 or 67 TFLOP/s
float32) and the time of one PyTorch call computing the same function, timed
in turns with the kernel (scaled_dot_product_attention with the dense mask
and its backward, segment_reduce, native_layer_norm_backward; none for
G's dq reduce, whose row says so); the port never calls those. TF32 is off
for matmuls and cuDNN: float32 products run in full float32. Phase 17
writes under build/chip_smoke/ (git-ignored) and removes it. A few minutes
on an H100, build included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Tuple

import numpy as np
import torch

# Tolerances, each with its reason.
# Kernel A, float32: the same f32 arithmetic in another summation order.
ATTN_F32_ATOL = 1e-4
# Kernels A and C, bf16: the kernels round the probabilities to bf16 before
# P.V (as the reference kernels); the plain versions stay f32 until the
# output. Kernel C's online softmax also rounds exp(l - m_running), where the
# reference rounds exp(l - m_final) of its joint three-block max.
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
# Kernel G's dk and dv against kernel F's: in bf16 equal bits (G runs F's
# per-pair routine, mma::dkv_pair, in the same order); in float32 held to
# BWD_F32_RTOL (both run the FMA sweep, G's with its partials added).
# Kernel G's bf16 dq against kernel F's, max|G - F| / max|F|: G rounds each
# pair's partial ds . K to bf16 before the float32 sum over the pairs of a
# query tile (the reference's fused numerics), F rounds the sum once.
FUSED_DQ_BF16_RTOL = 2e-2
# G's dq reduce kernel against its plain version on the same partials, max
# rel: the same float32 sums in another order, rounded once to the
# partials' dtype (in bf16 a flipped rounding is 2^-8 of the element).
REDUCE_F32_RTOL = 1e-5
REDUCE_BF16_RTOL = 1e-2
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
# Peaks of one H100 SXM (data sheet, dense, at 700 W) for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# Forecast steps of phase 13's requests: 10 x 12 hours, 5 days.
ROLLOUT_STEPS = 10


def log(*args):
  print(*args, flush=True)


def card_line() -> str:
  done = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return done.stdout.strip().splitlines()[0]


KERNEL_NAME = re.compile(
    r'((?:sparse|banded)_attention_(?:fwd|dq_reduce|dq|dkvq|dkv)'
    r'(?:_mma)?_kernel|segment_sum_kernel|ln_film_bwd_kernel)(?:I(.*?)EEv)?')


def kernel_name(mangled: str) -> str:
  """'name<template arguments>' of a kernel of the port in a mangled symbol;
  '' if there is none."""
  m = KERNEL_NAME.search(mangled)
  if not m:
    return ''
  return m.group(1) + (f'<{m.group(2)}>' if m.group(2) else '')


def log_sass_counts(lib_path: str) -> None:
  """Logs, for each attention kernel in the built library, how many
  tensor-core products (HMMA), ldmatrix loads (LDSM), asynchronous copies
  (LDGSTS) and float32 FMAs (FFMA) its machine code holds; the tensor-core
  kernels (bf16 A, C, D, F and G) must hold HMMA, LDSM and LDGSTS. Raises
  where cuobjdump, which comes with the toolkit that built the library, is
  not found."""
  from torch.utils.cpp_extension import CUDA_HOME
  tool = shutil.which('cuobjdump') or os.path.join(CUDA_HOME or '', 'bin',
                                                   'cuobjdump')
  if not os.path.exists(tool):
    raise FileNotFoundError(
        f'cuobjdump not found on PATH or at {tool}: the machine code of the '
        f'tensor-core kernels cannot be inspected')
  done = subprocess.run([tool, '-sass', lib_path], capture_output=True,
                        text=True, check=True, timeout=600)
  counts, name = {}, ''
  for line in done.stdout.splitlines():
    if 'Function :' in line:
      name = kernel_name(line)
      if '_attention_' not in name:
        name = ''
    elif name:
      c = counts.setdefault(name, dict.fromkeys(
          ('HMMA', 'LDSM', 'LDGSTS', 'FFMA'), 0))
      for op in c:
        c[op] += bool(re.search(rf'\b{op}\b', line))
  for name, c in sorted(counts.items()):
    log(f'[setup] sass {name}: ' + ', '.join(f'{k} {v}' for k, v in c.items()))
    if '_mma_' in name and not (c['HMMA'] and c['LDSM'] and c['LDGSTS']):
      raise AssertionError(f'{name} holds no tensor-core product or no '
                           f'asynchronous copy: {c}')
  for family in ('sparse_attention_fwd_mma', 'banded_attention_fwd_mma',
                 'sparse_attention_dq_mma', 'sparse_attention_dkv_mma',
                 'sparse_attention_dkvq_mma', 'banded_attention_dq_mma',
                 'banded_attention_dkv_mma'):
    if not any(name.startswith(family) for name in counts):
      raise AssertionError(f'no {family} kernel found in {lib_path}')


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


def graph_ms(fns, reps):
  """ms per call of each fn on the card alone: `reps` calls captured in one
  CUDA graph, its replays timed with CUDA events in the order of
  time_in_turns. A call short enough that the host's launches, not the
  card, would set an event-timed loop (kernel E at the mesh's shapes) is
  timed so; the fns must be capturable (no host sync)."""
  graphs = {}
  for name, fn in fns.items():
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
      fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graphs[name] = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graphs[name]):
      for _ in range(reps):
        fn()
  ms = time_in_turns({n: graph.replay for n, graph in graphs.items()}, 2)
  del graphs
  return {n: v / reps for n, v in ms.items()}


def nan_tailed(shape, count, dtype, g, dev, tail):
  """`count` seeded normal tensors [1, *shape] in `dtype`, each the head of a
  buffer `tail` rows longer whose tail is NaN: a kernel that read a row past
  the last would carry it into its sums (0 * NaN)."""
  n = shape[0]
  bufs = [torch.randn((1, n + tail) + shape[1:], generator=g, device=dev)
          .to(dtype) for _ in range(count)]
  for x in bufs:
    x[:, n:] = float('nan')
  return [x[:, :n] for x in bufs]


def check_attention(shape, dtype, atol, mt, ids, pids, tile, g, dense,
                    allowed):
  """Kernel A against its plain version on seeded q/k/v [1, *shape] with NaN
  behind the last row: o, lse on the rows that see a key, and o = 0 and
  lse ~ -1e30 on the others. Returns (max abs err, {'kernel': ms,
  'plain': ms, 'library': ms}, bound inputs (flops, bytes)). `dense` is the
  [n, n] boolean mask and `allowed` its entry count, for the library call
  and the bound."""
  from gencast_tpu_torch.ops import sparse_attention
  q, k, v = nan_tailed(shape, 3, dtype, g, mt.device, tile)
  plain, lse_p = sparse_attention.sparse_banded_attention_plain(
      q, k, v, mt, ids, pids, tile, return_lse=True)
  got, lse = sparse_attention.sparse_attention_fwd_cuda(
      q, k, v, mt, ids, pids, tile)
  torch.cuda.synchronize()
  seen = dense.any(dim=1)
  err = float((got.float() - plain.float()).abs().max())
  lse_err = float((lse[:, :, seen] - lse_p[:, :, seen]).abs().max())
  # Rows that see no key: o exactly 0 and lse ~ -1e30 (the clamped
  # denominator's logarithm is lost in float32 beside it).
  empty = bool((got[:, ~seen] == 0).all()
               and (lse[:, :, ~seen] <= -0.99e30).all())
  if not (err <= atol and lse_err <= ATTN_F32_ATOL and empty):
    raise AssertionError(f'kernel A {dtype} {shape}: max abs err {err} > '
                         f'{atol}, lse err {lse_err}, empty rows {empty}')
  sdpa = sdpa_inputs(q, k, v, dense)
  with torch.no_grad():
    lib_err = library_error(sdpa_forward(*sdpa).transpose(1, 2), plain, dense)
  ms = time_in_turns({
      'plain': lambda: sparse_attention.sparse_banded_attention_plain(
          q, k, v, mt, ids, pids, tile),
      'kernel': lambda: sparse_attention.sparse_attention_fwd_cuda(
          q, k, v, mt, ids, pids, tile),
      'library': lambda: sdpa_forward(*sdpa)}, reps=10)
  h, d = shape[1], shape[2]
  cost = (4 * d * allowed * h,
          nbytes(q, k, v, mt, ids, pids, got, lse))
  log(f'[kernel A] {dtype} [1, {", ".join(map(str, shape))}]: max abs err '
      f'{err:.3e} (tol {atol}), lse {lse_err:.3e} (tol {ATTN_F32_ATOL}); '
      f'{int((~seen).sum())} rows without a key give 0 and ~-1e30; NaN behind '
      f'row {shape[0]} not read; kernel {ms["kernel"]:.3f} ms, plain '
      f'{ms["plain"]:.3f} ms, library (scaled_dot_product_attention, dense '
      f'mask; max abs err {lib_err:.3e} on rows that see a key) '
      f'{ms["library"]:.3f} ms per layer call')
  return err, ms, cost


def library_error(got, want, dense) -> float:
  """max |got - want| over the rows that see a key (the library's rows that
  see none are not defined)."""
  seen = dense.any(dim=1)
  return float((got[:, seen].float() - want[:, seen].float()).abs().max())


def rel_err(got, want) -> Tuple[float, float]:
  """(max |got - want| / max |want|, max |got - want|) in float32."""
  diff = float((got.float() - want.float()).abs().max())
  return diff / max(float(want.float().abs().max()), 1e-30), diff


def nbytes(*tensors) -> int:
  return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, moved: int, dtype) -> Tuple[float, str]:
  """(ms, what binds it): the larger of the operations over the card's peak
  for `dtype` and the bytes over its memory rate."""
  peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
  t_ops, t_bytes = flops / peak, moved / PEAK_HBM_BYTES
  return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                     else 'bytes')


def row(counter, err, ms, plain_ms, library_ms, flops, moved, dtype) -> dict:
  """One kernel's entry of the JSON line, launches filled in later."""
  bound_ms, bound_by = bound(flops, moved, dtype)
  return {'name': counter.name, 'route': 'cuda', 'source': counter.source,
          'replaces': counter.replaces, 'launches': None, 'max_abs_err': err,
          'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
          'bound_by': bound_by, 'library_ms': library_ms}


def sdpa_inputs(q, k, v, dense):
  """q/k/v [B, N, H, d] -> the [B, H, N, d] operands and the [N, N] boolean
  mask of scaled_dot_product_attention (the library yardstick)."""
  return [x.transpose(1, 2).detach().clone().requires_grad_()
          for x in (q, k, v)] + [dense]


def sdpa_forward(qt, kt, vt, dense):
  return torch.nn.functional.scaled_dot_product_attention(
      qt, kt, vt, attn_mask=dense)


def library_backward_ms(q, k, v, dout, dense, reps):
  """ms of scaled_dot_product_attention's backward (dq, dk, dv together) with
  the dense mask, for the same q/k/v/dO."""
  qt, kt, vt, mask = sdpa_inputs(q, k, v, dense)
  out = sdpa_forward(qt, kt, vt, mask)
  dt = dout.transpose(1, 2)
  return time_in_turns({'library': lambda: torch.autograd.grad(
      out, (qt, kt, vt), dt, retain_graph=True)}, reps)['library']


def check_attention_bwd(shape, dtype, rtol, mt, plan_t, tile, g, dense,
                        allowed):
  """Kernel F (dq, then dk/dv) against the plain backward on seeded q/k/v
  and dO [1, *shape], from kernel A's lse: returns ({'dq': (rel, abs),
  'dkv': (rel, abs)}, {'dq': ms, 'dq_plain': ms, 'dkv': ms,
  'dkv_plain': ms, 'library': ms}, {'dq': (flops, bytes), 'dkv': ...}).
  Each operand has NaN behind its last row (`nan_tailed`)."""
  from gencast_tpu_torch.ops import sparse_attention as sa
  fwd_ids, fwd_pids, bwd_ids, bwd_pids = plan_t
  n = shape[0]
  q, k, v, dout = nan_tailed(shape, 4, dtype, g, mt.device, tile)
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
  ms['library'] = library_backward_ms(q, k, v, dout, dense, reps=5)
  h, d = shape[1], shape[2]
  rows = nbytes(lse, delta)
  costs = {'dq': (6 * d * allowed * h,
                  nbytes(q, k, v, dout, mt, fwd_ids, fwd_pids, q) + rows),
           'dkv': (8 * d * allowed * h,
                   nbytes(q, k, v, dout, mt, bwd_ids, bwd_pids, k, v)
                   + rows)}
  log(f'[kernel F] {dtype} [1, {", ".join(map(str, shape))}]: dq max rel err '
      f'{errs["dq"][0]:.3e}, dk/dv {dk_err[0]:.3e}/{dv_err[0]:.3e} (tol '
      f'{rtol}), NaN behind row {n} not read; dq kernel {ms["dq"]:.3f} ms, plain {ms["dq_plain"]:.3f} ms;'
      f' dk/dv kernel {ms["dkv"]:.3f} ms, plain {ms["dkv_plain"]:.3f} ms; '
      f'library backward (dq, dk, dv) {ms["library"]:.3f} ms')
  return errs, ms, costs


def check_fused_bwd(shape, dtype, rtol, mt, plan_t, gather_t, tile, g, dense,
                    allowed):
  """Kernel G (the fused sweep) and its dq reduce kernel on seeded q/k/v and
  dO [1, *shape] with NaN behind the last row (`nan_tailed`), from kernel
  A's lse:
  * G alone against its plain version: dk, dv, and the partials on the
    real slots (G leaves pad slots unwritten);
  * the reduce kernel against its plain version on the same partials, with
    NaN written into every pad slot first: finite, and equal bits over two
    runs;
  * G with the reduce against the plain fused backward and against kernel
    F: in bf16 dk and dv are F's bits (both run `mma::dkv_pair`), dq within
    FUSED_DQ_BF16_RTOL of F's; and twice, for equal bits.
  Returns ({'G': (rel, abs) worst over dk, dv and the partials, 'reduce':
  (rel, abs)}, ms by name, {'G': (flops, bytes), 'reduce': (flops,
  bytes)})."""
  from gencast_tpu_torch.ops import sparse_attention as sa
  fwd_ids, fwd_pids, bwd_ids, bwd_pids = plan_t
  slot_ids, valid = gather_t
  n = shape[0]
  what = f'{dtype} [1, {", ".join(map(str, shape))}]'
  q, k, v, dout = nan_tailed(shape, 4, dtype, g, mt.device, tile)
  o, lse = sa.sparse_attention_fwd_cuda(q, k, v, mt, fwd_ids, fwd_pids, tile)
  delta = sa.attention_delta(o, dout)
  args = (q, k, v, dout, lse, delta, mt, bwd_ids, bwd_pids, tile)
  real = (bwd_pids != mt.shape[0] - 1).reshape(-1)  # the slots G writes

  def fused():
    dk, dv, partial = sa.sparse_attention_dkvq_cuda(*args)
    return sa.sparse_attention_dq_reduce(partial, slot_ids, valid, n), dk, dv

  def split():
    return (sa.sparse_attention_dq_cuda(q, k, v, dout, lse, delta, mt,
                                        fwd_ids, fwd_pids, tile),
            *sa.sparse_attention_dkv_cuda(*args))

  # G alone, slot by slot on the real slots.
  got = sa.sparse_attention_dkvq_cuda(*args)
  want = sa.sparse_attention_dkvq_plain(*args)
  torch.cuda.synchronize()
  g_errs = [rel_err(got[0], want[0]), rel_err(got[1], want[1]),
            rel_err(got[2][:, real], want[2][:, real])]
  # The reduce on G's partials, NaN in every pad slot.
  partial = got[2]
  partial[:, ~real] = float('nan')
  reduce_args = (partial, slot_ids, valid, n)
  dq_k = sa.sparse_attention_dq_reduce_cuda(*reduce_args)
  dq_k2 = sa.sparse_attention_dq_reduce_cuda(*reduce_args)
  dq_p = sa.sparse_attention_dq_reduce_plain(*reduce_args)
  torch.cuda.synchronize()
  r_err = rel_err(dq_k, dq_p)
  r_tol = REDUCE_F32_RTOL if dtype == torch.float32 else REDUCE_BF16_RTOL
  if not (max(g_errs)[0] <= rtol and r_err[0] <= r_tol
          and bool(torch.isfinite(dq_k).all()) and torch.equal(dq_k, dq_k2)):
    raise AssertionError(
        f'kernel G {what}: max rel errs (dk, dv, partials) against plain '
        f'{g_errs} (tol {rtol}); reduce against plain {r_err} (tol {r_tol}), '
        f'finite {bool(torch.isfinite(dq_k).all())}, equal bits twice '
        f'{torch.equal(dq_k, dq_k2)}')
  del got, want, dq_k, dq_k2, dq_p

  # G with the reduce, against the plain fused backward, F, and itself.
  got = fused()
  again = fused()
  dk_p, dv_p, partial_p = sa.sparse_attention_dkvq_plain(*args)
  want = (sa.sparse_attention_dq_reduce_plain(partial_p, slot_ids, valid, n),
          dk_p, dv_p)
  del partial_p
  f_got = split()
  torch.cuda.synchronize()
  errs = [rel_err(a, b) for a, b in zip(got, want)]
  f_errs = [rel_err(a, b) for a, b in zip(got, f_got)]
  same_bits = all(torch.equal(a, b) for a, b in zip(got, again))
  f_bits = all(torch.equal(a, b) for a, b in zip(got[1:], f_got[1:]))
  # dq against F's: G rounds each pair's partial to the input dtype, F its
  # float32 sum once. dk and dv: the same routine as F's in bf16; float32
  # runs the FMA sweep, F's with the partials added.
  dq_tol = rtol if dtype == torch.float32 else FUSED_DQ_BF16_RTOL
  if not (max(errs)[0] <= rtol and f_errs[0][0] <= dq_tol
          and max(f_errs[1:])[0] <= rtol and same_bits
          and (f_bits or dtype == torch.float32)):
    raise AssertionError(
        f'kernel G and its reduce {what}: max rel errs (dq, dk, dv) against '
        f'plain {errs}, against kernel F {f_errs} (dk, dv F\'s bits: '
        f'{f_bits}); equal bits twice {same_bits}')
  del got, again, want, f_got

  ms = time_in_turns({
      'plain': lambda: sa.sparse_attention_dkvq_plain(*args),
      'kernel': lambda: sa.sparse_attention_dkvq_cuda(*args),
      'reduce_plain': lambda: sa.sparse_attention_dq_reduce_plain(
          *reduce_args),
      'reduce': lambda: sa.sparse_attention_dq_reduce_cuda(*reduce_args),
      'fused': fused,
      'F': split}, reps=5)
  ms['library'] = library_backward_ms(q, k, v, dout, dense, reps=5)
  h, d = shape[1], shape[2]
  pairs = int(real.sum())
  tile_bytes = h * tile * d * q.element_size()
  costs = {'G': (10 * d * allowed * h,
                 nbytes(q, k, v, dout, mt, bwd_ids, bwd_pids, lse, delta, k,
                        v) + pairs * tile_bytes),
           # One float32 add per element read; the valid partials read once,
           # dq written once.
           'reduce': (pairs * tile_bytes // q.element_size(),
                      nbytes(slot_ids, valid, q) + pairs * tile_bytes)}
  log(f'[kernel G] {what}: max rel err against plain dk/dv/partials '
      f'{g_errs[0][0]:.3e}/{g_errs[1][0]:.3e}/{g_errs[2][0]:.3e} on {pairs} '
      f'real slots, with the reduce dq/dk/dv {errs[0][0]:.3e}/'
      f'{errs[1][0]:.3e}/{errs[2][0]:.3e} (tol {rtol}); against kernel F '
      f'{f_errs[0][0]:.3e}/{f_errs[1][0]:.3e}/{f_errs[2][0]:.3e} (dq tol '
      f'{dq_tol}), dk and dv F\'s bits: {f_bits}; equal bits twice; reduce '
      f'against plain {r_err[0]:.3e} (tol {r_tol}) with NaN in the '
      f'{int((~real).sum())} pad slots, finite; NaN behind row {n} not read; '
      f'G {ms["kernel"]:.3f} ms, reduce '
      f'{ms["reduce"]:.3f} ms (PyTorch ops {ms["reduce_plain"]:.3f} ms), G '
      f'and reduce {ms["fused"]:.3f} ms, plain G {ms["plain"]:.3f} ms, kernel '
      f'F (dq, dk/dv) {ms["F"]:.3f} ms, library backward (dq, dk, dv) '
      f'{ms["library"]:.3f} ms; partials '
      f'{pairs * tile_bytes / 2**30:.3f} GiB')
  return {'G': max(g_errs), 'reduce': r_err}, ms, costs


def check_ln_film_bwd(shape, batch_axis, dtype, rtol, g):
  """Kernel E against its plain version on seeded x, dy [shape] and scale
  [B, C], and twice for equal bits: returns ((max rel err, max abs err) over
  dx, dscale, doffset, {'kernel': ms, 'plain': ms, 'library': ms}, bound
  inputs (flops, bytes), the inputs)."""
  from gencast_tpu_torch.ops import ln_film
  dev = torch.device('cuda', 0)
  b, c = shape[batch_axis], shape[2]
  x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
  dy = torch.randn(shape, generator=g, device=dev).to(dtype)
  scale = (1 + 0.1 * torch.randn((b, c), generator=g, device=dev)).to(dtype)
  want = ln_film.ln_film_bwd_plain(x, dy, scale, batch_axis)
  got = ln_film.ln_film_bwd_cuda(x, dy, scale, batch_axis)
  again = ln_film.ln_film_bwd_cuda(x, dy, scale, batch_axis)
  torch.cuda.synchronize()
  errs = [rel_err(gv, wv) for gv, wv in zip(got, want)]
  worst = max(errs)
  same = all(torch.equal(a, b) for a, b in zip(got, again))
  if not (worst[0] <= rtol and same):
    raise AssertionError(f'kernel E {dtype} {shape}: max rel errs (dx, '
                         f'dscale, doffset) {errs} > {rtol}, or two calls '
                         f'differ (equal bits: {same})')
  moved = nbytes(x, dy, scale, got[0], got[1], got[2])
  del got, want, again
  # The library yardstick at batch 1: LayerNorm's backward with the FiLM
  # scale as its weight gives dx, dscale and doffset.
  x2, dy2, w = x.reshape(-1, c), dy.reshape(-1, c), scale[0]
  bias = torch.zeros_like(w)
  _, mean, rstd = torch.native_layer_norm(x2, [c], w, bias, ln_film.EPS)
  ms = graph_ms({
      'plain': lambda: ln_film.ln_film_bwd_plain(x, dy, scale, batch_axis),
      'kernel': lambda: ln_film.ln_film_bwd_cuda(x, dy, scale, batch_axis),
      'library': lambda: torch.ops.aten.native_layer_norm_backward(
          dy2, x2, [c], mean, rstd, w, bias, [True, True, True])},
      reps=10)
  # About 16 operations per element (statistics, x_hat, dx, the two sums).
  cost = (16 * x.numel(), moved)
  bound_ms, _ = bound(*cost, dtype)
  log(f'[kernel E] {dtype} {list(shape)} (batch axis {batch_axis}): max rel '
      f'err dx {errs[0][0]:.3e}, dscale {errs[1][0]:.3e}, doffset '
      f'{errs[2][0]:.3e} (tol {rtol}), equal bits twice; kernel '
      f'{ms["kernel"]:.4f} ms (bound {bound_ms:.4f}), plain '
      f'{ms["plain"]:.3f} ms, library (native_layer_norm_backward) '
      f'{ms["library"]:.4f} ms')
  return worst, ms, cost, (x, dy, scale)


def ln_film_shapes(presets):
  """(shape, batch axis) of every call of kernel E in a training step of
  each (spec, statics): the transformer's [1, n, C] (n the attention's
  padded mesh) and the GNNs' [rows, 1, C] on the mesh and grid nodes and
  the grid2mesh and mesh2grid edges; and at batch 2, in both layouts, the
  first preset's mesh shapes."""
  shapes = []
  for spec, st in presets:
    plan, mask = st.attention_tile_plan, st.attention_mask
    padded = (plan.padded_n if plan is not None
              else mask.num_blocks * mask.block_size)
    shapes.append(((1, padded, spec.d_model), 0))
    shapes += [((rows, 1, spec.d_model), 1) for rows in (
        st.num_mesh_nodes, st.num_grid_nodes, st.grid2mesh.num_edges,
        st.mesh2grid.num_edges)]
  (spec, st), = presets[:1]
  shapes += [((2, shapes[0][0][1], spec.d_model), 0),
             ((st.num_mesh_nodes, 2, spec.d_model), 1)]
  return shapes


def check_ln_film_shapes(shapes, g, card):
  """Phase 8: kernel E at every shape, float32 and bf16, against its plain
  version and twice for equal bits (check_ln_film_bwd); one call of each
  under torch.profiler must run exactly one kernel, E's; a call captured in
  a CUDA graph and replayed twice gives the eager call's bits. Returns
  {(shape, dtype): check_ln_film_bwd's result}."""
  from gencast_tpu_torch.ops import ln_film
  results, calls = {}, []
  for shape, axis in shapes:
    for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                        (torch.bfloat16, BWD_BF16_RTOL)):
      res = check_ln_film_bwd(shape, axis, dtype, rtol, g)
      results[(shape, dtype)] = res[:3]
      calls.append((res[3], axis))
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with torch.profiler.profile(activities=activities) as prof:
    for (x, dy, scale), axis in calls:
      ln_film.ln_film_bwd_cuda(x, dy, scale, axis)
    torch.cuda.synchronize()
  kernels = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and not e.is_user_annotation]
  if (len(kernels) != len(calls)
      or not all('ln_film_bwd_kernel' in k for k in kernels)):
    raise AssertionError(f'kernel E: {len(calls)} calls ran {len(kernels)} '
                         f'kernels under the profiler: {sorted(set(kernels))}')
  # A CUDA graph replays the launch: no state to reset between calls.
  (x, dy, scale), axis = next(c for c in calls if c[0][0].shape == shapes[0][0]
                              and c[0][0].dtype == torch.bfloat16)
  eager = ln_film.ln_film_bwd_cuda(x, dy, scale, axis)
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    ln_film.ln_film_bwd_cuda(x, dy, scale, axis)
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    captured = ln_film.ln_film_bwd_cuda(x, dy, scale, axis)
  replays = []
  for _ in range(2):
    graph.replay()
    torch.cuda.synchronize()
    replays.append(all(torch.equal(a, b) for a, b in zip(captured, eager)))
  if not all(replays):
    raise AssertionError(f'kernel E in a CUDA graph: replays equal to the '
                         f'eager call {replays}')
  del graph, captured, calls
  log(f'[kernel E] {len(shapes)} shapes x 2 dtypes: one kernel per call '
      f'under torch.profiler ({len(kernels)} calls, {len(kernels)} '
      f'ln_film_bwd_kernel launches); a call captured in a CUDA graph and '
      f'replayed twice gives the eager bits; {card}')
  return results


@contextlib.contextmanager
def recording_ln_film_shapes(seen):
  """Adds (shape, batch axis) of every kernel E launch inside to `seen`."""
  from gencast_tpu_torch.ops import ln_film
  launch = ln_film.ln_film_bwd_cuda

  def recorded(x, dy, scale, batch_axis, eps=ln_film.EPS):
    seen.add((tuple(x.shape), batch_axis))
    return launch(x, dy, scale, batch_axis, eps)

  ln_film.ln_film_bwd_cuda = recorded
  try:
    yield
  finally:
    ln_film.ln_film_bwd_cuda = launch


def capped_plan(row_ptr, perm, cap):
  """The plan (row_ptr, perm) with every row cut to its first `cap` edges:
  (row_ptr, perm), perm always given and as long as the edges (the kernel
  reads it only below row_ptr[-1])."""
  starts = row_ptr[:-1].long()
  kept = (row_ptr[1:].long() - starts).clamp(max=cap)
  new_ptr = torch.zeros_like(row_ptr, dtype=torch.long)
  new_ptr[1:] = kept.cumsum(0)
  rows = torch.repeat_interleave(torch.arange(kept.numel(),
                                              device=row_ptr.device), kept)
  at = starts[rows] + torch.arange(rows.numel(), device=row_ptr.device) \
      - new_ptr[:-1][rows]
  order = torch.zeros(int(row_ptr[-1]), dtype=torch.int32,
                      device=row_ptr.device)
  order[:at.numel()] = at if perm is None else perm.long()[at]
  return new_ptr.int(), order


def check_segment_sums(spec, statics, g, card):
  """Phase 4: kernel B on the plans of the 1-degree training step (the
  grid2mesh receivers, its senders, the mesh2grid senders), float32 and
  bf16 in: against the plain version, bf16 in bitwise equal to the kernel
  on the exact float32 upcast, and twice for equal bits; timings of the
  kernel, of the old path (the float32 copy, then the kernel), of the
  plain version and of segment_reduce, and on plans with rows over
  segment.SPLIT_DEGREE edges of the kernel without the split, with half and
  twice that threshold, and of the plan with its rows capped at
  SPLIT_DEGREE (the kernel's paths as CUDA graph replays, graph_ms). Returns {(plan, dtype): (max abs err, ms,
  bound inputs)}."""
  from gencast_tpu_torch.graph import plans
  from gencast_tpu_torch.ops import segment
  f = spec.d_model
  unsplit = 2**31 - 1
  results = {}
  for name, ids, n in (
      ('grid2mesh receivers', statics.grid2mesh.receivers,
       statics.num_mesh_nodes),
      ('grid2mesh senders', statics.grid2mesh.senders,
       statics.num_grid_nodes),
      ('mesh2grid senders', statics.mesh2grid.senders,
       statics.num_mesh_nodes)):
    plan = plans.build_agg_plan(ids, n)
    row_ptr = torch.as_tensor(plan.row_ptr, device=g.device)
    perm = (None if plan.perm is None
            else torch.as_tensor(plan.perm, device=g.device))
    lengths = (row_ptr[1:] - row_ptr[:-1]).long()
    max_degree = int(lengths.max())
    e = len(ids)
    base = torch.randn(e, f, generator=g, device=g.device)
    for dtype in (torch.float32, torch.bfloat16):
      data = base.to(dtype)
      upcast = data.float()
      want = segment.planned_segment_sum_plain(upcast, row_ptr, perm)
      got = segment.planned_segment_sum_cuda(data, row_ptr, perm)
      again = segment.planned_segment_sum_cuda(data, row_ptr, perm)
      from_upcast = segment.planned_segment_sum_cuda(upcast, row_ptr, perm)
      torch.cuda.synchronize()
      rel, err = rel_err(got, want)
      same = (torch.equal(got, again), torch.equal(got, from_upcast))
      if not (rel <= SEGMENT_RTOL and all(same)):
        raise AssertionError(f'kernel B {name} {dtype}: relative err {rel} '
                             f'> {SEGMENT_RTOL}, or bits differ (twice, '
                             f'float32 upcast: {same})')
      permuted = data if perm is None else data[perm.long()]
      ms = time_in_turns({
          'plain': lambda: segment.planned_segment_sum_plain(data, row_ptr,
                                                             perm),
          'library': lambda: torch.segment_reduce(permuted, 'sum',
                                                  lengths=lengths)}, reps=20)
      fns = {'kernel': lambda: segment.planned_segment_sum_cuda(data, row_ptr,
                                                                perm)}
      if dtype == torch.bfloat16:
        fns['cast_then_kernel'] = lambda: segment.planned_segment_sum_cuda(
            data.float(), row_ptr, perm)
      if max_degree > segment.SPLIT_DEGREE:
        capped = capped_plan(row_ptr, perm, segment.SPLIT_DEGREE)
        fns['unsplit'] = lambda: segment.planned_segment_sum_cuda(
            data, row_ptr, perm, split_degree=unsplit)
        for degree in (segment.SPLIT_DEGREE // 2, 2 * segment.SPLIT_DEGREE):
          fns[f'split_{degree}'] = (
              lambda degree=degree: segment.planned_segment_sum_cuda(
                  data, row_ptr, perm, split_degree=degree))
        fns['capped'] = lambda: segment.planned_segment_sum_cuda(
            data, *capped, split_degree=unsplit)
      ms.update(graph_ms(fns, reps=20))
      cost = (e * f, nbytes(data, row_ptr, got)
              + (0 if perm is None else nbytes(perm)))
      results[(name, dtype)] = (err, ms, cost)
      bound_ms, _ = bound(*cost, dtype)
      extra = ''.join(f', {k} {v:.4f} ms' for k, v in ms.items()
                      if k not in ('plain', 'kernel', 'library'))
      log(f'[kernel B] {name}: {dtype} [{e}, {f}] -> [{n}, {f}] float32, '
          f'max degree {max_degree}, perm {"yes" if perm is not None else "no"}'
          f': relative err {rel:.3e} (tol {SEGMENT_RTOL}), equal bits twice '
          f'and on the float32 upcast; kernel {ms["kernel"]:.4f} ms (bound '
          f'{bound_ms:.4f}), plain {ms["plain"]:.3f} ms, library '
          f'(segment_reduce) {ms["library"]:.4f} ms{extra}; {card}')
      del data, upcast, want, got, again, from_upcast, permuted, fns
  return results


def counters():
  """Every kernel's launch counter: A, F-dq, F-dkv, B, E, C, D-dq, D-dkv,
  G and G's dq reduce."""
  from gencast_tpu_torch.ops import banded_attention, ln_film, segment, \
      sparse_attention
  return (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
          sparse_attention.KERNEL_DKV, segment.KERNEL, ln_film.KERNEL,
          banded_attention.KERNEL, banded_attention.KERNEL_DQ,
          banded_attention.KERNEL_DKV, sparse_attention.KERNEL_DKVQ,
          sparse_attention.KERNEL_DQ_REDUCE)


def expected_step_launches(gencast) -> dict:
  """Launches of each kernel in one training step, derived from the model.
  The attention backend's forward (A or C) runs once per layer under
  'save_attention' (the attention half is not recomputed) and twice under
  'full'; its backward (F or D: dq and dk/dv; G and its dq reduce when the
  transformer holds the fused backward's gather map) once per layer; the other
  backend's kernels never. B once per receiver aggregation over a side of
  non-uniform degree (forward) and once per gather over such a side (its
  backward): on the card each of them carries a plan, the reference's or
  one of its own; E once per LN+FiLM whose output reaches the loss."""
  from gencast_tpu_torch.nn import gnn, mlp
  from gencast_tpu_torch.ops import banded_attention, ln_film, segment, \
      sparse_attention
  arch = gencast.denoiser.architecture
  cfg = arch.processor.cfg
  layers = cfg.num_layers
  recompute = cfg.remat_policy == 'full'
  planned = 0
  for net in arch.modules():
    if isinstance(net, gnn.InteractionNetwork):
      for topo in net.topologies:
        send_k, recv_k = net._uniform[topo.name]
        if recv_k is None:
          planned += 2  # the forward sum and the receiver gather's backward
        if send_k is None:
          planned += 1  # the sender gather's backward
  cond_mlps = sum(isinstance(m, mlp.CondMLP) for m in arch.modules())
  # The decoder updates mesh nodes it never decodes: no gradient there.
  decoded = set(arch.mesh2grid.node_decoders)
  unused = sum(len(set(p.node_mlps) - decoded)
               for p in arch.mesh2grid.processors)
  if 'slot_ids' in arch.processor.operand_names:
    attn = (sparse_attention.KERNEL, sparse_attention.KERNEL_DKVQ,
            sparse_attention.KERNEL_DQ_REDUCE)
  elif cfg.attention_type == 'pallas':
    attn = (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
            sparse_attention.KERNEL_DKV)
  else:
    attn = (banded_attention.KERNEL, banded_attention.KERNEL_DQ,
            banded_attention.KERNEL_DKV)
  launches = {c.name: 0 for c in counters()}
  launches.update({c.name: layers for c in attn[1:]})
  launches.update({
      attn[0].name: layers * (2 if recompute else 1),
      segment.KERNEL.name: planned,
      ln_film.KERNEL.name: 2 * layers + 1 + cond_mlps - unused,
  })
  return launches


def train_tiny_against_cpu(dev, remat_policy, spec) -> None:
  """Phases 9 and 14: one TINY float32 loss and gradient at batch 2, then 3
  AdamW steps, on the card through the kernels and on the CPU through the
  plain versions, from the same perturbed weights, data, sigma and noise;
  and the bf16 stack's gradients on the card against the float32 ones.
  `spec` is TINY on one attention backend."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.training import steps
  spec = dataclasses.replace(spec, attention_tile_size=64,
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
  # The kernels this backend launches: its attention forward and backward,
  # B and E.
  step_kernels = [c for c in counters()
                  if expected_step_launches(models['cpu'])[c.name]]
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
    launched[str(where)] = {c.name: c.launches for c in counters()}
    models[str(where)].zero_grad()
  (loss_cpu, g_cpu), (loss_gpu, g_gpu) = grads['cpu'], grads[str(dev)]
  # The CPU runs the plain versions; the card every kernel of the backend.
  if (max(launched['cpu'].values()) != 0
      or min(launched[str(dev)][c.name] for c in step_kernels) == 0):
    raise AssertionError(f'{spec.name} training step launches: CPU '
                         f'{launched["cpu"]}, card {launched[str(dev)]}')
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
  log(f'[train {spec.name}] {remat_policy} remat, f32 card kernels vs CPU '
      'plain: '
      f'loss rel {loss_rel:.3e} (tol {TRAIN_LOSS_RTOL}), worst gradient rel '
      f'{grad_rel:.3e} (tol {TRAIN_GRAD_RTOL}), worst 3-step parameter '
      f'change rel {step_rel:.3e} (tol {TRAIN_STEP_RTOL}); losses card '
      f'{losses[str(dev)]}, CPU {losses["cpu"]}; launches of one loss and '
      f'gradient {launched[str(dev)]}; bf16 card '
      f'gradients vs f32: worst rel {bf16_rel:.3e} (tol '
      f'{TRAIN_BF16_GRAD_RTOL})')


def train_preset(spec, statics, dev, card, argv, steps_run=3, start=0,
                 tag=None):
  """Phases 10, 15 and 17: full-width training steps of `spec` through the
  CLI (`argv` names the preset and any checkpoint directory), up to step
  `steps_run`, starting at `start` (a resumed run starts past its
  checkpoint). Checks the losses, the parameters' change and each kernel's
  launches against the counts derived from the model; returns (those
  launches, the seconds of each step, the peak device memory in bytes)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.training import train
  tag = tag or spec.name
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  run = train.main(argv + ['--steps', str(steps_run), '--data', 'synthetic',
                           '--log_every', '1'])
  wall = time.perf_counter() - t0
  launches = {c.name: c.launches for c in counters()}
  peak = torch.cuda.max_memory_allocated()
  taken = steps_run - start
  if not (run.start_step == start and len(run.losses) == taken
          and np.isfinite(run.losses).all()):
    raise AssertionError(f'{tag} training from step {run.start_step} '
                         f'(expected {start}): losses {run.losses}')
  initial, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                     device=dev)
  changed = max(float((p.detach() - p0.detach()).abs().max())
                for p, p0 in zip(run.model.parameters(),
                                 initial.parameters()))
  if not changed > 0:
    raise AssertionError(f'{tag} training left the parameters unchanged')
  from gencast_tpu_torch.models.gencast import GenCast
  gencast = next(m for m in run.model.modules() if isinstance(m, GenCast))
  per_step = expected_step_launches(gencast)
  expected = {k: v * taken for k, v in per_step.items()}
  if launches != expected:
    raise AssertionError(f'{tag} training launches {launches}, expected '
                         f'{expected} ({per_step} per step)')
  log(f'[train {tag}] steps {start + 1}-{steps_run}, losses {run.losses}; '
      f'seconds per step {[round(x, 4) for x in run.step_seconds]} (wall '
      f'{wall:.1f} s with set-up and data); max |parameter change| '
      f'{changed:.3e}; launches per step {per_step}, as derived; peak memory '
      f'{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); {card}')
  return launches, run.step_seconds, peak


def check_reproducible(argv, steps_run) -> None:
  """Phase 18: `steps_run` training steps through the CLI, twice from the
  same seed, must leave bitwise equal losses and parameters: every sum of
  the step is taken in a fixed order (no aggregation adds atomically)."""
  from gencast_tpu_torch.ops import segment
  from gencast_tpu_torch.training import train
  runs = []
  for _ in range(2):
    segment.KERNEL.reset()
    run = train.main(argv + ['--steps', str(steps_run), '--data', 'synthetic',
                             '--log_every', '1'])
    runs.append((run.losses, [p.detach().clone()
                              for p in run.model.parameters()]))
    if segment.KERNEL.launches == 0:
      raise AssertionError(f'{argv}: training launched no planned sum')
  (losses_a, params_a), (losses_b, params_b) = runs
  differing = sum(not torch.equal(a, b) for a, b in zip(params_a, params_b))
  if losses_a != losses_b or differing or not np.isfinite(losses_a).all():
    raise AssertionError(
        f'{argv}: two runs from one seed differ: losses {losses_a} and '
        f'{losses_b}, {differing} of {len(params_a)} parameters differ')
  log(f'[reproducible] {" ".join(argv)}: {steps_run} training steps twice '
      f'from one seed: losses {losses_a} and all {len(params_a)} parameters '
      'bitwise equal')


def count_edge_casts(argv, statics, width) -> Tuple[int, int]:
  """Phase 18: two training steps through the CLI under torch.profiler
  (host ops, with shapes): (dtype casts of a whole planned edge array, the
  [E, width] rows kernel B reads; B's launches). Before kernel B read bf16
  itself, every bf16 call cast its edges to float32 first."""
  from gencast_tpu_torch.ops import segment
  from gencast_tpu_torch.training import train
  edges = {statics.grid2mesh.num_edges, statics.mesh2grid.num_edges}
  segment.KERNEL.reset()
  with torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU],
      record_shapes=True) as prof:
    train.main(argv + ['--steps', '2', '--data', 'synthetic', '--log_every',
                       '1'])
  casts = sum(1 for e in prof.events()
              if e.name == 'aten::_to_copy' and e.input_shapes
              and len(e.input_shapes[0]) == 2
              and tuple(e.input_shapes[0]) in {(n, width) for n in edges})
  return casts, segment.KERNEL.launches


def dense_from_blocks(blocks: np.ndarray, dev) -> torch.Tensor:
  """The [N, N] boolean mask that the tri-block mask [3, nb, bs, bs]
  describes (for the library yardstick)."""
  _, nb, bs, _ = blocks.shape
  dense = np.zeros((nb * bs, nb * bs), dtype=bool)
  for j in range(nb):
    rows = slice(j * bs, (j + 1) * bs)
    dense[rows, rows] = blocks[0, j]
    if j + 1 < nb:
      dense[rows, (j + 1) * bs:(j + 2) * bs] = blocks[1, j]
    if j > 0:
      dense[rows, (j - 1) * bs:j * bs] = blocks[2, j]
  return torch.as_tensor(dense, device=dev)


def dense_from_plan(plan, dev) -> torch.Tensor:
  """The [padded_n, padded_n] boolean mask that a tile plan describes."""
  t, nq = plan.tile, plan.num_q_tiles
  dense = np.zeros((nq, nq, t, t), dtype=bool)
  rows = np.repeat(np.arange(nq), plan.fwd_kv_ids.shape[1])
  cols = plan.fwd_kv_ids.reshape(-1)
  pids = plan.fwd_pair_ids.reshape(-1)
  real = pids != plan.mask_tiles.shape[0] - 1  # pad slots repeat a pair
  dense[rows[real], cols[real]] = plan.mask_tiles[pids[real]] != 0
  return torch.as_tensor(
      dense.transpose(0, 2, 1, 3).reshape(nq * t, nq * t), device=dev)


def check_banded(shape, dtype, atol, mask, bs, g, dense, allowed):
  """Kernel C against its plain version on seeded q/k/v [1, *shape] (NaN
  behind the last row) under the tri-block `mask` (uint8 [3, nb, bs, bs]):
  returns (max abs err,
  {'kernel': ms, 'plain': ms, 'library': ms}, (flops, bytes))."""
  from gencast_tpu_torch.ops import banded_attention as ba
  q, k, v = nan_tailed(shape, 3, dtype, g, mask.device, 64)
  plain, lse_p = ba.banded_attention_plain(q, k, v, mask, bs,
                                           return_lse=True)
  got, lse = ba.banded_attention_fwd_cuda(q, k, v, mask, bs)
  torch.cuda.synchronize()
  seen = dense.any(dim=1)
  err = float((got.float() - plain.float()).abs().max())
  lse_err = float((lse[:, :, seen] - lse_p[:, :, seen]).abs().max())
  # Rows that see no key: o exactly 0 and lse +1e30, as the reference.
  empty = bool((got[:, ~seen] == 0).all() and (lse[:, :, ~seen] == 1e30).all())
  if not (err <= atol and lse_err <= ATTN_F32_ATOL and empty):
    raise AssertionError(f'kernel C {dtype} {shape}: max abs err {err} > '
                         f'{atol}, lse err {lse_err}, empty rows {empty}')
  sdpa = sdpa_inputs(q, k, v, dense)
  with torch.no_grad():
    lib_err = library_error(sdpa_forward(*sdpa).transpose(1, 2), plain, dense)
  ms = time_in_turns({
      'plain': lambda: ba.banded_attention_plain(q, k, v, mask, bs),
      'kernel': lambda: ba.banded_attention_fwd_cuda(q, k, v, mask, bs),
      'library': lambda: sdpa_forward(*sdpa)}, reps=20)
  h, d = shape[1], shape[2]
  log(f'[kernel C] {dtype} [1, {", ".join(map(str, shape))}], block {bs}: '
      f'max abs err {err:.3e} (tol {atol}), lse {lse_err:.3e}; {int((~seen).sum())} '
      f'rows without a key give 0 and +1e30; NaN behind row {shape[0]} not '
      f'read; kernel {ms["kernel"]:.3f} ms, '
      f'plain {ms["plain"]:.3f} ms, library (scaled_dot_product_attention, '
      f'dense mask; max abs err {lib_err:.3e} on rows that see a key) '
      f'{ms["library"]:.3f} ms per layer call')
  return err, ms, (4 * d * allowed * h, nbytes(q, k, v, mask, got, lse))


def check_banded_bwd(shape, dtype, rtol, mask, bs, g, dense, allowed):
  """Kernel D (dq, then dk/dv) against the plain backward on seeded q/k/v
  and dO [1, *shape], from kernel C's lse: returns ({'dq': (rel, abs),
  'dkv': (rel, abs)}, ms by name, {'dq': (flops, bytes), 'dkv': ...})."""
  from gencast_tpu_torch.ops import banded_attention as ba
  q, k, v, dout = (torch.randn((1,) + shape, generator=g, device=mask.device)
                   .to(dtype) for _ in range(4))
  o, lse = ba.banded_attention_fwd_cuda(q, k, v, mask, bs)
  delta = ba.attention_delta(o, dout)
  args = (q, k, v, dout, lse, delta, mask, bs)
  errs = {'dq': rel_err(ba.banded_attention_dq_cuda(*args),
                        ba.banded_attention_dq_plain(*args))}
  got, want = (ba.banded_attention_dkv_cuda(*args),
               ba.banded_attention_dkv_plain(*args))
  torch.cuda.synchronize()
  dk_err, dv_err = rel_err(got[0], want[0]), rel_err(got[1], want[1])
  errs['dkv'] = max(dk_err, dv_err)
  seen = dense.any(dim=1)
  dq = ba.banded_attention_dq_cuda(*args)
  if not bool((dq[:, ~seen] == 0).all()):
    raise AssertionError(f'kernel D {dtype} {shape}: dq nonzero on rows '
                         'without a key')
  for name, (rel, _) in errs.items():
    if not rel <= rtol:
      raise AssertionError(f'kernel D {name} {dtype} {shape}: max rel err '
                           f'{rel} > {rtol}')
  del got, want
  ms = time_in_turns({
      'dq_plain': lambda: ba.banded_attention_dq_plain(*args),
      'dq': lambda: ba.banded_attention_dq_cuda(*args)}, reps=10)
  ms.update(time_in_turns({
      'dkv_plain': lambda: ba.banded_attention_dkv_plain(*args),
      'dkv': lambda: ba.banded_attention_dkv_cuda(*args)}, reps=10))
  ms['library'] = library_backward_ms(q, k, v, dout, dense, reps=10)
  h, d = shape[1], shape[2]
  rows = nbytes(lse, delta)
  costs = {'dq': (6 * d * allowed * h, nbytes(q, k, v, dout, mask, q) + rows),
           'dkv': (8 * d * allowed * h,
                   nbytes(q, k, v, dout, mask, k, v) + rows)}
  log(f'[kernel D] {dtype} [1, {", ".join(map(str, shape))}], block {bs}: '
      f'dq max rel err {errs["dq"][0]:.3e}, dk/dv {dk_err[0]:.3e}/'
      f'{dv_err[0]:.3e} (tol {rtol}), dq 0 on rows without a key; dq kernel '
      f'{ms["dq"]:.3f} ms, plain {ms["dq_plain"]:.3f} ms; dk/dv kernel '
      f'{ms["dkv"]:.3f} ms, plain {ms["dkv_plain"]:.3f} ms; library backward '
      f'(dq, dk, dv) {ms["library"]:.3f} ms')
  return errs, ms, costs


def serve_nano(dev, g) -> float:
  """Phase 13: the nano denoiser through the kernels against the plain
  path, then two 10-step forecast requests through `sample_rollout`.
  Returns the kernel path's ms per denoiser call (timed alone)."""
  from gencast_tpu_torch import bridge, configs, rollout
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import banded_attention, segment
  spec = configs.NANO
  t0 = time.perf_counter()
  statics = configs.build_statics(spec)
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
  log(f'[nano] built two {spec.name} models '
      f'({sum(p.numel() for p in model.parameters())} parameters each, '
      f'seeded and perturbed) in {time.perf_counter() - t0:.1f} s')
  den = model.denoiser
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.randn(grid + (den.input_layout.num_channels,), generator=g,
                       device=dev)
  forcings = torch.randn((ROLLOUT_STEPS,) + grid
                         + (den.forcing_layout.num_channels,), generator=g,
                         device=dev)
  noisy = torch.randn(grid + (den.target_layout.num_channels,), generator=g,
                      device=dev) * 3.0
  sigma = torch.full((1,), 3.0, device=dev)
  with torch.no_grad():
    banded_attention.KERNEL.reset()
    segment.KERNEL.reset()
    out_k = stack(inputs, noisy, sigma, forcings[0])
    torch.cuda.synchronize()
    # C once per layer; B once, the grid2mesh aggregation (nano plans no
    # side itself: on the card every side of non-uniform degree has a plan).
    launched = (banded_attention.KERNEL.launches, segment.KERNEL.launches)
    if launched != (spec.num_layers, 1):
      raise AssertionError(f'nano denoiser call launched (C, B) {launched}, '
                           f'expected ({spec.num_layers}, 1)')
    out_p = plain_stack(inputs, noisy, sigma, forcings[0])
    rel = float((out_k - out_p).abs().max() / out_p.abs().max())
    if not (torch.isfinite(out_k).all() and rel <= DENOISER_BF16_RTOL):
      raise AssertionError(f'nano denoiser kernels vs plain: {rel} > '
                           f'{DENOISER_BF16_RTOL} or not finite')
    ms = time_in_turns({
        'plain': lambda: plain_stack(inputs, noisy, sigma, forcings[0]),
        'kernel': lambda: stack(inputs, noisy, sigma, forcings[0])}, reps=5)
  log(f'[nano] denoiser bf16 {tuple(out_k.shape)}: max rel err {rel:.3e} '
      f'(tol {DENOISER_BF16_RTOL}); kernel path {ms["kernel"]:.2f} ms, plain '
      f'path {ms["plain"]:.2f} ms per call')
  del out_k, out_p, plain_stack, plain_model

  calls = ROLLOUT_STEPS * (2 * spec.num_noise_levels - 1)
  for seed in (1, 2):
    gen = torch.Generator(device=dev).manual_seed(seed)
    banded_attention.KERNEL.reset()
    segment.KERNEL.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecast = rollout.sample_rollout(stack, inputs, forcings, gen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launched = (banded_attention.KERNEL.launches, segment.KERNEL.launches)
    expected_shape = (ROLLOUT_STEPS,) + grid + (
        den.target_layout.num_channels,)
    if (tuple(forecast.shape) != expected_shape
        or forecast.dtype != torch.float32
        or not torch.isfinite(forecast).all()):
      raise AssertionError(f'nano forecast {seed}: {tuple(forecast.shape)} '
                           f'{forecast.dtype}, finite '
                           f'{bool(torch.isfinite(forecast).all())}')
    if launched != (calls * spec.num_layers, calls):
      raise AssertionError(f'nano forecast {seed}: launches (C, B) {launched}, '
                           f'expected {(calls * spec.num_layers, calls)}')
    log(f'[nano serve] request {seed}: {ROLLOUT_STEPS}-step rollout '
        f'{tuple(forecast.shape)} float32, finite; {seconds:.3f} s '
        f'({seconds / ROLLOUT_STEPS:.3f} s per 12-hour step, '
        f'{1e3 * seconds / calls:.2f} ms per denoiser call); launches C '
        f'{launched[0]}, B {launched[1]}')
  return ms['kernel']


def fused_path(spec, statics, dev, card, f_seconds, f_peak):
  """Phase 17: the 1-degree training path with the fused attention backward
  (GENCAST_SPARSE_FUSED_BWD=1, set around the calls and restored after): 3
  steps through `train.main` with checkpoints every 2 steps, then a run to
  step 5 that resumes from the newest checkpoint, then `evaluate.main` on
  it (2 members, 2 steps). Returns each kernel's launches in the two
  training runs together."""
  from gencast_tpu_torch.nn import transformer
  from gencast_tpu_torch.ops import segment, sparse_attention
  from gencast_tpu_torch.training import checkpoint, evaluate
  work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'chip_smoke')
  shutil.rmtree(work, ignore_errors=True)
  ckpt, out = os.path.join(work, 'ckpt'), os.path.join(work, 'eval')
  jsonl = os.path.join(work, 'metrics.jsonl')
  argv = ['--preset', '1deg', '--clean_sst_nans', '--save_every', '2',
          '--ckpt_dir', ckpt, '--metrics_jsonl', jsonl]
  before = os.environ.get(transformer.FUSED_BWD_ENV)
  os.environ[transformer.FUSED_BWD_ENV] = '1'
  try:
    first, first_s, first_peak = train_preset(spec, statics, dev, card, argv,
                                              tag='1deg fused')
    second, second_s, second_peak = train_preset(
        spec, statics, dev, card, argv, steps_run=5, start=3,
        tag='1deg fused, resumed')
  finally:
    if before is None:
      del os.environ[transformer.FUSED_BWD_ENV]
    else:
      os.environ[transformer.FUSED_BWD_ENV] = before
  launches = {k: first[k] + second[k] for k in first}
  saved = checkpoint.all_steps(checkpoint.create_manager(ckpt))
  with open(jsonl) as f:
    events = [json.loads(line) for line in f]
  logged = [(e['event'], e['step']) for e in events]
  if saved != [2, 3, 4] or logged != [('train', i) for i in range(1, 6)] or \
      any(set(e) != {'event', 'step', 'time', 'loss', 'steps_per_sec'}
          for e in events):
    raise AssertionError(f'checkpoints at steps {saved}, metrics {events}')
  log(f'[train 1deg fused] seconds per step {[round(x, 4) for x in first_s]}'
      f' then {[round(x, 4) for x in second_s]} against kernel F\'s '
      f'{[round(x, 4) for x in f_seconds]} (phase 10); peak memory '
      f'{max(first_peak, second_peak) / 2**30:.2f} GiB against '
      f'{f_peak / 2**30:.2f} GiB; checkpoints kept at steps {saved}; {card}')

  members, rollout_steps = 2, 2
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  run = evaluate.main(['--preset', '1deg', '--ckpt_dir', ckpt,
                       '--num_members', str(members), '--max_rollout_steps',
                       str(rollout_steps), '--clean_sst_nans', '--out_dir',
                       out, '--plot_vars'])
  wall = time.perf_counter() - t0
  served = {c.name: c.launches for c in counters()}
  calls = members * rollout_steps * (2 * spec.num_noise_levels - 1)
  expected = {c.name: 0 for c in counters()}
  expected.update({sparse_attention.KERNEL.name: calls * spec.num_layers,
                   segment.KERNEL.name: calls})
  if served != expected:
    raise AssertionError(f'evaluate launches {served}, expected {expected}')
  state = torch.load(os.path.join(ckpt, 'step_4.pt'), weights_only=True)
  restored = {n: p.detach().cpu() for n, p in run.model.named_parameters()}
  if restored.keys() != state['params'].keys() or not all(
      torch.equal(restored[n], state['params'][n]) for n in restored):
    raise AssertionError('evaluate did not restore the saved parameters')
  with open(os.path.join(out, 'metrics.json')) as f:
    scores = json.load(f)
  rollout = np.load(os.path.join(out, 'rollout.npz'))
  layout = next(m for m in run.model.modules()
                if hasattr(m, 'target_layout')).target_layout
  # The synthetic fields of sea_surface_temperature are NaN over land, in
  # the truth and in the inputs (which InputsAndResiduals adds back to the
  # predicted residual), so there, as in the reference, the predictions are
  # NaN and the CRPS and spread (plain means) are NaN; the RMSE skips NaNs.
  preds, truth = rollout['predictions'], rollout['truth']
  nan_vars = {v for v in layout.var_names
              if np.isnan(truth[..., layout.var_channels(v)]).any()}
  finite_preds = bool((np.isfinite(preds) | np.isnan(truth)[None]).all())
  finite_scores = all(
      np.isfinite(scores['rmse'][v]) and (v in nan_vars or (
          np.isfinite(scores['crps'][v]) and np.isfinite(scores['spread'][v])))
      for v in layout.var_names)
  shape = (members, rollout_steps) + tuple(truth.shape[1:])
  if not (finite_preds and finite_scores and preds.shape == shape
          and shape[2:4] == (181, 360)):
    raise AssertionError(f'evaluate: scores {scores}, predictions '
                         f'{preds.shape}, finite where the truth is: '
                         f'{finite_preds}')
  log(f'[evaluate 1deg] step 4 restored exactly; {members} members x '
      f'{rollout_steps} steps {preds.shape}, finite where the truth is; '
      f'{wall:.1f} s with set-up; launches A '
      f'{served[sparse_attention.KERNEL.name]}, B '
      f'{served[segment.KERNEL.name]}, as derived; per-variable RMSE, '
      f'spread and CRPS finite but CRPS and spread of {sorted(nan_vars)} '
      f'(NaN over land); 2m_temperature RMSE '
      f'{scores["rmse"]["2m_temperature"]:.4f}, CRPS '
      f'{scores["crps"]["2m_temperature"]:.4f}, spread '
      f'{scores["spread"]["2m_temperature"]:.4f}')
  shutil.rmtree(work, ignore_errors=True)
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
  from gencast_tpu_torch.ops import banded_attention, cuda_lib, ln_film, \
      segment, sparse_attention

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
    if 'Compiling entry function' in line and kernel_name(line):
      entry = kernel_name(line)
    elif 'registers' in line or ('spill' in line
                                 and ' 0 bytes spill stores' not in line):
      log(f'[setup] ptxas {entry}: {line.split(":", 1)[-1].strip()}')
      if 'spill' in line and '_mma_' in entry:
        raise AssertionError(f'{entry} spills registers: {line.strip()}')
  log_sass_counts(cuda_lib.library()._name)
  # Dynamic shared memory of the bf16 dk/dv sweeps (kind 1 F, 2 G): the
  # stages, plus 8 bytes per slot of the tile's list.
  smem = {f'{name}<{hd}>': cuda_lib.library().gt_sparse_attention_bwd_smem(
      kind, 1, hd, 0) for name, kind in (('F-dk/dv', 1), ('G', 2))
          for hd in sparse_attention._HEAD_DIMS}
  log(f'[setup] bf16 dk/dv shared memory, bytes: {smem}, plus 8 per list '
      'slot')

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
  dense = dense_from_plan(plan, dev)
  allowed = int(plan.mask_tiles.sum(dtype=np.int64))  # per batch x head
  # And at head dim 32 on TINY's plan (162 nodes: 34 rows in the last tile):
  # every (dtype, head dim) the kernel is compiled for.
  tiny = dataclasses.replace(configs.TINY, attention_tile_size=64,
                             use_agg_plans=True, agg_plan_min_degree=2,
                             stochastic_churn_rate=2.5, num_noise_levels=2)
  tiny_statics = configs.build_statics(tiny)
  tiny_plan = tiny_statics.attention_tile_plan
  tiny_t = tuple(torch.as_tensor(a, device=dev) for a in (
      tiny_plan.mask_tiles, tiny_plan.fwd_kv_ids, tiny_plan.fwd_pair_ids,
      tiny_plan.bwd_q_ids, tiny_plan.bwd_pair_ids))
  tiny_n = tiny_statics.num_mesh_nodes
  tiny_shape = (tiny_n, tiny.num_heads, tiny.d_model // tiny.num_heads)
  tiny_dense = dense_from_plan(tiny_plan, dev)[:tiny_n, :tiny_n]
  tiny_allowed = int(tiny_plan.mask_tiles.sum(dtype=np.int64))
  for dtype, atol in ((torch.float32, ATTN_F32_ATOL),
                      (torch.bfloat16, ATTN_BF16_ATOL)):
    for rows in (n, plan.padded_n):
      results[('A', dtype, rows)] = check_attention(
          (rows, h, d), dtype, atol, mt, ids, pids, plan.tile, g,
          dense[:rows, :rows], allowed)
    check_attention(tiny_shape, dtype, atol, *tiny_t[:3], tiny_plan.tile, g,
                    tiny_dense, tiny_allowed)

  # --- 4. kernel B vs plain: the 1-degree training step's plans ---
  segment_results = check_segment_sums(spec, statics, g, card)

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

  tiny_cpu, _ = configs.build_gencast(tiny, seed=3, device='cpu')
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
  # At the transformer's padded n (the shape of the JSON rows), at the
  # mesh's ragged n, and at head dim 32 on TINY's plan, as phase 3.
  for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                      (torch.bfloat16, BWD_BF16_RTOL)):
    results[('F', dtype)] = check_attention_bwd(
        (plan.padded_n, h, d), dtype, rtol, mt, plan_t, plan.tile, g, dense,
        allowed)
    check_attention_bwd((n, h, d), dtype, rtol, mt, plan_t, plan.tile, g,
                        dense[:n, :n], allowed)
    check_attention_bwd(tiny_shape, dtype, rtol, tiny_t[0], tiny_t[1:],
                        tiny_plan.tile, g, tiny_dense, tiny_allowed)
  del dense

  # --- 8. kernel E vs plain at every shape of the training steps ---
  nano = configs.NANO
  nano_statics = configs.build_statics(nano)
  e_shapes = ln_film_shapes([(spec, statics), (nano, nano_statics)])
  e_results = check_ln_film_shapes(e_shapes, g, card)
  e_seen = set()

  # --- 9. TINY training step: card kernels vs CPU plain path ---
  for remat_policy in ('full', 'save_attention'):
    train_tiny_against_cpu(dev, remat_policy, configs.TINY)

  # --- 10. training: three full-width 1-degree steps through the CLI ---
  del model, stack
  with recording_ln_film_shapes(e_seen):
    one_deg_launches, one_deg_seconds, one_deg_peak = train_preset(
        spec, statics, dev, card, ['--preset', '1deg', '--clean_sst_nans'])

  # --- 11. kernel C vs plain: nano's shape and TINY's tri-block shape ---
  t0 = time.perf_counter()
  banded = {}
  for spec_b, st in ((nano, nano_statics),
                     (configs.TINY_TRIBLOCK,
                      configs.build_statics(configs.TINY_TRIBLOCK))):
    mask = st.attention_mask
    banded[spec_b.name] = (
        (mask.num_blocks * mask.block_size, spec_b.num_heads,
         spec_b.d_model // spec_b.num_heads),
        torch.as_tensor(mask.blocks.astype(np.uint8), device=dev),
        mask.block_size, dense_from_blocks(mask.blocks, dev),
        int(mask.blocks.sum(dtype=np.int64)))
  mask = nano_statics.attention_mask
  log(f'[statics] nano (TINY_TRIBLOCK\'s built in '
      f'{time.perf_counter() - t0:.1f} s): mesh '
      f'{nano_statics.num_mesh_nodes} nodes, tri-block mask '
      f'{list(mask.blocks.shape)} ({mask.num_padding_nodes} padding nodes, '
      f'{banded["nano"][4]} allowed entries), grid2mesh '
      f'{nano_statics.grid2mesh.num_edges} edges, mesh2grid '
      f'{nano_statics.mesh2grid.num_edges} edges')
  for name, (shape, mask_t, bs, dense_b, allowed_b) in banded.items():
    for dtype, atol in ((torch.float32, ATTN_F32_ATOL),
                        (torch.bfloat16, ATTN_BF16_ATOL)):
      results[('C', name, dtype)] = check_banded(
          shape, dtype, atol, mask_t, bs, g, dense_b, allowed_b)

  # --- 12. kernel D vs plain, from kernel C's lse ---
  for name, (shape, mask_t, bs, dense_b, allowed_b) in banded.items():
    for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                        (torch.bfloat16, BWD_BF16_RTOL)):
      results[('D', name, dtype)] = check_banded_bwd(
          shape, dtype, rtol, mask_t, bs, g, dense_b, allowed_b)
  del banded

  # --- 13. nano serving: the denoiser, then two 10-step forecasts ---
  nano_call_ms = serve_nano(dev, g)

  # --- 14. TINY tri-block training step: card kernels vs CPU plain path ---
  train_tiny_against_cpu(dev, 'full', configs.TINY_TRIBLOCK)

  # --- 15. training: three full-width nano steps through the CLI ---
  with recording_ln_film_shapes(e_seen):
    nano_launches, _, _ = train_preset(nano, nano_statics, dev, card,
                                       ['--preset', 'nano'])
  # Phase 8 checked kernel E at every shape these training steps gave it.
  if not e_seen <= set(e_shapes):
    raise AssertionError(f'training gave kernel E shapes that phase 8 did '
                         f'not check: {sorted(e_seen - set(e_shapes))}')
  log(f'[kernel E] the 1-degree and nano training steps gave it '
      f'{len(e_seen)} shapes, all checked in phase 8: {sorted(e_seen)}')

  # --- 16. kernel G and its dq reduce vs plain and vs kernel F, from
  # kernel A's lse: the shapes of phase 7 ---
  gather_t = tuple(torch.as_tensor(a, device=dev)
                   for a in plans.build_bwd_gather(plan))
  tiny_gather_t = tuple(torch.as_tensor(a, device=dev)
                        for a in plans.build_bwd_gather(tiny_plan))
  dense = dense_from_plan(plan, dev)
  for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                      (torch.bfloat16, BWD_BF16_RTOL)):
    results[('G', dtype)] = check_fused_bwd(
        (plan.padded_n, h, d), dtype, rtol, mt, plan_t, gather_t, plan.tile,
        g, dense, allowed)
    check_fused_bwd((n, h, d), dtype, rtol, mt, plan_t, gather_t, plan.tile,
                    g, dense[:n, :n], allowed)
    check_fused_bwd(tiny_shape, dtype, rtol, tiny_t[0], tiny_t[1:],
                    tiny_gather_t, tiny_plan.tile, g, tiny_dense,
                    tiny_allowed)
  del dense, gather_t, tiny_t, tiny_dense, tiny_gather_t

  # --- 17. the 1-degree path with the fused backward: train, resume,
  # evaluate ---
  fused_launches = fused_path(spec, statics, dev, card, one_deg_seconds,
                              one_deg_peak)

  # --- 18. nano training twice from one seed: equal bits; no float32 copy
  # of an edge array before kernel B ---
  casts, b_launches = count_edge_casts(['--preset', 'nano'], nano_statics,
                                       nano.d_model)
  if casts or not b_launches:
    raise AssertionError(f'nano training: {casts} casts of a planned edge '
                         f'array around {b_launches} launches of kernel B')
  log(f'[reproducible] nano: two training steps under torch.profiler cast '
      f'no planned edge array ([E, {nano.d_model}], E in '
      f'{{{nano_statics.grid2mesh.num_edges}, '
      f'{nano_statics.mesh2grid.num_edges}}}) around {b_launches} launches '
      f'of kernel B, which reads the bf16 edges itself')
  check_reproducible(['--preset', 'nano'], steps_run=2)

  # Rows at the shapes of the main paths, in the dtype they run: A and F at
  # the transformer's padded 1-degree shape in bf16, B on the grid2mesh
  # receiver plan from bf16 edges (float32 out), E in bf16 at the largest
  # shape it gets (the 1-degree mesh2grid edges; the mesh-node shape, 33 of
  # its 42 calls per 1-degree step, in extra fields), C and D at nano's
  # [1, 2624, 4, 64] in bf16, G and its dq reduce as A.
  # Launches come from the training runs of each kernel's paths (1 degree,
  # nano, and the 1-degree path with the fused backward), by path where a
  # kernel runs on more than one.
  bf16 = torch.bfloat16
  err_a, ms_a, cost_a = results[('A', bf16, plan.padded_n)]
  err_b, ms_b, cost_b = segment_results[('grid2mesh receivers', bf16)]
  err_e, ms_e, cost_e = e_results[
      ((statics.mesh2grid.num_edges, 1, spec.d_model), bf16)]
  _, ms_e_mesh, cost_e_mesh = e_results[
      ((1, plan.padded_n, spec.d_model), bf16)]
  errs_f, ms_f, costs_f = results[('F', bf16)]
  err_c, ms_c, cost_c = results[('C', 'nano', bf16)]
  errs_d, ms_d, costs_d = results[('D', 'nano', bf16)]
  errs_g, ms_g, costs_g = results[('G', bf16)]
  kernels = [
      row(sparse_attention.KERNEL, err_a, ms_a['kernel'], ms_a['plain'],
          ms_a['library'], *cost_a, bf16),
      dict(row(segment.KERNEL, err_b, ms_b['kernel'], ms_b['plain'],
               ms_b['library'], *cost_b, bf16),
           dtype='bfloat16 in, float32 out',
           cast_then_kernel_ms=ms_b['cast_then_kernel'],
           unsplit_ms=ms_b['unsplit'],
           float32_in_ms=segment_results[('grid2mesh receivers',
                                          torch.float32)][1]['kernel']),
      row(banded_attention.KERNEL, err_c, ms_c['kernel'], ms_c['plain'],
          ms_c['library'], *cost_c, bf16),
      row(banded_attention.KERNEL_DQ, errs_d['dq'][1], ms_d['dq'],
          ms_d['dq_plain'], ms_d['library'], *costs_d['dq'], bf16),
      row(banded_attention.KERNEL_DKV, errs_d['dkv'][1], ms_d['dkv'],
          ms_d['dkv_plain'], ms_d['library'], *costs_d['dkv'], bf16),
      dict(row(ln_film.KERNEL, err_e[1], ms_e['kernel'], ms_e['plain'],
               ms_e['library'], *cost_e, bf16),
           mesh_shape=[1, plan.padded_n, spec.d_model],
           mesh_ms=ms_e_mesh['kernel'],
           mesh_bound_ms=bound(*cost_e_mesh, bf16)[0],
           mesh_library_ms=ms_e_mesh['library']),
      row(sparse_attention.KERNEL_DQ, errs_f['dq'][1], ms_f['dq'],
          ms_f['dq_plain'], ms_f['library'], *costs_f['dq'], bf16),
      row(sparse_attention.KERNEL_DKV, errs_f['dkv'][1], ms_f['dkv'],
          ms_f['dkv_plain'], ms_f['library'], *costs_f['dkv'], bf16),
      row(sparse_attention.KERNEL_DKVQ, errs_g['G'][1], ms_g['kernel'],
          ms_g['plain'], ms_g['library'], *costs_g['G'], bf16),
      # No single PyTorch call computes the reduce: plain_ms is the
      # PyTorch-ops version (index_select, where, sum, scale, cast); its
      # adds are float32.
      dict(row(sparse_attention.KERNEL_DQ_REDUCE, errs_g['reduce'][1],
               ms_g['reduce'], ms_g['reduce_plain'], None,
               *costs_g['reduce'], torch.float32),
           library_note='no single PyTorch call computes it; plain_ms is '
           'the PyTorch-ops version'),
  ]
  for k in kernels:
    by_path = {'1deg': one_deg_launches[k['name']],
               'nano': nano_launches[k['name']],
               '1deg_fused': fused_launches[k['name']]}
    k['launches'] = sum(by_path.values())
    if sum(1 for n in by_path.values() if n) > 1:
      k['launches_by_path'] = by_path
    if k['launches'] == 0:
      raise AssertionError(f'{k["name"]} was not launched by training')
  log(f'[summary] 1-degree: seconds per request {seconds}; denoiser call '
      f'kernel path {denoiser_ms["kernel"]:.2f} ms, plain path '
      f'{denoiser_ms["plain"]:.2f} ms; nano denoiser call kernel path '
      f'{nano_call_ms:.2f} ms')
  print(json.dumps({'kernels': kernels}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
