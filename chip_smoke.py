"""Card-side check of the PyTorch/CUDA port: 1-degree GenCast and nano
GenCast, served and trained, the 1-degree train, resume and evaluate
path with the fused attention backward, the CUDA-graph replays of the
denoiser call and of the training step against their eager runs, and the
paper-scale 0.25-degree GenCast (QUARTER_DEG: streamed-edge GNNs, GNN
remat, a bf16 noise basis) served, trained and evaluated, nano and
1-degree GenCast trained and evaluated from ERA5-format directories, and
GraphCast (GraphCast_small at 1 degree, the 37-level paper configuration
at 0.25 degrees) served, trained (autoregressively too) and evaluated, the
reference's einsum attention backends, data-parallel training over ranks,
the member-sharded ensemble, a published-layout GenCast checkpoint
translated and served, the tracing tool and MFU accounting, the model
axis (tensor parallelism over heads and MLP hidden widths) in training,
the pod forecast and dryrun_multichip, the grid-node axis (the grid
nodes sharded over the model axis) at 1 degree and in dryrun_multichip,
and ensemble members sampled as one batch at nano, 1 degree and 0.25
degrees.

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
     each), each call a replay of the denoiser's CUDA graph (the first
     request captures it), then the first request again with
     graphed=False (eager) from the same generator seed: bitwise equal,
     kernel launch counts checked per request both ways, seconds per
     request both ways, the graph's capture time and private pool;
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
     of a 10-step (5-day) `rollout.sample_rollout` (graph replays), and the
     first again with jit=False (eager), bitwise equal, with 6,240 launches
     of C and 390 of B each, finite float32 output of the right shape,
     seconds per request both ways;
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
 17. the 1-degree path under GENCAST_SPARSE_FUSED_BWD=1, at CUT_LAYERS
     layers: `train.main` for 3 steps with checkpoints every 2 steps and
     a metrics file, then a run to
     step 5 that resumes at step 3 from the newest checkpoint (G and its
     reduce once per layer and step each, F never, launches checked per
     step),
     seconds per step and peak memory beside phase 10's; then
     `evaluate.main` on the checkpoint:
     a 2-member, 2-step 1-degree ensemble, its members as one batch (A 312
     and B 78 launches: a batched call launches as a one-member call) from
     the parameters saved, with finite scores and predictions
     [2, 2, 181, 360, C];
 18. reproducibility: two full-width nano training steps through
     `train.main`, run twice from the same seed, leave bitwise equal losses
     and parameters (no aggregation adds atomically), each step followed by
     a sampling eval (`--do_sampling_eval --eval_every 1`) whose serving
     copy is refreshed in place: one capture of the denoiser call over a
     run's two evals; before them, two steps under torch.profiler cast no
     planned edge array (kernel B reads the bf16 edges itself);
 19. fused training (`steps.scanned_train_steps`, the CLI's
     --steps_per_call): at nano and at 1 degree, two calls of 4 steps that
     replay one CUDA graph of the whole training step against 4 + 4 eager
     steps of an identical twin on the same pool rows and step generators
     (losses and all parameters bitwise equal after each call, launches per
     step as derived), seconds per step both ways, the capture time, the
     graph's private pool and the peak memory; then 2 steps at 1 degree
     under GENCAST_SPARSE_FUSED_BWD=1 (kernel G and its dq reduce
     replayed), the same checks;
 20. the training CLI's fused path: `train.main --preset nano
     --steps_per_call 2 --save_every 2` for 4 steps, then a run to step 6
     that resumes at step 4 through the fused path, launches per step
     checked, checkpoints at steps 1, 3 and 5;
 21. the 0.25-degree statics: built (the run's statics cache under
     build/ is empty at its start), then loaded from the cache, the same
     arrays, by a process of its own that sees no card, started after
     phase 1 so that it runs beside phases 2-20; loaded here; their
     counts;
 22. kernels at the 0.25-degree shapes against their plain versions,
     float32 and bf16, with timings, bounds and library calls: A and F at
     [1, 41024, 4, 128] on the 0.25-degree plan and at the ragged 40,962;
     B on the receiver and sender plans of the grid2mesh chunk with the
     longest receiver row; E at every shape the 0.25-degree training step
     gives it (edge chunks, grid-node chunks, the mesh, the transformer),
     and one kernel per E call at these shapes under torch.profiler in a
     fresh python3 process (a profiler session that is not its process's
     first may record fewer kernels than were launched), a check whose
     time is no metric, run in phase 42 beside the pod forecast's ranks
     (its line there);
 23. the QUARTER_DEG denoiser (seeded, perturbed, bf16 stack) through the
     kernels against the plain path (A 16, B 13 launches: one per grid2mesh
     chunk); one call at batch 2 (two rows, each its own noise level: the
     streamed chunks at a batch) against two batch-1 calls of the same
     rows, each row bitwise or within MEMBER_BATCH_RTOL, A 16 and B 13
     launches, its peak memory; the 1-degree denoiser with streamed edges
     against the dense one, float32, the same weights;
 24. serving: one 0.25-degree 12-hour forecast step graphed, then eagerly
     from the same generator seed: bitwise equal, A 624 and B 507 launches
     each, seconds both ways, the capture, its pool, the peak memory;
 25. training (phases 25 and 26 at CUT_LAYERS layers): `train.main
     --preset 0.25deg` for 2 steps (checkpoint at
     the end; kernel E sees exactly phase 22's shapes), the same 2 steps
     again from the seed (bitwise equal), and 2 graphed steps against 2
     eager steps of a twin (bitwise equal),
     launches per step as derived in each, seconds per step, peak memory;
 26. `evaluate.main --preset 0.25deg --chunk_size 1` on phase 25's
     checkpoint: 1 member, 2 steps, launches as derived, finite where the
     truth is, the wall and the peak memory;
 27. `rollout.chunked_rollout` at nano, 4 steps in chunks of 2, the host
     copies overlapped and serialized: both bitwise the unchunked rollout;
 28. ERA5-format corpora: `tools.synth_era5 --layout npz` writes a
     2.5-degree corpus (2 months x 10 frames) and a 1-degree one (6
     frames), the seconds of each write; where h5py imports, also the
     2.5-degree corpus as NetCDF files (its source gives the npz source's
     windows) and a published-structure stats directory, else one line
     says they did not run;
 29. nano (at CUT_LAYERS layers) from the 2.5-degree directory through
     `python3 -m gencast_tpu_torch.training.train`, each run a fresh
     process: 16 steps
     with --prefetch 2 --data_workers 2 --profile_dir and checkpoints, the
     same 16 steps with --prefetch 0 --data_workers 0 (bitwise equal losses
     and checkpoints), a resume to step 20 (its losses equal the same steps
     taken in this process from the checkpoint); the trace holds B, C, D
     and E for steps 10-15 in the derived counts, and each run's launches
     (and the 4 steps' taken here) are the derived counts per step; the
     kernels line's `nano_era5` counts the CLI processes' launches only;
     packing ms per batch, worker
     start-up, batch wait and step ms with and without prefetch and
     workers;
 30. full-width 1 degree (at CUT_LAYERS layers) from the 1-degree
     directory in this process:
     `train.main` for 3 steps (A, B, E and F launches per step as derived)
     and `evaluate.main` on its checkpoint, 1 member x 2 steps (finite
     where the truth is; --save_netcdf where h5py imports), walls and peak
     memory;
 31. GraphCast_small's 1-degree statics (the multimesh of levels 0-5:
     81,900 edges into 10,242 nodes; no attention mask), built, then
     loaded from the cache under their own key; TISR for one 1-degree
     frame on the CPU and on the card (and one 0.25-degree frame on the
     card), and a GraphCast window packed with TISR on each; kernel B
     against its plain version on the multimesh receiver and sender plans
     and the grid2mesh receiver and sender plans, float32 and bf16 in, as
     phase 4;
 32. GraphCast_small served (seeded, perturbed, bf16 stack): a forecast
     step through the kernels against the plain path, 17 B launches per
     step as derived; a 4-step `rollout.predict_rollout` replaying the
     model's CUDA graph against the eager rollout (bitwise equal) and
     `chunked_rollout(mode='predict', chunk_size=2)` (bitwise equal); ms
     per step graphed, eager, plain, and of the graph's replay alone;
 33. GraphCast_small (at CUT_LAYERS processor steps) trained through
     `train.main --model graphcast --preset 1deg`: 4 eager steps, each
     followed by a sampling eval (a predict graph captured, then
     replayed, while --prefetch's thread packs windows, TISR on the card;
     batch waits logged); 4 with --steps_per_call 2 (graph replays),
     bitwise the eager ones, and again from the seed; --ar_steps
     2 for 4 steps with a checkpoint, resumed to step 5; --ar_steps 2
     --steps_per_call 2, bitwise the eager AR steps; B launches per step as
     derived (52, 138 with the AR loss), no other kernel; then
     `evaluate.main --model graphcast` on the checkpoint, 2 steps;
 34. the paper's GraphCast at 0.25 degrees (`--preset 0.25deg --task
     graphcast_37 --remat_group 4`: streamed grid2mesh and mesh2grid,
     grouped processor remat): its statics built; kernel B against its
     plain version on the splits-6 multimesh's receiver and sender plans
     (327,660 edges into 40,962 nodes), as phase 31; one forecast step
     graphed and eagerly (bitwise equal), and through the plain path
     within the bf16 tolerance; then 2 training steps through the CLI, B
     launches as derived, peak memory;
 35. the reference's einsum attention backends (plain PyTorch) against the
     kernels' on the same bridged weights, bf16, one denoiser call each:
     nano 'triblock' against 'triblock_pallas' (kernel C), 1 degree
     'dense' against 'pallas' (kernel A; the dense k-hop mask first held to
     the tile plan's allowed entries on the host), with times and peak
     memory; then `--preset tiny` (the reference's TINY: einsum
     'triblock') trained 2 steps and evaluated through the CLIs on the
     card, B and E launches as derived;
 36. data parallel at 1 degree, full width and depth, batch 2, through
     `python3 -m gencast_tpu_torch.training.train`: `--dp 2` (two ranks on
     cuda:0, gloo) against one process, bf16 losses within DP_LOSS_RTOL;
     `--multihost --num_processes 1` (one NCCL rank) bitwise the one
     process; the float32 pair's losses and parameter changes within the
     TINY training tolerances (its --dp 2 run beside the one-process
     runs); A, F, B and E launches per rank-step as derived at batch 1;
     then `--dp 2 --profile_dir` for 16 steps: the all-reduce's share of a
     step and the kernels of steps 10-15 in each rank's trace;
 37. the member-sharded ensemble: `python3 -m
     gencast_tpu_torch.scripts.ensemble_forecast_pod --preset 1deg
     --members 2 --steps 2 --score` on two ranks on cuda:0 (one member per
     rank and call, as the reference's pod): the members bitwise the
     one-device `parallel.ensemble.ensemble_rollout` run one member per
     call, the scores
     reduced on the devices within POD_SCORE_RTOL of `ops.metrics`, A and B
     launches per rank as derived, seconds per member-step;
 38. a published GenCast checkpoint at 1 degree, full width and depth: a
     seeded, perturbed ONE_DEG model written as a DeepMind CheckPoint npz
     in the published layout (`published_checkpoint`: the reference's
     module names, Haiku's flat module paths and w/b leaves, the mesh
     embedder's dummy input rows, sampler, noise and architecture
     configs); `python3 -m gencast_tpu_torch.tools.translate_checkpoint
     --preset 1deg` in a fresh process; its step_0.pt restored into a
     model of another seed, every parameter bitwise the source's; one
     graphed denoiser call and one sampled 12-hour step from one generator
     bitwise the source model's, A and B launches per call (16, 1) and
     step as derived; `python3 -m gencast_tpu_torch.training.evaluate
     --preset 1deg --ckpt_dir` in a fresh process (1 member x 1 step)
     restores step 0 and writes finite scores; each stage's seconds and
     the npz's size (run inside phase 42, beside the pod forecast's
     ranks: checks whose time is no metric; its seconds on the [time]
     line's note);
 39. `python3 -m gencast_tpu_torch.tools.trace_sampler
     build/chip_smoke_trace_1deg 1deg` in a fresh process (`profile_step
     --mode sample --steps 1`: the CLIs' serving stack): the trace file
     exists and `trace_qdeg.parse` finds kernel A 16 times per denoiser
     call and B once over the 39 calls of the traced step; then an [mfu]
     line (model FLOPs from `training/flops.py`, TFLOP/s, MFU against the
     H100 SXM's dense bf16 peak, the card's name and power limit) for the
     1-degree denoiser call, forecast step and training step, the nano
     training step, the 0.25-degree denoiser call and training step, and
     GraphCast_small's forward and training step, each from times the
     phases above measured (no run is added);
 40. the model axis at 1 degree, full width and depth, batch 1, through
     `python3 -m gencast_tpu_torch.training.train --mp 2` (two ranks on
     cuda:0, gloo, eager; each holds 2 of the 4 heads and half of every
     MLP hidden width) against one process: bf16 losses within
     DP_LOSS_RTOL; the float32 pair at CUT_LAYERS layers, both with
     GENCAST_SPARSE_FUSED_BWD=1 (kernel G and its reduce), losses and
     parameter changes within the TINY training tolerances (its --mp 2 run
     beside the one process's float32 run and the evaluate, and phase 42's
     dryrun_multichip beside them); launches per
     rank-step as derived (A 16, F 16 + 16, B 4, E 42 at full depth), in
     each rank's trace of steps 1-2 too (`--profile_dir --profile_steps 1
     2`); the --mp 2 checkpoint restored by a --mp 1 evaluate; seconds per
     step, the model axis's all-reduces per step (calls and bytes; their
     share of a step from the traces) and peak memory per rank;
 41. kernels A and F at [1, 10304, 2, 128] and [1, 10304, 1, 128], C and D
     at [1, 2624, 2, 64] and [1, 2624, 1, 64] (one rank's heads under a
     model axis of 2 and 4), float32 and bfloat16, against their plain
     versions, with card ms, bound and library ms; phase 43's kernel B on
     each rank's plans;
 42. `python3 -m gencast_tpu_torch.scripts.ensemble_forecast_pod --preset
     nano --members 2 --steps 2 --score` on four ranks (ensemble 2 x model
     2): each member saved once, within POD_MP_RTOL of the one-device
     member (run one member per call, as each rank runs its member),
     scores within POD_SCORE_RTOL of `ops.metrics`, C and B
     launches per rank as derived, while phase 38 and phase 22's profiler
     check run here beside its ranks; `python3 -m
     gencast_tpu_torch.tools.dryrun_multichip 8` in a fresh process, mesh
     (2, 2, 2), the grid nodes sharded over the model axis, every kernel
     of its paths launched, B on the TINY kernel path as derived from each
     rank's grid rows (run beside phase 40's float32 --mp 2 run);
     GraphCast_small at one processor step (GC_MP_LAYERS) trained 2 steps
     under --mp 2 (started with the pod, beside it and phases 38 and 43),
     B per rank-step as derived;
 43. the grid-node axis at 1 degree, full width, CUT_LAYERS layers (phase
     40 drives the model axis at full depth; a rank's grid rows and edges
     do not depend on the depth)
     (`DenoiserConfig.node_sharding_axis='model'`), through the Python API:
     kernel B on the plans of each rank's edges (float32 and bf16 against
     its plain version, with card ms, bound and library ms; run in phase
     41, alone); then, inside phase 42 beside GraphCast's --mp 2 ranks, in
     this process and on two spawned ranks on cuda:0 (gloo, eager; each holds
     half the grid's latitude rows, 2 of the 4 heads and half of each
     transformer MLP's hidden width), all from perturbed weights: a
     denoiser call in bf16 and float32, the ranks' within NODE_BF16_RTOL
     and NODE_F32_RTOL of one process's; two float32 training steps, the
     losses within TRAIN_LOSS_RTOL, every first gradient within
     NODE_GRAD_RTOL and every parameter's change (root-sum-square) within
     TRAIN_STEP_RTOL of one process's; two bf16 training steps whose losses agree within
     DP_LOSS_RTOL; launches per rank-step as derived (at 16 layers A 16, F
     16 + 16, B 4, E 42) and the model axis's all-reduces per rank-step as
     derived (71 at 16 layers, 23 at 4); all-reduce bytes and peak memory
     per rank-step, and its seconds (no metric beside the other ranks);
 44. ensemble members as one batch (`rollout.sample_rollout` given
     `generators`; the JAX package's vmapped ensemble): kernels A at
     [4, 10304, 4, 128] and the ragged [4, 10242, 4, 128], C at
     [8, 2624, 4, 64], B on the 1-degree and nano grid2mesh receiver plans
     at f = 4 x 512 and 8 x 512, float32 and bf16, against their plain
     versions with card ms, bound and library ms; then nano 8 members x 2
     steps and 1 degree 4 members x 1 step (seeded, perturbed bf16 stacks,
     graphed), each member run alone, then all as one batch twice (the
     first captures the batch's graph; the two bitwise equal): each member
     bitwise its one-member run or within MEMBER_BATCH_RTOL (the largest
     error logged), launches per batched call as derived (C 16 and B 1 at
     nano, A 16 and B 1 at 1 degree), seconds per member-step both ways,
     each graph's capture seconds and private pool, peak memory both ways;
then a [time] line (the seconds of each phase), one JSON line of kernel
results (launches from the training runs of each kernel's paths, eager and
graphed), the card's name and power limit, and a last JSON line
{"ok": true, "device": {...}}.

Each kernel's row also gives its bound (the least time the card could take
for the same work: the larger of the bytes it must move over 3.35 TB/s and
the operations on the allowed entries over 989 TFLOP/s bf16 or 67 TFLOP/s
float32) and the time of one PyTorch call computing the same function, timed
in turns with the kernel (scaled_dot_product_attention with the dense mask
and its backward, segment_reduce, native_layer_norm_backward; none for
G's dq reduce, whose row says so); the port never calls those. TF32 is off
for matmuls and cuDNN: float32 products run in full float32. Phases 17,
20, 25, 26, 28-30 and 33-43 write under build/ (git-ignored) and remove
what they wrote;
the graph statics are cached under build/chip_smoke_cache for the run and
removed at its end. Checks whose time is no metric run beside work whose
time is no metric either (the [time] line notes each phase run inside
another). About eighteen minutes on an H100, build included.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import signal
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
# The LN+FiLM forward kernel against its plain version, which it differs
# from only in the float32 summation order of the two means. In bf16 that
# flips the rounding of x_hat on a few elements in 10^5 (FWD_BITWISE_SHARE
# of them keep their bits), by at most one rounding step of bf16 at the
# element's magnitude: eps * (|y| + |scale| (|x_hat| + 1)). In float32
# x_hat keeps every ulp the sums move (a third of the elements in a CPU
# emulation differ), so there the kernel is held to the float64 evaluation
# of the op order: no further from it than FWD_F32_ERR_RATIO times the
# plain version is. Both dtypes are also held bitwise to the plain op order
# in the kernel's summation order (ln_film_fwd_lane_order).
FWD_BITWISE_SHARE = 0.999
FWD_F32_ERR_RATIO = 2.0
# The member batch of the forward kernel's checks: the 1-degree forecast
# cell's.
FWD_MEMBERS = 8
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
# The depth of the CLI phases whose full-width, full-depth path another
# phase covers (17: phases 10 and 19; 25-26: phases 22-24; 29: phases 13,
# 15 and 18-20; 30: phase 10; 33, GraphCast's processor steps: phases 32
# and 34; the float32 pairs of 36 and 40: their bf16 runs): the same
# width, grid and mesh, 4 of the 16 layers.
CUT_LAYERS = 4
# Phases 36 and 40: 1-degree steps of each run over ranks (phase 36's
# bf16 runs take 16), and its per-step bf16 losses against one process of
# the same global batch, max relative: a rank's batch-1 GEMMs and the rank
# average round otherwise than one batch-2 step (the float32 pairs are
# held to TRAIN_LOSS_RTOL and, for the parameters, TRAIN_STEP_RTOL).
DP_STEPS = 3
DP_LOSS_RTOL = 1e-3
# Phase 37: the pod forecast's scores on the devices (latitude bands, sums
# across ranks) against ops.metrics on the gathered members, max relative:
# float32 sums in another order.
POD_SCORE_RTOL = 1e-5
# Forecast steps of phase 13's requests: 10 x 12 hours, 5 days.
ROLLOUT_STEPS = 10
# The 1-degree denoiser with streamed edges against the dense one (phase
# 23), float32 on the card, max|streamed - dense| / max|dense|: the same
# arithmetic but for the order of the grid2mesh sums (per chunk, then
# across chunks), carried through 16 layers.
STREAMED_F32_RTOL = 1e-4
# Its chunk: grid2mesh's 1-degree edges in 4 chunks, mesh2grid's in 6, so
# receivers straddle chunks.
ONE_DEG_CHUNK = 32 * 1024
# Forecast steps of phase 27's chunked rollouts (chunks of 2).
OFFLOAD_STEPS = 4
# ERA5-format corpora of phases 28-30 (resolution, months, frames per
# month): 2.5 degrees, 2 x 10 frames (18 training windows, across a month
# boundary); 1 degree, 6 frames (4 windows; one 2-step evaluate window):
# 82 channels x 65,160 points x 4 bytes, 21 MB a frame.
ERA5_CORPORA = {'nano': (2.5, ('202001', '202002'), 10),
                '1deg': (1.0, ('202001',), 6)}
# Phase 29: the CLI's steps, then the step its resume runs to.
ERA5_NANO_STEPS = 16
ERA5_RESUME_STEPS = 20
# Kernel symbols in a torch.profiler trace, by launch counter.
TRACE_KERNELS = {
    'sparse_attention_fwd': r'sparse_attention_fwd_(mma_)?kernel',
    'sparse_attention_bwd_dq': r'sparse_attention_dq_(mma_)?kernel',
    'sparse_attention_bwd_dkv': r'sparse_attention_dkv_(mma_)?kernel',
    'sparse_attention_bwd_dkvq': r'sparse_attention_dkvq_(mma_)?kernel',
    'sparse_attention_dq_reduce': r'sparse_attention_dq_reduce_kernel',
    'segment_sum': r'segment_sum_kernel',
    'ln_film_bwd': r'ln_film_bwd_kernel',
    'ln_film_fwd': r'ln_film_fwd_kernel',
    'banded_attention_fwd': r'banded_attention_fwd_(mma_)?kernel',
    'banded_attention_bwd_dq': r'banded_attention_dq_(mma_)?kernel',
    'banded_attention_bwd_dkv': r'banded_attention_dkv_(mma_)?kernel',
}


def log(*args):
  print(*args, flush=True)


def cut_depth(spec):
  """`spec` at CUT_LAYERS layers: the same width, grid and mesh."""
  return dataclasses.replace(spec, num_layers=CUT_LAYERS)


class PhaseClock:
  """The seconds each phase took, by its number, for the [time] line."""

  def __init__(self):
    self.seconds = {}
    self.inside = {}
    self.last = time.perf_counter()

  def done(self, phase: int) -> None:
    now = time.perf_counter()
    self.seconds[phase] = round(now - self.last, 1)
    self.last = now

  def beside(self, phase: int, host: int, seconds: float) -> None:
    """`phase` ran inside phase `host` (beside its ranks), `seconds` of
    the host's wall."""
    self.inside[phase] = (host, round(seconds, 1))

  def line(self, card: str) -> str:
    inside = ''.join(f'; phase {p} inside phase {h} ({s} s of it)'
                     for p, (h, s) in self.inside.items())
    return (f'[time] seconds by phase {json.dumps(self.seconds)}; total '
            f'{sum(self.seconds.values()):.1f}{inside}; {card}')


def card_line() -> str:
  done = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True, timeout=60)
  return done.stdout.strip().splitlines()[0]


KERNEL_NAME = re.compile(
    r'((?:sparse|banded)_attention_(?:fwd|dq_reduce|dq|dkvq|dkv)'
    r'(?:_mma)?_kernel|segment_sum_kernel|ln_film_(?:bwd|fwd)_kernel)'
    r'(?:I(.*?)EEv)?')


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


def nan_tailed(shape, count, dtype, g, dev, tail, batch=1):
  """`count` seeded normal tensors [batch, *shape] in `dtype`, each the head
  of a buffer `tail` rows longer whose tail is NaN: a kernel that read a
  row past the last (of the last batch entry) would carry it into its sums
  (0 * NaN)."""
  rows = batch * shape[0]
  bufs = [torch.randn((rows + tail,) + shape[1:], generator=g, device=dev)
          .to(dtype) for _ in range(count)]
  for x in bufs:
    x[rows:] = float('nan')
  return [x[:rows].view((batch,) + tuple(shape)) for x in bufs]


def check_attention(shape, dtype, atol, mt, ids, pids, tile, g, dense,
                    allowed, reps=10, batch=1):
  """Kernel A against its plain version on seeded q/k/v [batch, *shape] with
  NaN behind the last row: o, lse on the rows that see a key, and o = 0 and
  lse ~ -1e30 on the others. Returns (max abs err, {'kernel': ms,
  'plain': ms, 'library': ms}, bound inputs (flops, bytes)). `dense` is the
  [n, n] boolean mask and `allowed` its entry count, for the library call
  and the bound."""
  from gencast_tpu_torch.ops import sparse_attention
  q, k, v = nan_tailed(shape, 3, dtype, g, mt.device, tile, batch)
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
      'library': lambda: sdpa_forward(*sdpa)}, reps=reps)
  h, d = shape[1], shape[2]
  cost = (4 * d * allowed * h * batch,
          nbytes(q, k, v, mt, ids, pids, got, lse))
  log(f'[kernel A] {dtype} [{batch}, {", ".join(map(str, shape))}]: max abs '
      f'err {err:.3e} (tol {atol}), lse {lse_err:.3e} (tol {ATTN_F32_ATOL}); '
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
                        allowed, reps=5):
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
      'dq': lambda: sa.sparse_attention_dq_cuda(*dq_args)}, reps=reps)
  ms.update(time_in_turns({
      'dkv_plain': lambda: sa.sparse_attention_dkv_plain(*dkv_args),
      'dkv': lambda: sa.sparse_attention_dkv_cuda(*dkv_args)}, reps=reps))
  ms['library'] = library_backward_ms(q, k, v, dout, dense, reps=reps)
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


def check_ln_film_shapes(shapes, g, card, profiled=None):
  """Phases 8 and 22: kernel E at every shape, float32 and bf16, against its
  plain version and twice for equal bits (check_ln_film_bwd); one call of
  each under torch.profiler must run exactly one kernel, E's; a call
  captured in a CUDA graph and replayed twice gives the eager call's bits.
  Returns {(shape, dtype): check_ln_film_bwd's result}.

  Phase 22 (the 0.25-degree shapes) passes `profiled`, a note saying where
  its profiler check runs instead: in a new python3 process
  (`start_ln_film_profile`), which loads the kernels already built under
  build/. A torch.profiler session that is not its process's first may
  record fewer kernels than were launched: in this process, one of 14
  calls in an H100 run; in a tool that opened several sessions in one
  process, 13 of 14 in later sessions whatever ran between them, while
  every process's first session recorded all 14."""
  from gencast_tpu_torch.ops import ln_film
  results, calls = {}, []
  for shape, axis in shapes:
    for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                        (torch.bfloat16, BWD_BF16_RTOL)):
      res = check_ln_film_bwd(shape, axis, dtype, rtol, g)
      results[(shape, dtype)] = res[:3]
      calls.append((res[3], axis))
  torch.cuda.synchronize()
  if profiled is None:
    profiled = profile_ln_film_calls(calls)
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
  log(f'[kernel E] {len(shapes)} shapes x 2 dtypes: {profiled}; a call '
      f'captured in a CUDA graph and replayed twice gives the eager bits; '
      f'{card}')
  return results


def profile_ln_film_calls(calls) -> str:
  """Runs each kernel E call ((x, dy, scale), batch axis) once under
  torch.profiler; raises unless every call ran exactly one kernel, E's."""
  from gencast_tpu_torch.ops import ln_film
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
    raise AssertionError(f'kernel E: {len(calls)} calls ran '
                         f'{len(kernels)} kernels under the profiler: '
                         f'{sorted(set(kernels))}')
  return (f'one kernel per call under torch.profiler ({len(kernels)} '
          f'calls, {len(kernels)} ln_film_bwd_kernel launches)')


def profile_ln_film_main(shapes_json: str) -> int:
  """`python3 chip_smoke.py --profile-ln-film SHAPES`: kernel E on seeded
  inputs at each ([shape], batch axis) of SHAPES, float32 and bf16, under
  the process's only torch.profiler session (profile_ln_film_calls)."""
  dev = torch.device('cuda', 0)
  g = torch.Generator(device=dev).manual_seed(0)
  calls = []
  for shape, axis in json.loads(shapes_json):
    b, c = shape[axis], shape[2]
    for dtype in (torch.float32, torch.bfloat16):
      x = torch.randn(shape, generator=g, device=dev).to(dtype)
      dy = torch.randn(shape, generator=g, device=dev).to(dtype)
      scale = (1 + 0.1 * torch.randn((b, c), generator=g, device=dev)
               ).to(dtype)
      calls.append(((x, dy, scale), axis))
  print(profile_ln_film_calls(calls), flush=True)
  return 0


def start_ln_film_profile(shapes):
  """profile_ln_film_main in a new python3 process in a session of its own,
  started here and waited for by finish_ln_film_profile: a check whose
  time is no metric (phase 22's shapes; it runs in phase 42 beside the pod
  forecast's ranks, whose times are no metric either). Returns (process,
  start time)."""
  proc = subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), '--profile-ln-film',
       json.dumps([[list(shape), axis] for shape, axis in shapes])],
      cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, start_new_session=True)
  STARTED.append(proc)
  return proc, time.perf_counter()


def finish_ln_film_profile(job, shapes, card) -> None:
  """Waits for start_ln_film_profile's process; raises if it failed."""
  proc, t0 = job
  stdout, stderr = proc.communicate(timeout=600)
  if proc.returncode:
    raise AssertionError(f'kernel E under torch.profiler in a fresh process: '
                         f'exit {proc.returncode}\n{stdout[-2000:]}'
                         f'\n{stderr[-4000:]}')
  log(f'[kernel E] {len(shapes)} 0.25-degree shapes x 2 dtypes: '
      f'{stdout.strip().splitlines()[-1]} in a fresh process beside phase '
      f'42\'s pod forecast (done {time.perf_counter() - t0:.1f} s after its '
      f'start); {card}')


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


def ln_film_fwd_lane_order(x, scale, offset, batch_axis) -> torch.Tensor:
  """The plain LN+FiLM forward's op order (ln_film.ln_film_forward) with the
  forward kernel's summation order: each lane of a row's warp adds the
  elements of its 16-byte vectors (vector lane + 32 j) in turn, then the
  lanes' sums fold by the xor butterfly. On the card each op here rounds as
  the kernel's does, so the two agree bit for bit."""
  from gencast_tpu_torch.ops import ln_film
  lead, c = x.shape[:-1], x.shape[-1]
  vec = 16 // x.element_size()
  nvec = c // vec
  nv = -(-nvec // 32)
  x32 = x.float()
  lanes = torch.zeros(lead + (nv * 32, vec), device=x.device)
  lanes[..., :nvec, :] = x32.reshape(lead + (nvec, vec))
  lanes = lanes.reshape(lead + (nv, 32, vec)).transpose(-3, -2).reshape(
      lead + (32, nv * vec))
  partner = {off: torch.arange(32, device=x.device) ^ off
             for off in (16, 8, 4, 2, 1)}

  def row_sum(v):
    s = v[..., 0]
    for i in range(1, v.shape[-1]):
      s = s + v[..., i]
    for off in (16, 8, 4, 2, 1):
      s = s + s[..., partner[off]]
    return s[..., :1]

  mu = row_sum(lanes) * (1.0 / c)
  var = (row_sum(lanes * lanes) * (1.0 / c) - mu * mu).clamp_min(0.0)
  x_hat = ((x32 - mu) * torch.rsqrt(var + ln_film.EPS)).to(x.dtype)
  per_batch = (lambda v: v[None]) if batch_axis == 1 else (
      lambda v: v[:, None])
  return x_hat * per_batch(scale) + per_batch(offset)


def ln_film_fwd_inputs(shape, batch_axis, dtype, g):
  """Seeded x [shape] (mean 0.5, std 2), scale (about 1) and offset (about
  0) [B, C] in `dtype` on g's device."""
  dev = g.device
  b, c = shape[batch_axis], shape[2]
  x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
  scale = (1 + 0.1 * torch.randn((b, c), generator=g, device=dev)).to(dtype)
  offset = (0.1 * torch.randn((b, c), generator=g, device=dev)).to(dtype)
  return x, scale, offset


def check_ln_film_fwd(shape, batch_axis, dtype, g):
  """The LN+FiLM forward kernel on seeded inputs (ln_film_fwd_inputs):
  * bitwise the plain op order in the kernel's summation order
    (ln_film_fwd_lane_order), every element;
  * against the plain version (ln_film_forward): in bf16 bitwise on at
    least FWD_BITWISE_SHARE of the elements and within one rounding step
    of bf16 at the element's magnitude on the others; in float32 no
    further from the op order evaluated in float64 than FWD_F32_ERR_RATIO
    times the plain version is;
  * equal bits on a second launch; at a batch, the first and last
    members' rows launched alone equal to theirs in the batch.
  Returns ({'bitwise_share', 'max_err', 'steps'}, {'kernel': ms, 'plain':
  ms}, bound inputs (flops, bytes))."""
  from gencast_tpu_torch.ops import ln_film
  x, scale, offset = ln_film_fwd_inputs(shape, batch_axis, dtype, g)
  b = shape[batch_axis]
  got = ln_film.ln_film_fwd_cuda(x, scale, offset, batch_axis)
  again = ln_film.ln_film_fwd_cuda(x, scale, offset, batch_axis)
  ordered = ln_film_fwd_lane_order(x, scale, offset, batch_axis)
  want = ln_film.ln_film_forward(x, scale, offset, batch_axis)
  members = []
  for m in sorted({0, b - 1}) if b > 1 else ():
    alone = ln_film.ln_film_fwd_cuda(
        x.narrow(batch_axis, m, 1).contiguous(), scale[m:m + 1],
        offset[m:m + 1], batch_axis)
    members.append(torch.equal(alone, got.narrow(batch_axis, m, 1)))
  torch.cuda.synchronize()
  same = torch.equal(got, again)
  exact = torch.equal(got, ordered)
  equal = got == want
  share = float(equal.float().mean())
  err = float((got.float() - want.float()).abs().max())
  if dtype == torch.bfloat16:
    mu, rstd = ln_film._mean_rstd(x.float(), ln_film.EPS)
    per_batch = scale[None] if batch_axis == 1 else scale[:, None]
    step = torch.finfo(dtype).eps * (
        want.float().abs()
        + per_batch.float().abs() * (((x.float() - mu) * rstd).abs() + 1))
    steps = float(((got.float() - want.float()).abs() / step).max())
    close = share >= FWD_BITWISE_SHARE and steps <= 1
    del mu, rstd, step
  else:
    ref = ln_film.ln_film_forward(x.double(), scale.double(),
                                  offset.double(), batch_axis)
    plain_err = float((want.double() - ref).abs().max())
    steps = float((got.double() - ref).abs().max()) / max(plain_err, 1e-30)
    close = steps <= FWD_F32_ERR_RATIO
    del ref
  if not (exact and close and same and all(members)):
    raise AssertionError(
        f'LN+FiLM forward kernel {dtype} {list(shape)} (batch axis '
        f'{batch_axis}): bitwise the lane-order plain op order {exact}; '
        f'against the plain version {share:.6f} of the elements bitwise, '
        f'max err {err:.3e}, {steps:.3f} (of 1 rounding step in bf16, of '
        f'{FWD_F32_ERR_RATIO} times the plain version\'s float64 error in '
        f'float32); equal bits twice {same}; members alone as in the batch '
        f'{members}')
  moved = nbytes(x, scale, offset, got)
  del got, again, ordered, want, equal
  fns = {
      'plain': lambda: ln_film.ln_film_forward(x, scale, offset, batch_axis),
      'kernel': lambda: ln_film.ln_film_fwd_cuda(x, scale, offset,
                                                 batch_axis)}
  if b == 1:
    # The library yardstick at batch 1: LayerNorm with the FiLM scale and
    # offset as its weight and bias (its two-pass variance).
    fns['library'] = lambda: torch.nn.functional.layer_norm(
        x.view(-1, shape[2]), [shape[2]], scale[0], offset[0], ln_film.EPS)
  ms = graph_ms(fns, reps=10)
  # About 10 operations per element (the two sums, x_hat, the FiLM).
  cost = (10 * x.numel(), moved)
  bound_ms, _ = bound(*cost, dtype)
  log(f'[LN+FiLM fwd] {dtype} {list(shape)} (batch axis {batch_axis}): '
      f'bitwise the plain op order in the kernel\'s summation order; '
      f'against the plain version {100 * share:.4f}% of the elements '
      f'bitwise, max err {err:.3e} ({steps:.3f} of the tolerance); equal '
      f'bits twice; members alone as in the batch {members or "-"}; kernel '
      f'{ms["kernel"]:.4f} ms (bound {bound_ms:.4f}, '
      f'{100 * bound_ms / ms["kernel"]:.1f}%), plain {ms["plain"]:.3f} ms'
      + (f', library (layer_norm) {ms["library"]:.4f} ms' if b == 1 else ''))
  return {'bitwise_share': share, 'max_err': err, 'steps': steps}, ms, cost


def ln_film_fwd_shapes(e_shapes, member_batch):
  """(shape, batch axis) of the forward kernel's checks: kernel E's shapes,
  and the transformer's and the largest GNN's rows-leading shape at the
  member batch."""
  transformer = next(s for s, axis in e_shapes if axis == 0)
  gnn = max((s for s, axis in e_shapes if axis == 1), key=lambda s: s[0])
  return list(e_shapes) + [
      ((member_batch,) + tuple(transformer[1:]), 0),
      ((gnn[0], member_batch, gnn[2]), 1)]


def check_ln_film_fwd_shapes(shapes, g, card):
  """The forward kernel at every (shape, batch axis), float32 and bf16
  (check_ln_film_fwd); a call captured in a CUDA graph replays to the eager
  call's bits. Returns {(shape, dtype): check_ln_film_fwd's result}."""
  from gencast_tpu_torch.ops import ln_film
  results = {}
  for shape, axis in shapes:
    for dtype in (torch.float32, torch.bfloat16):
      results[(tuple(shape), dtype)] = check_ln_film_fwd(shape, axis, dtype,
                                                         g)
  shape, axis = shapes[0]
  x, scale, offset = ln_film_fwd_inputs(shape, axis, torch.bfloat16, g)
  eager = ln_film.ln_film_fwd_cuda(x, scale, offset, axis)
  graph = torch.cuda.CUDAGraph()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    ln_film.ln_film_fwd_cuda(x, scale, offset, axis)
  torch.cuda.current_stream().wait_stream(side)
  with torch.cuda.graph(graph):
    captured = ln_film.ln_film_fwd_cuda(x, scale, offset, axis)
  graph.replay()
  torch.cuda.synchronize()
  if not torch.equal(captured, eager):
    raise AssertionError('LN+FiLM forward kernel in a CUDA graph: the '
                         'replay differs from the eager call')
  log(f'[LN+FiLM fwd] {len(shapes)} shapes x 2 dtypes checked; a call '
      f'captured in a CUDA graph replays to the eager bits; {card}')
  return results


def check_ln_film_fwd_call(model, stack, args, tag, card, profile=False):
  """One denoiser call of `stack` (args: inputs, noisy targets, sigma,
  forcings) on the card: the LN+FiLM forward kernel launched once per
  LN+FiLM of the call (ln_film_fwd_launches(model)) and no CUDA tensor
  through the plain forward; with `profile`, the call under torch.profiler
  holds as many ln_film_fwd_kernel launches and no kernel E launch
  (TRACE_KERNELS tells the two apart; make it the process's first
  profiler session, which records every kernel). Returns the launches."""
  from gencast_tpu_torch.ops import ln_film
  plain = ln_film.ln_film_forward
  on_card = []

  def counted(x, *rest):
    if x.is_cuda:
      on_card.append(tuple(x.shape))
    return plain(x, *rest)

  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  ln_film.ln_film_forward = counted
  try:
    ln_film.KERNEL_FWD.reset()
    with torch.no_grad(), (torch.profiler.profile(activities=activities)
                           if profile else contextlib.nullcontext()) as prof:
      stack(*args)
      torch.cuda.synchronize()
  finally:
    ln_film.ln_film_forward = plain
  want = ln_film_fwd_launches(model)
  traced = None
  if profile:
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    traced = {k: sum(1 for n in names if re.search(TRACE_KERNELS[k], n))
              for k in ('ln_film_fwd', 'ln_film_bwd')}
  if (ln_film.KERNEL_FWD.launches != want or on_card
      or traced not in (None, {'ln_film_fwd': want, 'ln_film_bwd': 0})):
    raise AssertionError(
        f'{tag} denoiser call: {ln_film.KERNEL_FWD.launches} LN+FiLM forward '
        f'launches, derived {want}; under the profiler {traced}; CUDA '
        f'tensors through the plain forward {on_card}')
  log(f'[LN+FiLM fwd] {tag} denoiser call: {want} forward kernel launches, '
      f'as derived, and no CUDA tensor through the plain forward'
      + (f'; under torch.profiler {traced["ln_film_fwd"]} '
         f'ln_film_fwd_kernel launches and no kernel E' if profile else '')
      + f'; {card}')
  return want


def ln_film_fwd_main() -> int:
  """`python3 chip_smoke.py --ln-film-fwd`: the LN+FiLM forward kernel's
  checks alone, as phases 1, 5, 8, 22 and 23 make them: its build, every
  shape of kernel E's checks at 1 degree, nano and 0.25 degrees and the
  member batches (check_ln_film_fwd_shapes), and one 1-degree and one
  0.25-degree denoiser call (bf16 stacks, seeded weights) with their
  launches (check_ln_film_fwd_call)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import cuda_lib
  torch.backends.cuda.matmul.allow_tf32 = False
  dev = torch.device('cuda', 0)
  card = card_line()
  t0 = time.perf_counter()
  cuda_lib.library()
  log(f'[setup] {card}; torch {torch.__version__}, CUDA '
      f'{torch.version.cuda}; kernels built in '
      f'{time.perf_counter() - t0:.2f} s')
  entry = ''
  for line in cuda_lib.LIBRARY.compiler_log.splitlines():
    if 'Compiling entry function' in line and kernel_name(line):
      entry = kernel_name(line)
    elif 'ln_film_fwd' in entry and ('registers' in line or 'spill' in line):
      log(f'[setup] ptxas {entry}: {line.split(":", 1)[-1].strip()}')
  g = torch.Generator(device=dev).manual_seed(0)
  calls = {}
  for spec in (configs.ONE_DEG, configs.QUARTER_DEG):
    statics = configs.build_statics(spec)
    model, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                     device=dev)
    if spec is configs.ONE_DEG:
      nano = configs.NANO
      shapes = ln_film_fwd_shapes(ln_film_shapes(
          [(spec, statics), (nano, configs.build_statics(nano))]),
          FWD_MEMBERS)
    else:
      shapes = quarter_deg_e_shapes(model)
    check_ln_film_fwd_shapes(shapes, g, card)
    stack = wrappers.build_stack(model, unit_stats(spec.task),
                                 bf16=spec.cast_bf16).to(dev)
    den = model.denoiser
    grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
    args = [torch.randn(grid + (lay.num_channels,), generator=g, device=dev)
            for lay in (den.input_layout, den.target_layout)]
    args += [torch.full((1,), 3.0, device=dev), torch.randn(
        grid + (den.forcing_layout.num_channels,), generator=g, device=dev)]
    calls[spec.name] = check_ln_film_fwd_call(
        model, stack, args, spec.name, card,
        profile=spec is configs.ONE_DEG)
    del model, stack, args
    torch.cuda.empty_cache()
  print(json.dumps({'ln_film_fwd_launches_per_call': calls}), flush=True)
  return 0


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
  grid2mesh receivers, its senders, the mesh2grid senders); see
  check_segment_plan. Returns {(plan, dtype): (max abs err, ms, bound
  inputs)}."""
  results = {}
  for name, ids, n in (
      ('grid2mesh receivers', statics.grid2mesh.receivers,
       statics.num_mesh_nodes),
      ('grid2mesh senders', statics.grid2mesh.senders,
       statics.num_grid_nodes),
      ('mesh2grid senders', statics.mesh2grid.senders,
       statics.num_mesh_nodes)):
    results.update(check_segment_plan(name, ids, n, spec.d_model, g, card))
  return results


def check_segment_plan(name, ids, n, f, g, card, variants=True):
  """Kernel B on the plan of segment ids `ids` over `n` segments, [E, f]
  edges, float32 and bf16 in: against the plain version, bf16 in bitwise
  equal to the kernel on the exact float32 upcast, and twice for equal
  bits; timings of the kernel, of the old path (the float32 copy, then the
  kernel), of the plain version and of segment_reduce, and on plans with
  rows over segment.SPLIT_DEGREE edges of the kernel without the split,
  with half and twice that threshold, and of the plan with its rows capped
  at SPLIT_DEGREE (the kernel's paths as CUDA graph replays, graph_ms);
  without `variants`, the kernel, plain and library timings only.
  Returns {(name, dtype): (max abs err, ms, bound inputs)}."""
  from gencast_tpu_torch.graph import plans
  from gencast_tpu_torch.ops import segment
  unsplit = 2**31 - 1
  results = {}
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
    if dtype == torch.bfloat16 and variants:
      fns['cast_then_kernel'] = lambda: segment.planned_segment_sum_cuda(
          data.float(), row_ptr, perm)
    if max_degree > segment.SPLIT_DEGREE and variants:
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
  G, G's dq reduce and the LN+FiLM forward."""
  from gencast_tpu_torch.ops import banded_attention, ln_film, segment, \
      sparse_attention
  return (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
          sparse_attention.KERNEL_DKV, segment.KERNEL, ln_film.KERNEL,
          banded_attention.KERNEL, banded_attention.KERNEL_DQ,
          banded_attention.KERNEL_DKV, sparse_attention.KERNEL_DKVQ,
          sparse_attention.KERNEL_DQ_REDUCE, ln_film.KERNEL_FWD)


def node_chunk_rows(n: int, chunk: int) -> list:
  """Rows of each chunk a streamed net's node MLPs take over n rows
  (`TypedGraphNet._node_chunked`): one call under the chunk, else equal
  chunks where they divide n, else chunks of `chunk` and a shorter last."""
  if n <= chunk:
    return [n]
  k = -(-n // chunk)
  if n % k == 0:
    return [n // k] * k
  return [chunk] * (n // chunk) + [n % chunk]


def edge_chunk_rows(net, topo) -> list:
  """Edges of each chunk of `topo` in a streamed net."""
  stream = net.streams[topo.name]
  e = topo.num_edges
  return [min(stream.chunk, e - c * stream.chunk)
          for c in range(stream.num_chunks)]


def streamed_ln_film_shapes(net, used, batch=1) -> list:
  """The [rows, B, C] of every kernel E launch a training step's backward
  makes in the CondMLPs of a streamed TypedGraphNet: one per chunk of each
  node embedder, edge embedder and edge MLP, and of each node MLP whose
  output reaches the loss (`used`: node set names)."""
  chunk = net.edge_chunk_size

  def width(mlp):
    return mlp.network.layers[-1].weight.shape[0]

  shapes = []
  for name, mlp in net.node_embedders.items():
    shapes += [(r, batch, width(mlp))
               for r in node_chunk_rows(net.num_nodes[name], chunk)]
  for topo in net.topologies:
    for mlp in (net.edge_embedders[topo.name],
                net.processors[0].edge_mlps[topo.name]):
      shapes += [(r, batch, width(mlp)) for r in edge_chunk_rows(net, topo)]
  for name, mlp in net.processors[0].node_mlps.items():
    if name in used:
      shapes += [(r, batch, width(mlp))
                 for r in node_chunk_rows(net.num_nodes[name], chunk)]
  return shapes


def expected_step_launches(gencast) -> dict:
  """Launches of each kernel in one training step, derived from the model.
  The attention backend's forward (A or C) runs once per layer under
  'save_attention' (the attention half is not recomputed) and twice under
  'full'; its backward (F or D: dq and dk/dv; G and its dq reduce when the
  transformer holds the fused backward's gather map) once per layer; the other
  backend's kernels never, and the einsum backends ('triblock', 'dense')
  none. B once per receiver aggregation over a side of
  non-uniform degree each time it runs (the forward; with remat_gnns also
  its recomputation; in a streamed net per chunk, and again in the chunk's
  own recomputation) and once per gather over such a side (its backward;
  a streamed net's sender gathers always): on the card each of them
  carries a plan, the reference's or one of its own; E once per LN+FiLM
  whose output reaches the loss (in a streamed net, per chunk); the LN+FiLM
  forward as `ln_film_fwd_launches` says."""
  from gencast_tpu_torch.ops import banded_attention, ln_film, segment, \
      sparse_attention
  arch = gencast.denoiser.architecture
  cfg = arch.processor.cfg
  layers = cfg.num_layers
  recompute = cfg.remat_policy == 'full'
  planned = 0
  for net in (arch.grid2mesh, arch.mesh2grid):
    if net.edge_chunk_size is not None:
      runs = 2 + arch.remat_gnns  # forward, chunk remat, GNN remat
      for topo in net.topologies:
        stream = net.streams[topo.name]
        if stream.uniform_k is None:
          planned += stream.num_chunks * (runs + 1)
        planned += stream.num_chunks
      continue
    for inet in net.processors:
      for topo in inet.topologies:
        send_k, recv_k = inet._uniform[topo.name]
        if recv_k is None:
          # The forward sum (and its remat) and the receiver gather's
          # backward.
          planned += 2 + arch.remat_gnns
        if send_k is None:
          planned += 1  # the sender gather's backward
  if 'slot_ids' in arch.processor.operand_names:
    attn = (sparse_attention.KERNEL, sparse_attention.KERNEL_DKVQ,
            sparse_attention.KERNEL_DQ_REDUCE)
  elif cfg.attention_type == 'pallas':
    attn = (sparse_attention.KERNEL, sparse_attention.KERNEL_DQ,
            sparse_attention.KERNEL_DKV)
  elif cfg.attention_type == 'triblock_pallas':
    attn = (banded_attention.KERNEL, banded_attention.KERNEL_DQ,
            banded_attention.KERNEL_DKV)
  else:  # the einsum 'triblock' and 'dense': plain PyTorch, no kernel
    attn = ()
  launches = {c.name: 0 for c in counters()}
  launches.update({c.name: layers for c in attn[1:]})
  if attn:
    launches[attn[0].name] = layers * (2 if recompute else 1)
  launches.update({segment.KERNEL.name: planned,
                   ln_film.KERNEL.name: ln_film_fwd_launches(gencast),
                   ln_film.KERNEL_FWD.name: ln_film_fwd_launches(
                       gencast, train=True)})
  return launches


def gnn_ln_film_calls(model, train: bool = False) -> int:
  """LN+FiLMs the GNNs of `model` (a GenCast or a stack around one) run in
  a denoiser call, or with `train` in a training step. A call runs one per
  CondMLP (in a streamed net, per chunk of its rows), less the decoder's
  mesh-node update, which nothing reads. A step runs them again in the
  backward's recomputations: a whole GNN under remat_gnns; in a streamed
  net each chunk of edges, and each chunk of a node MLP with more rows than
  a chunk, in the chunk's own recomputation (a node MLP of one chunk has
  none); under remat_gnns a streamed GNN's recomputation stops before the
  last chunk of its last node update when that update is chunked (the
  checkpoint needs nothing that chunk makes)."""
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.nn import mlp
  arch = wrappers.find_layout_provider(model).architecture
  again = int(arch.remat_gnns) if train else 0
  total = 0
  for net in (arch.grid2mesh, arch.mesh2grid):
    used = (set(net.node_decoders) if net is arch.mesh2grid
            else set(net.num_nodes))
    if net.edge_chunk_size is None:
      unused = sum(len(set(inet.node_mlps) - used) for inet in net.processors)
      total += (sum(isinstance(m, mlp.CondMLP) for m in net.modules())
                - unused) * (1 + again)
      continue
    chunk_again = 1 + again + int(train)  # the chunk's own recomputation
    for topo in net.topologies:  # the edge embedder and the edge MLP
      total += 2 * len(edge_chunk_rows(net, topo)) * chunk_again
    updates = [name for name in net.processors[0].node_mlps if name in used]
    for name in list(net.node_embedders) + updates:
      chunks = len(node_chunk_rows(net.num_nodes[name], net.edge_chunk_size))
      total += chunks * chunk_again if chunks > 1 else 1 + again
    if len(node_chunk_rows(net.num_nodes[updates[-1]],
                           net.edge_chunk_size)) > 1:
      total -= again
  return total


def ln_film_fwd_launches(model, train: bool = False) -> int:
  """Launches of the LN+FiLM forward kernel in one denoiser call (also
  kernel E's in a training step: one per LN+FiLM whose output reaches the
  loss), or with `train` in one training step: the call's, and those the
  backward recomputes. The transformer's two norms a layer and its final
  one ('save_attention' recomputes each layer's feed-forward half, 'full'
  both halves), and the GNNs' (`gnn_ln_film_calls`). `model`: a GenCast or
  a stack around one."""
  from gencast_tpu_torch.models import wrappers
  cfg = wrappers.find_layout_provider(model).architecture.processor.cfg
  launches = 2 * cfg.num_layers + 1
  if train:
    launches += cfg.num_layers * (2 if cfg.remat_policy == 'full' else 1)
  return launches + gnn_ln_film_calls(model, train)


def train_tiny_against_cpu(dev, remat_policy, spec) -> None:
  """Phases 9 and 14: one TINY float32 loss and gradient at batch 2, then 3
  AdamW steps, on the card through the kernels and on the CPU through the
  plain versions, from the same perturbed weights, data, sigma and noise;
  and the bf16 stack's gradients on the card against the float32 ones.
  `spec` is TINY on one attention backend."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.training import steps
  spec = dataclasses.replace(spec, attention_tile_size=64,
                             use_agg_plans=True, agg_plan_min_degree=2,
                             remat_policy=remat_policy)

  statics = configs.build_statics(spec)
  flat = None
  stacks, models = {}, {}
  stats = unit_stats(spec.task)
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
                 tag=None, runs=None, data='synthetic'):
  """Phases 10, 15, 17 and 30: full-width training steps of `spec` through
  the CLI (`argv` names the preset and any checkpoint directory) on `data`
  (synthetic, or an ERA5 directory), up to step
  `steps_run`, starting at `start` (a resumed run starts past its
  checkpoint). Checks the losses, the parameters' change and each kernel's
  launches against the counts derived from the model; returns (those
  launches, the seconds of each step, the peak device memory in bytes),
  and appends the run (train.TrainRun) to `runs` when given."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.training import train
  tag = tag or spec.name
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  run = train.main(argv + ['--steps', str(steps_run), '--data', data,
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
  if runs is not None:
    runs.append(run)
  return launches, run.step_seconds, peak


def check_reproducible(argv, steps_run) -> None:
  """Phase 18: `steps_run` training steps through the CLI, twice from the
  same seed, must leave bitwise equal losses and parameters: every sum of
  the step is taken in a fixed order (no aggregation adds atomically).
  Each run takes a sampling eval after every step (`--do_sampling_eval
  --eval_every 1`): the serving copy, refreshed in place before each eval,
  keeps its sampler graph, so the denoiser call is captured once over the
  run's evals (the captures counted at `cuda_lib.Graph.capture`, the graphs
  on the serving copy)."""
  from gencast_tpu_torch.ops import cuda_lib, segment
  from gencast_tpu_torch.training import train
  runs = []
  capture = cuda_lib.Graph.capture
  for _ in range(2):
    segment.KERNEL.reset()
    captures = []

    def counted(graph, fn, captures=captures):
      captures.append(graph)
      return capture(graph, fn)

    cuda_lib.Graph.capture = counted
    try:
      run = train.main(argv + ['--steps', str(steps_run), '--data',
                               'synthetic', '--log_every', '1',
                               '--do_sampling_eval', '--eval_every', '1'])
    finally:
      cuda_lib.Graph.capture = capture
    graphs = sampler_graphs(run.model)
    if (len(captures) != 1 or len(graphs) != 1
        or graphs[0].graph is not captures[0]
        or not graphs[0].graph.counts.launches):
      raise AssertionError(f'{argv}: {len(captures)} captures and '
                           f'{len(graphs)} sampler graphs over {steps_run} '
                           'sampling evals (one of each expected)')
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
      f'bitwise equal; a sampling eval after each step, the denoiser call '
      f'captured once in each run\'s {steps_run} evals')


def fused_training(argv, dev, card, k, rounds, pool_rows=4, tag=None):
  """Phase 19: `rounds` calls of `k` graphed training steps
  (`steps.scanned_train_steps`, the training CLI's --steps_per_call) against
  as many eager steps (`steps.train_step`) of an identical twin, from one
  setup of the training CLI's `argv`, on the same pool rows and step
  generators: losses and parameters bitwise equal after each call, each
  kernel's launches per graphed step as derived. Returns (the graphed
  run's launches, its seconds per step by call, the eager seconds per
  step, the graph's capture seconds and private pool bytes, the peak
  device memory)."""
  from gencast_tpu_torch.models.gencast import GenCast
  from gencast_tpu_torch.training import steps, train
  tag = tag or ' '.join(argv)
  torch.cuda.reset_peak_memory_stats()
  args = train.parse_args(argv + ['--data', 'synthetic'])
  run = train.setup(args)
  eager, eager_opt = run.wrapped, run.optimizer
  graphed = copy.deepcopy(eager)
  graphed_opt = steps.create_optimizer(graphed, eager_opt.config)
  pool = train.device_pool(run.source, pool_rows, dev)
  fused = steps.scanned_train_steps(graphed, graphed_opt)
  per_step = expected_step_launches(
      next(m for m in eager.modules() if isinstance(m, GenCast)))
  launches = {c.name: 0 for c in counters()}
  eager_s, graphed_s = [], []
  for r in range(rounds):
    step_ids = list(range(r * k, (r + 1) * k))
    rows = [(5 * i + 1) % pool_rows for i in step_ids]
    eager_losses = []
    for c in counters():
      c.reset()
    for row, step in zip(rows, step_ids):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      loss, _ = steps.train_step(
          eager, eager_opt, pool['inputs'][row], pool['targets'][row],
          pool['forcings'][row], train.step_generator(args.seed, step, dev))
      torch.cuda.synchronize()
      eager_s.append(time.perf_counter() - t0)
      eager_losses.append(loss)
    eager_launches = {c.name: c.launches for c in counters()}
    for c in counters():
      c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = fused(pool, rows, step_ids, args.seed)
    torch.cuda.synchronize()
    graphed_s.append((time.perf_counter() - t0) / k)
    got = {c.name: c.launches for c in counters()}
    expected = {name: n * k for name, n in per_step.items()}
    if got != expected or eager_launches != expected:
      raise AssertionError(f'{tag}: launches of {k} graphed steps {got}, of '
                           f'{k} eager steps {eager_launches}, expected '
                           f'{expected}')
    launches = {name: launches[name] + n for name, n in got.items()}
    params = list(zip(eager.parameters(), graphed.parameters()))
    differing = sum(not torch.equal(a, b) for a, b in params)
    if (not torch.equal(torch.stack(eager_losses), losses) or differing
        or not torch.isfinite(losses).all()
        or eager_opt.step_count != graphed_opt.step_count):
      raise AssertionError(
          f'{tag}, steps {step_ids}: graphed losses {losses.tolist()}, eager '
          f'{[float(x) for x in eager_losses]}; {differing} of {len(params)} '
          f'parameters differ')
  peak = torch.cuda.max_memory_allocated()
  log(f'[fused {tag}] {rounds} x {k} steps: CUDA-graph replays bitwise equal '
      f'to eager steps of a twin (losses and all {len(params)} parameters '
      f'after each call); launches per step {per_step}, as derived; seconds '
      f'per step graphed {[round(x, 4) for x in graphed_s]} by call (the '
      f'first with its eager warm-up step and the capture), eager '
      f'{[round(x, 4) for x in eager_s]}; capture '
      f'{fused.graph.capture_seconds:.2f} s, private pool '
      f'{fused.graph.pool_bytes / 2**30:.2f} GiB; peak memory of both '
      f'{peak / 2**30:.2f} GiB; {card}')
  result = (launches, graphed_s, eager_s, fused.graph.capture_seconds,
            fused.graph.pool_bytes, peak)
  del fused, graphed, graphed_opt, eager, eager_opt, run, pool
  torch.cuda.empty_cache()
  return result


def fused_cli(spec, statics, dev, card) -> dict:
  """Phase 20: `train.main` with --steps_per_call 2 for 4 steps, checkpoints
  every 2, then a run to step 6 that resumes at step 4 from the newest
  checkpoint through the fused path (launches per step checked by
  train_preset). Returns each kernel's launches in both runs."""
  from gencast_tpu_torch.training import checkpoint
  work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'chip_smoke_fused')
  shutil.rmtree(work, ignore_errors=True)
  argv = ['--preset', spec.name, '--steps_per_call', '2', '--save_every',
          '2', '--ckpt_dir', work]
  first, first_s, _ = train_preset(spec, statics, dev, card, argv,
                                   steps_run=4, tag=f'{spec.name} fused CLI')
  second, second_s, _ = train_preset(spec, statics, dev, card, argv,
                                     steps_run=6, start=4,
                                     tag=f'{spec.name} fused CLI, resumed')
  saved = checkpoint.all_steps(checkpoint.create_manager(work))
  if saved != [1, 3, 5]:
    raise AssertionError(f'fused CLI checkpoints at steps {saved}')
  log(f'[fused CLI {spec.name}] --steps_per_call 2: seconds per step '
      f'{[round(x, 4) for x in first_s]} then '
      f'{[round(x, 4) for x in second_s]} (resumed at step 4); checkpoints '
      f'kept at steps {saved}; {card}')
  shutil.rmtree(work, ignore_errors=True)
  return {k: first[k] + second[k] for k in first}


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
  """The [padded_n, padded_n] boolean mask that a tile plan describes, made
  on `dev` (at 0.25 degrees it is 1.7 GB)."""
  t, nq = plan.tile, plan.num_q_tiles
  dense = torch.zeros((nq, nq, t, t), dtype=torch.bool, device=dev)
  rows = np.repeat(np.arange(nq), plan.fwd_kv_ids.shape[1])
  cols = plan.fwd_kv_ids.reshape(-1)
  pids = plan.fwd_pair_ids.reshape(-1)
  real = pids != plan.mask_tiles.shape[0] - 1  # pad slots repeat a pair
  dense[torch.as_tensor(rows[real], device=dev),
        torch.as_tensor(cols[real], device=dev)] = torch.as_tensor(
            plan.mask_tiles[pids[real]], device=dev) != 0
  return dense.permute(0, 2, 1, 3).reshape(nq * t, nq * t)


def check_banded(shape, dtype, atol, mask, bs, g, dense, allowed, batch=1):
  """Kernel C against its plain version on seeded q/k/v [batch, *shape] (NaN
  behind the last row) under the tri-block `mask` (uint8 [3, nb, bs, bs]):
  returns (max abs err,
  {'kernel': ms, 'plain': ms, 'library': ms}, (flops, bytes))."""
  from gencast_tpu_torch.ops import banded_attention as ba
  q, k, v = nan_tailed(shape, 3, dtype, g, mask.device, 64, batch)
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
  log(f'[kernel C] {dtype} [{batch}, {", ".join(map(str, shape))}], block '
      f'{bs}: max abs err {err:.3e} (tol {atol}), lse {lse_err:.3e}; '
      f'{int((~seen).sum())} rows without a key give 0 and +1e30; NaN '
      f'behind row {shape[0]} not read; kernel {ms["kernel"]:.3f} ms, '
      f'plain {ms["plain"]:.3f} ms, library (scaled_dot_product_attention, '
      f'dense mask; max abs err {lib_err:.3e} on rows that see a key) '
      f'{ms["library"]:.3f} ms per layer call')
  return err, ms, (4 * d * allowed * h * batch,
                   nbytes(q, k, v, mask, got, lse))


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
  from gencast_tpu_torch import configs, rollout
  from gencast_tpu_torch.ops import banded_attention, segment
  spec = configs.NANO
  statics = configs.build_statics(spec)
  model, stack, plain_stack = kernel_and_plain_stacks(spec, statics, dev,
                                                      'nano')
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
  del out_k, out_p, plain_stack

  calls = ROLLOUT_STEPS * (2 * spec.num_noise_levels - 1)
  seconds, forecasts = [], []
  # Requests 1 and 2 replay the denoiser's CUDA graph (the first captures
  # it); request 1 again with jit=False, the eager path, from the same
  # generator seed must give its bits.
  for seed, jit in ((1, True), (2, True), (1, False)):
    gen = torch.Generator(device=dev).manual_seed(seed)
    banded_attention.KERNEL.reset()
    segment.KERNEL.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecast = rollout.sample_rollout(stack, inputs, forcings, gen, jit=jit)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    forecasts.append(forecast)
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
    log(f'[nano serve] request {seed} ({"graphed" if jit else "eager"}): '
        f'{ROLLOUT_STEPS}-step rollout {tuple(forecast.shape)} float32, '
        f'finite; {seconds[-1]:.3f} s ({seconds[-1] / ROLLOUT_STEPS:.3f} s '
        f'per 12-hour step, {1e3 * seconds[-1] / calls:.2f} ms per denoiser '
        f'call); launches C {launched[0]}, B {launched[1]}')
  check_graphed_equals_eager('nano 10-step request', forecasts[0],
                             forecasts[2])
  log(f'[nano serve] 10-step request: graphed {seconds[0]:.3f} s (with the '
      f'capture), {seconds[1]:.3f} s; eager {seconds[2]:.3f} s; '
      f'{graph_note(stack)}; {card_line()}')
  return ms['kernel']


def sampler_graphs(stack) -> list:
  """The denoiser graphs of the serving copy inside a wrapper stack."""
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.models.gencast import GenCast
  for m in stack.modules():
    if isinstance(m, casting.Bfloat16Cast):
      return list(m._bf16.denoiser_graphs.graphs.values())
    if isinstance(m, GenCast):
      return list(m.denoiser_graphs.graphs.values())
  raise ValueError('no GenCast in the stack')


def graph_note(stack) -> str:
  graphs = sampler_graphs(stack)
  return ', '.join(
      f'denoiser graph captured in {g.graph.capture_seconds:.2f} s, private '
      f'pool {g.graph.pool_bytes / 2**30:.3f} GiB' for g in graphs)


def check_graphed_equals_eager(what, graphed, eager) -> None:
  """CUDA-graph replays run the eager path's kernels on the same inputs, in
  the same order, so they must give its bits."""
  if not torch.equal(graphed, eager):
    diff = float((graphed - eager).abs().nan_to_num().max())
    raise AssertionError(f'{what}: graph replays differ from the eager path '
                         f'(max abs difference {diff})')
  log(f'[graphs] {what}: graph replays bitwise equal to the eager path')


def fused_path(spec, statics, dev, card, f_seconds, f_peak, stats):
  """Phase 17: the 1-degree training path with the fused attention backward
  (GENCAST_SPARSE_FUSED_BWD=1, set around the calls and restored after): 3
  steps through `train.main` with checkpoints every 2 steps, then a run to
  step 5 that resumes from the newest checkpoint, then `evaluate.main` on
  it (2 members, 2 steps). The training runs load the statistics file
  `stats`. Returns each kernel's launches in the two training runs
  together."""
  from gencast_tpu_torch.nn import transformer
  from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
  from gencast_tpu_torch.training import checkpoint, evaluate
  work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'chip_smoke')
  shutil.rmtree(work, ignore_errors=True)
  ckpt, out = os.path.join(work, 'ckpt'), os.path.join(work, 'eval')
  jsonl = os.path.join(work, 'metrics.jsonl')
  argv = ['--preset', '1deg', '--num_layers', str(spec.num_layers),
          '--clean_sst_nans', '--stats_path', stats, '--save_every', '2',
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
  run = evaluate.main(['--preset', '1deg', '--num_layers',
                       str(spec.num_layers), '--ckpt_dir', ckpt,
                       '--num_members', str(members), '--max_rollout_steps',
                       str(rollout_steps), '--clean_sst_nans', '--out_dir',
                       out, '--plot_vars'])
  wall = time.perf_counter() - t0
  served = {c.name: c.launches for c in counters()}
  # The members sample as one batch (evaluate's default, the reference's
  # vmapped ensemble): a batched call launches A and B as often as a
  # one-member call.
  calls = rollout_steps * (2 * spec.num_noise_levels - 1)
  expected = {c.name: 0 for c in counters()}
  expected.update({sparse_attention.KERNEL.name: calls * spec.num_layers,
                   segment.KERNEL.name: calls,
                   ln_film.KERNEL_FWD.name: calls * ln_film_fwd_launches(
                       run.model)})
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


def unit_stats(task):
  """Unit normalization statistics for every variable of `task`."""
  from gencast_tpu_torch.data import layout
  return layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)


def kernel_and_plain_stacks(spec, statics, dev, tag):
  """`spec`'s model through the kernels and through the plain path
  (use_kernels=False), with the same seeded weights perturbed
  (bridge.perturbed), each in its serving stack (unit statistics, bf16
  where the spec is): (model, stack, plain stack)."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  t0 = time.perf_counter()
  model, _ = configs.build_gencast(spec, seed=0, statics=statics, device=dev)
  flat = bridge.perturbed(bridge.export_reference_params(model), seed=1)
  bridge.load_reference_params(model, flat)
  plain_model, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                         device=dev, use_kernels=False)
  bridge.load_reference_params(plain_model, flat)
  stats = unit_stats(spec.task)
  stack = wrappers.build_stack(model, stats, bf16=spec.cast_bf16).to(dev)
  plain_stack = wrappers.build_stack(plain_model, stats,
                                     bf16=spec.cast_bf16).to(dev)
  log(f'[{tag}] built two {spec.name} models '
      f'({sum(p.numel() for p in model.parameters())} parameters each, '
      f'seeded and perturbed) in {time.perf_counter() - t0:.1f} s')
  return model, stack, plain_stack


def quarter_statics_job(report: str) -> int:
  """Phase 21's build, in a process of its own (CPU only; started by
  start_quarter_statics at phase 2, so that it runs beside the card's
  phases 2-20): the 0.25-degree graph statics built (the run's cache is
  empty at its start), then loaded from the on-disk cache, array for array
  the same. Writes the seconds of each to `report` (JSON)."""
  from gencast_tpu_torch import configs
  spec = configs.QUARTER_DEG
  t0 = time.perf_counter()
  statics = configs.build_statics(spec)
  built = time.perf_counter() - t0
  t0 = time.perf_counter()
  again = configs.build_statics(spec)
  loaded = time.perf_counter() - t0
  plan = statics.attention_tile_plan
  for name in ('grid2mesh', 'mesh2grid', 'mesh_edges'):
    for field in ('senders', 'receivers', 'features'):
      if not np.array_equal(getattr(getattr(statics, name), field),
                            getattr(getattr(again, name), field)):
        raise AssertionError(f'cached statics: {name}.{field} differs')
  for field in ('mask_tiles', 'fwd_kv_ids', 'fwd_pair_ids', 'bwd_q_ids',
                'bwd_pair_ids'):
    if not np.array_equal(getattr(plan, field),
                          getattr(again.attention_tile_plan, field)):
      raise AssertionError(f'cached statics: tile plan {field} differs')
  with open(report, 'w') as f:
    json.dump({'built_s': built, 'loaded_s': loaded}, f)
  return 0


# Commands chip_smoke.py starts, each in a session of its own (a process
# group led by the command); stop_processes stops each group at its exit.
STARTED = []


def _process_table():
  """(pid, ppid, process group) of every process in /proc that has not
  ended (zombies left out)."""
  table = []
  for entry in os.listdir('/proc'):
    if not entry.isdigit():
      continue
    try:
      with open(f'/proc/{entry}/stat') as f:
        stat = f.read()
    except OSError:
      continue
    # After the command's name in parentheses: state, ppid, pgrp, ...
    fields = stat[stat.rindex(')') + 2:].split()
    if fields[0] != 'Z':
      table.append((int(entry), int(fields[1]), int(fields[2])))
  return table


def stop_processes():
  """Stops every process chip_smoke.py started that still runs, and waits
  for each: multiprocessing's resource tracker (which the 'spawn' of
  phase 43's ranks starts, and which would otherwise end only after this
  process), what is left in the process group of each command in STARTED,
  and any other child. Returns the pids it had to kill."""
  from multiprocessing import resource_tracker
  stop_tracker = getattr(resource_tracker._resource_tracker, '_stop', None)
  if stop_tracker is not None:
    stop_tracker()
  groups = {proc.pid for proc in STARTED}
  killed = []
  for pid, ppid, group in _process_table():
    if pid != os.getpid() and (ppid == os.getpid() or group in groups):
      with contextlib.suppress(ProcessLookupError):
        os.kill(pid, signal.SIGKILL)
        killed.append(pid)
  for proc in STARTED:
    if proc.returncode is None:
      proc.communicate()
  for pid in killed:
    with contextlib.suppress(ChildProcessError):
      os.waitpid(pid, 0)
  return killed


def start_quarter_statics(report: str) -> subprocess.Popen:
  """quarter_statics_job in a new python3 process that sees no card."""
  repo = os.path.dirname(os.path.abspath(__file__))
  proc = subprocess.Popen(
      [sys.executable, os.path.abspath(__file__), '--quarter-statics',
       report], cwd=repo, text=True, stdout=subprocess.PIPE,
      stderr=subprocess.PIPE, start_new_session=True,
      env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
  STARTED.append(proc)
  return proc


def quarter_deg_statics(spec, card, job, report):
  """Phase 21: the 0.25-degree graph statics: built and then loaded from
  the on-disk cache, array for array the same, by `job`
  (quarter_statics_job, waited for here), then loaded here from the
  cache; their counts."""
  from gencast_tpu_torch import configs
  stdout, stderr = job.communicate(timeout=900)
  if job.returncode:
    raise AssertionError(f'0.25deg statics build: exit {job.returncode}\n'
                         f'{stdout[-3000:]}\n{stderr[-5000:]}')
  with open(report) as f:
    seconds = json.load(f)
  t0 = time.perf_counter()
  statics = configs.build_statics(spec)
  loaded = time.perf_counter() - t0
  plan = statics.attention_tile_plan
  degree = np.bincount(statics.grid2mesh.receivers).max()
  log(f'[0.25deg statics] built in {seconds["built_s"]:.1f} s and loaded '
      f'from the cache in {seconds["loaded_s"]:.2f} s (the same arrays) by '
      f'a process of its own beside phases 2-20; loaded here in '
      f'{loaded:.2f} s; grid {statics.num_grid_nodes} '
      f'nodes, mesh {statics.num_mesh_nodes} nodes, grid2mesh '
      f'{statics.grid2mesh.num_edges} edges (receiver degree up to '
      f'{degree}), mesh2grid {statics.mesh2grid.num_edges} edges, mesh '
      f'{statics.mesh_edges.num_edges} edges; tile plan tile {plan.tile}: '
      f'{plan.num_q_tiles} q tiles x {plan.num_active_fwd} slots, '
      f'{plan.num_pairs} mask-tile pairs, padded n {plan.padded_n}, mask '
      f'tiles {plan.mask_tiles.nbytes / 1e6:.0f} MB; {card}')
  return statics


def quarter_deg_e_shapes(gencast):
  """(shape, batch axis) of every kernel E call of a training step of the
  streamed model: the transformer's [1, padded n, C] and the streamed
  GNNs' chunks."""
  arch = gencast.denoiser.architecture
  padded = arch.processor.padded_n
  shapes = {((1, padded, arch.grid2mesh.edge_latent_size['g2m']), 0)}
  for net, used in ((arch.grid2mesh, set(arch.grid2mesh.num_nodes)),
                    (arch.mesh2grid, set(arch.mesh2grid.node_decoders))):
    shapes |= {(shape, 1) for shape in streamed_ln_film_shapes(net, used)}
  return sorted(shapes)


def check_quarter_deg_kernels(spec, statics, gencast, g, card):
  """Phase 22: kernels A and F at the 0.25-degree plan's padded and ragged
  shapes, B on one grid2mesh chunk's receiver and sender plans (the chunk
  with the longest receiver row), E and the LN+FiLM forward at every shape
  a 0.25-degree training step gives E, float32 and bf16, each against its
  plain version, with timings, bounds and the library calls
  (check_attention, check_attention_bwd, check_segment_plan,
  check_ln_film_shapes, check_ln_film_fwd_shapes; the slow plain versions
  and library calls timed over fewer calls). Returns ({(kernel, dtype,
  rows or shape): result}, E's results, E's shapes)."""
  from gencast_tpu_torch.nn import gnn
  dev = g.device
  t_phase = time.perf_counter()
  plan = statics.attention_tile_plan
  n, h = statics.num_mesh_nodes, spec.num_heads
  d = spec.d_model // h
  mt = torch.as_tensor(plan.mask_tiles, device=dev)
  plan_t = tuple(torch.as_tensor(a, device=dev) for a in (
      plan.fwd_kv_ids, plan.fwd_pair_ids, plan.bwd_q_ids, plan.bwd_pair_ids))
  dense = dense_from_plan(plan, dev)
  allowed = int(plan.mask_tiles.sum(dtype=np.int64))
  results = {}
  for dtype, atol, rtol in ((torch.float32, ATTN_F32_ATOL, BWD_F32_RTOL),
                            (torch.bfloat16, ATTN_BF16_ATOL, BWD_BF16_RTOL)):
    for rows in (plan.padded_n, n):
      results[('A', dtype, rows)] = check_attention(
          (rows, h, d), dtype, atol, mt, plan_t[0], plan_t[1], plan.tile, g,
          dense[:rows, :rows], allowed, reps=3)
      results[('F', dtype, rows)] = check_attention_bwd(
          (rows, h, d), dtype, rtol, mt, plan_t, plan.tile, g,
          dense[:rows, :rows], allowed, reps=1)
  del dense, mt, plan_t
  torch.cuda.empty_cache()

  topo = gnn.EdgeTopology('g2m', 'grid', 'mesh', statics.grid2mesh.senders,
                          statics.grid2mesh.receivers)
  stream = gnn.EdgeStream(topo, {'grid': statics.num_grid_nodes,
                                 'mesh': statics.num_mesh_nodes},
                          spec.edge_chunk_size)
  c = max(range(stream.num_chunks), key=lambda i: int(np.bincount(
      stream.local_ids(i, 'recv').numpy()).max()))
  for side, what in (('recv', 'receivers'), ('send', 'senders')):
    lo, hi = stream.rows(c, side)
    found = check_segment_plan(
        f'0.25deg grid2mesh chunk {c} of {stream.num_chunks} {what} '
        f'(nodes {lo}-{hi - 1})', stream.local_ids(c, side).numpy(), hi - lo,
        spec.d_model, g, card)
    for (name, dtype), value in found.items():
      results[('B', dtype, side)] = value
    results[('B shape', side)] = [len(stream.local_ids(c, side)),
                                  spec.d_model]

  e_shapes = quarter_deg_e_shapes(gencast)
  e_results = check_ln_film_shapes(
      e_shapes, g, card, profiled='one kernel per call under torch.profiler '
      'checked in a fresh process beside phase 42\'s pod forecast (its line '
      'there)')
  for (shape, dtype), value in check_ln_film_fwd_shapes(e_shapes, g,
                                                       card).items():
    results[('LN+FiLM fwd', dtype, shape)] = value
  log(f'[0.25deg kernels] A, F, B, E and the LN+FiLM forward at the '
      f'0.25-degree shapes in {time.perf_counter() - t_phase:.1f} s; {card}')
  return results, e_results, e_shapes


def quarter_deg_denoiser(spec, statics, model, stack, plain_stack, dev, g,
                         card):
  """Phase 23: the QUARTER_DEG denoiser call through the kernels (A once
  per layer, B once per grid2mesh chunk) against the same call through the
  plain path. Returns (inputs, forcings, {'kernel': ms, 'plain': ms})."""
  from gencast_tpu_torch.ops import segment, sparse_attention
  t_phase = time.perf_counter()
  den = model.denoiser
  chunks = den.architecture.grid2mesh.streams['g2m'].num_chunks
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
    if launched != (spec.num_layers, chunks):
      raise AssertionError(f'0.25deg denoiser call launched (A, B) '
                           f'{launched}, expected ({spec.num_layers}, '
                           f'{chunks})')
    check_ln_film_fwd_call(model, stack, (inputs, noisy, sigma, forcings),
                           spec.name, card)
    out_p = plain_stack(inputs, noisy, sigma, forcings)
    rel = float((out_k - out_p).abs().max() / out_p.abs().max())
    mean_rel = float((out_k - out_p).abs().mean() / out_p.abs().mean())
    if not (torch.isfinite(out_k).all() and rel <= DENOISER_BF16_RTOL):
      raise AssertionError(f'0.25deg denoiser kernels vs plain: {rel} > '
                           f'{DENOISER_BF16_RTOL} or not finite')
    del out_k, out_p
    ms = time_in_turns({
        'plain': lambda: plain_stack(inputs, noisy, sigma, forcings),
        'kernel': lambda: stack(inputs, noisy, sigma, forcings)}, reps=1)
  log(f'[0.25deg denoiser] bf16 {grid + (den.target_layout.num_channels,)}:'
      f' max rel err {rel:.3e} (tol {DENOISER_BF16_RTOL}), mean rel err '
      f'{mean_rel:.3e}; launches A {spec.num_layers}, B {chunks} (one per '
      f'grid2mesh chunk); kernel path {ms["kernel"]:.2f} ms, plain path '
      f'{ms["plain"]:.2f} ms per call; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return inputs, forcings, ms


def streamed_against_dense(statics, dev, g, card):
  """Phase 23, second part: the 1-degree denoiser with streamed edges
  (chunks of ONE_DEG_CHUNK edges, so grid2mesh receivers straddle chunks)
  against the dense 1-degree denoiser, the same weights, float32 through
  the kernels on the card."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import segment
  t_phase = time.perf_counter()
  spec = configs.ONE_DEG
  streamed = dataclasses.replace(spec, edge_chunk_size=ONE_DEG_CHUNK)
  dense_model, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                         device=dev)
  flat = bridge.perturbed(bridge.export_reference_params(dense_model),
                          seed=2)
  bridge.load_reference_params(dense_model, flat)
  stream_model, _ = configs.build_gencast(streamed, seed=0, statics=statics,
                                          device=dev)
  bridge.load_reference_params(stream_model, flat)
  stats = unit_stats(spec.task)
  stacks = [wrappers.build_stack(m, stats, bf16=False).to(dev)
            for m in (dense_model, stream_model)]
  den = dense_model.denoiser
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs, noisy, forcings = (
      torch.randn(grid + (lay.num_channels,), generator=g, device=dev)
      for lay in (den.input_layout, den.target_layout, den.forcing_layout))
  sigma = torch.full((1,), 2.0, device=dev)
  chunks = stream_model.denoiser.architecture.grid2mesh.streams[
      'g2m'].num_chunks
  with torch.no_grad():
    want = stacks[0](inputs, noisy, sigma, forcings)
    segment.KERNEL.reset()
    got = stacks[1](inputs, noisy, sigma, forcings)
    torch.cuda.synchronize()
  rel = float((got - want).abs().max() / want.abs().max())
  if not (torch.isfinite(got).all() and rel <= STREAMED_F32_RTOL
          and segment.KERNEL.launches == chunks):
    raise AssertionError(f'1deg streamed vs dense: max rel err {rel} > '
                         f'{STREAMED_F32_RTOL}, or B launched '
                         f'{segment.KERNEL.launches} times, not {chunks}')
  log(f'[streamed 1deg] float32 denoiser with edges in chunks of '
      f'{ONE_DEG_CHUNK} ({chunks} grid2mesh chunks, each summed by kernel B'
      f') against the dense one, same weights: max rel err {rel:.3e} (tol '
      f'{STREAMED_F32_RTOL}); phase {time.perf_counter() - t_phase:.1f} s')


def serve_quarter_deg(spec, model, stack, inputs, forcings, dev, card):
  """Phase 24: one 12-hour 0.25-degree forecast step (39 denoiser calls),
  graphed (its first call captures the graph), then the same step eagerly
  from the same generator seed: bitwise equal; launches of A and B per
  request, seconds both ways, the capture, the private pool and the peak
  memory. Returns (seconds graphed, seconds eager, peak bytes, launches)."""
  from gencast_tpu_torch.ops import segment, sparse_attention
  calls = 2 * spec.num_noise_levels - 1
  chunks = model.denoiser.architecture.grid2mesh.streams['g2m'].num_chunks
  expected = (calls * spec.num_layers, calls * chunks)
  torch.cuda.reset_peak_memory_stats()
  seconds, forecasts, launches = [], [], {'A': 0, 'B': 0}
  for graphed in (True, False):
    for counter in (sparse_attention.KERNEL, segment.KERNEL):
      counter.reset()
    gen = torch.Generator(device=dev).manual_seed(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecast = stack.sample(inputs, forcings, gen, graphed=graphed)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    added = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
    if (added != expected or forecast.dtype != torch.float32
        or not torch.isfinite(forecast).all()):
      how = 'graphed' if graphed else 'eager'
      raise AssertionError(f'0.25deg forecast ({how}): launches (A, B) '
                           f'{added}, expected {expected}; '
                           f'{forecast.dtype}, finite '
                           f'{bool(torch.isfinite(forecast).all())}')
    launches = {'A': launches['A'] + added[0], 'B': launches['B'] + added[1]}
    forecasts.append(forecast)
  peak = torch.cuda.max_memory_allocated()
  check_graphed_equals_eager('0.25-degree forecast step', forecasts[0],
                             forecasts[1])
  log(f'[0.25deg serve] one 12-hour step {tuple(forecasts[0].shape)} '
      f'float32, finite; graphed {seconds[0]:.3f} s (with the capture; '
      f'{1e3 * seconds[0] / calls:.1f} ms per denoiser call), eager '
      f'{seconds[1]:.3f} s ({1e3 * seconds[1] / calls:.1f} ms per call); '
      f'launches per request A {expected[0]}, B {expected[1]}; '
      f'{graph_note(stack)}; peak memory {peak / 2**30:.2f} GiB; {card}')
  return seconds[0], seconds[1], peak, launches


def quarter_deg_stats(spec, path):
  """Normalization statistics for the 0.25-degree runs, written to `path`:
  those of the same synthetic source on the 1-degree grid (per variable and
  level; computed on the 0.25-degree grid they cost a minute of host
  time)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  lat, lon = configs.grid_for_resolution(1.0)
  stats = sources.compute_stats(sources.SyntheticSource(spec.task, lat, lon,
                                                        seed=0))
  os.makedirs(os.path.dirname(path), exist_ok=True)
  sources.save_stats(stats, path)


def train_quarter_deg(spec, statics, e_shapes, dev, card, work):
  """Phase 25: `train.main` for 2 steps at --preset 0.25deg (checkpoint at
  the end), the kernel E shapes it gives exactly phase 22's; the same 2
  steps again from the seed, bitwise equal (phase 18's determinism); then
  2 graphed steps against 2 eager steps of a twin (phase 19; the CLI's
  --steps_per_call loop is phase 20's, at nano): launches per step as
  derived in each. Returns (launches of all runs, seconds per step,
  seconds per graphed step, peak bytes, the checkpoint directory, the
  stats path)."""
  t_phase = time.perf_counter()
  stats = os.path.join(work, 'stats.npz')
  quarter_deg_stats(spec, stats)
  ckpt = os.path.join(work, 'ckpt')
  argv = ['--preset', '0.25deg', '--num_layers', str(spec.num_layers),
          '--clean_sst_nans', '--stats_path', stats]
  runs, seen = [], set()
  with recording_ln_film_shapes(seen):
    first, seconds, peak = train_preset(
        spec, statics, dev, card, argv + ['--ckpt_dir', ckpt], steps_run=2,
        tag='0.25deg', runs=runs)
  if seen != set(e_shapes):
    raise AssertionError(f'0.25deg training gave kernel E the shapes '
                         f'{sorted(seen)}, phase 22 checked {e_shapes}')
  log(f'[kernel E] the 0.25-degree training step gave it exactly the '
      f'{len(seen)} shapes phase 22 checked: {sorted(seen)}')
  again, _, _ = train_preset(spec, statics, dev, card, argv, steps_run=2,
                             tag='0.25deg, again from the seed', runs=runs)
  (losses_a, params_a), (losses_b, params_b) = (
      (r.losses, list(r.model.parameters())) for r in runs)
  differing = sum(not torch.equal(a, b) for a, b in zip(params_a, params_b))
  if losses_a != losses_b or differing:
    raise AssertionError(f'0.25deg: two runs from one seed differ: losses '
                         f'{losses_a} and {losses_b}, {differing} of '
                         f'{len(params_a)} parameters differ')
  log(f'[reproducible] 0.25deg: 2 training steps twice from one seed: '
      f'losses {losses_a} and all {len(params_a)} parameters bitwise equal')
  del runs, params_a, params_b
  torch.cuda.empty_cache()
  twin = fused_training(argv, dev, card, k=2, rounds=1, pool_rows=2,
                        tag='0.25deg')
  launches = {k: first[k] + again[k] + twin[0][k] for k in first}
  fused_seconds, fused_peak = twin[1], twin[5]
  log(f'[train 0.25deg] seconds per step {[round(x, 4) for x in seconds]} '
      f'(per-step loop), {[round(x, 4) for x in fused_seconds]} (graph '
      f'replays, the first with its capture); peak memory '
      f'{max(peak, fused_peak) / 2**30:.2f} GiB; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return launches, seconds, fused_seconds, max(peak, fused_peak), ckpt, stats


def evaluate_quarter_deg(spec, dev, card, ckpt, stats, work):
  """Phase 26: `evaluate.main` at 0.25 degrees on phase 25's checkpoint: 1
  member, 2 steps, --chunk_size 1 (each step to the host as it ends):
  launches as derived, finite predictions where the truth is, finite RMSE,
  the peak memory and the wall."""
  from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
  from gencast_tpu_torch.training import evaluate
  rollout_steps = 2
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  out = os.path.join(work, 'eval')
  t0 = time.perf_counter()
  run = evaluate.main(['--preset', '0.25deg', '--num_layers',
                       str(spec.num_layers), '--clean_sst_nans',
                       '--stats_path', stats, '--ckpt_dir', ckpt,
                       '--num_members', '1', '--max_rollout_steps',
                       str(rollout_steps), '--chunk_size', '1', '--out_dir',
                       out, '--plot_vars'])
  wall = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  served = {c.name: c.launches for c in counters()}
  chunks = next(m for m in run.model.modules() if hasattr(m, 'streams')
                and 'g2m' in m.streams).streams['g2m'].num_chunks
  calls = rollout_steps * (2 * spec.num_noise_levels - 1)
  expected = {c.name: 0 for c in counters()}
  expected.update({sparse_attention.KERNEL.name: calls * spec.num_layers,
                   segment.KERNEL.name: calls * chunks,
                   ln_film.KERNEL_FWD.name: calls * ln_film_fwd_launches(
                       run.model)})
  rollout = np.load(os.path.join(out, 'rollout.npz'))
  preds, truth = rollout['predictions'], rollout['truth']
  with open(os.path.join(out, 'metrics.json')) as f:
    scores = json.load(f)
  finite = bool((np.isfinite(preds) | np.isnan(truth)[None]).all())
  if (served != expected or not finite
      or preds.shape[:4] != (1, rollout_steps, 721, 1440)
      or not np.isfinite(list(scores['rmse'].values())).all()):
    raise AssertionError(f'0.25deg evaluate: launches {served} (expected '
                         f'{expected}), predictions {preds.shape}, finite '
                         f'where the truth is {finite}, rmse {scores["rmse"]}')
  log(f'[evaluate 0.25deg] 1 member x {rollout_steps} steps '
      f'{preds.shape} with --chunk_size 1, finite where the truth is; RMSE '
      f'finite (2m_temperature {scores["rmse"]["2m_temperature"]:.4f}); '
      f'launches A {served[sparse_attention.KERNEL.name]}, B '
      f'{served[segment.KERNEL.name]}, as derived; {wall:.1f} s with '
      f'set-up; peak memory {peak / 2**30:.2f} GiB; {card}')
  return wall, peak


def offload_nano(dev, card):
  """Phase 27: `rollout.chunked_rollout` at nano, 4 steps in chunks of 2,
  with the host copy of a chunk overlapped with the next chunk's work and
  serialized after it: both bitwise the unchunked `sample_rollout`, the
  overlapped result in pinned host memory."""
  from gencast_tpu_torch import configs, rollout
  from gencast_tpu_torch.models import wrappers
  spec = configs.NANO
  t_phase = time.perf_counter()
  model, statics = configs.build_gencast(spec, seed=0, device=dev)
  stack = wrappers.build_stack(model, unit_stats(spec.task),
                               bf16=spec.cast_bf16).to(dev)
  den = model.denoiser
  g = torch.Generator(device=dev).manual_seed(7)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.randn(grid + (den.input_layout.num_channels,), generator=g,
                       device=dev)
  forcings = torch.randn((OFFLOAD_STEPS,) + grid
                         + (den.forcing_layout.num_channels,), generator=g,
                         device=dev)
  want = rollout.sample_rollout(stack, inputs, forcings,
                                torch.Generator(device=dev).manual_seed(3))
  want = want.cpu()
  seconds = {}
  for overlap in (True, False):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = rollout.chunked_rollout(
        stack, inputs, forcings, torch.Generator(device=dev).manual_seed(3),
        chunk_size=2, overlap_offload=overlap)
    seconds[overlap] = time.perf_counter() - t0
    if not (got.device.type == 'cpu' and got.is_pinned() == overlap
            and torch.equal(got, want)):
      raise AssertionError(f'nano chunked rollout (overlap_offload={overlap})'
                           f' differs from sample_rollout, or pinned '
                           f'{got.is_pinned()}')
  log(f'[offload nano] chunked_rollout, {OFFLOAD_STEPS} steps in chunks of '
      f'2: overlap_offload on ({seconds[True]:.3f} s, pinned host memory) and'
      f' off ({seconds[False]:.3f} s) bitwise equal to the unchunked '
      f'sample_rollout; phase {time.perf_counter() - t_phase:.1f} s; {card}')


def era5_corpora(work, card):
  """Phase 28: the ERA5-format corpora of phases 29 and 30, written by
  `tools.synth_era5 --layout npz` (numpy only); where h5py imports, also
  the 2.5-degree corpus as NetCDF files, whose source must give the npz
  source's windows, and a published-structure stats directory. Returns
  ({name: directory}, seconds of each write, whether h5py imported)."""
  from gencast_tpu_torch.tools import synth_era5
  dirs, seconds = {}, {}
  for name, (res, months, steps) in ERA5_CORPORA.items():
    dirs[name] = os.path.join(work, f'{name}_npz')
    t0 = time.perf_counter()
    synth_era5.synthesize(dirs[name], resolution_deg=res, months=months,
                          steps_per_month=steps, seed=0, layout='npz')
    seconds[name] = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(dirs[name], f))
               for f in os.listdir(dirs[name]))
    log(f'[era5] {name}: {len(months)} month(s) x {steps} frames at {res} '
        f'degrees, npz layout, {size / 2**20:.1f} MiB written in '
        f'{seconds[name]:.2f} s')
  try:
    import h5py  # noqa: F401
  except ImportError:
    log('[era5] h5py does not import on this machine: the NetCDF layout, '
        'the published stats directory and evaluate --save_netcdf did not '
        'run here; tests/test_torch_era5_*.py hold them on the CPU')
    return dirs, seconds, False
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import era5_netcdf, sources
  res, months, steps = ERA5_CORPORA['nano']
  dirs['nano_netcdf'] = os.path.join(work, 'nano_netcdf')
  dirs['stats'] = os.path.join(work, 'stats')
  t0 = time.perf_counter()
  synth_era5.synthesize(dirs['nano_netcdf'], resolution_deg=res,
                        months=months, steps_per_month=steps, seed=0)
  synth_era5.synthesize_stats(dirs['stats'])
  seconds['nano_netcdf'] = time.perf_counter() - t0
  task = configs.NANO.task
  nc = era5_netcdf.Era5NetCDFSource(dirs['nano_netcdf'], task,
                                    resolution_deg=res)
  npz = sources.Era5NpzSource(dirs['nano'], task)
  for index in (0, len(npz) - 1):
    a, b = nc.sample(index), npz.sample(index)
    if not all(np.array_equal(getattr(a, k), getattr(b, k), equal_nan=True)
               for k in ('inputs', 'targets', 'forcings')):
      raise AssertionError(f'ERA5 window {index}: the NetCDF and npz '
                           'layouts differ')
  stats = sources.load_stats_netcdf(dirs['stats'], task.pressure_levels)
  if stats.mean['temperature'].shape != (len(task.pressure_levels),):
    raise AssertionError(f'published stats: {stats.mean["temperature"]}')
  log(f'[era5] h5py imports: the 2.5-degree corpus as NetCDF and a '
      f'published stats directory in {seconds["nano_netcdf"]:.2f} s; the '
      f'NetCDF source gives the npz source\'s windows; {card}')
  return dirs, seconds, True


def trace_kernel_counts(path) -> dict:
  """Kernels of each launch counter in a torch.profiler Chrome trace."""
  with open(path) as f:
    events = json.load(f)['traceEvents']
  names = [e.get('name', '') for e in events if e.get('cat') == 'kernel']
  return {name: sum(1 for n in names if re.search(pattern, n))
          for name, pattern in TRACE_KERNELS.items()}


def run_train_cli(argv, metrics, tag):
  """`python3 -m gencast_tpu_torch.training.train argv` in a fresh
  process from the repository root: its wall seconds, stdout, losses (from
  --metrics_jsonl `metrics`), input pipeline summary, kernel launches and
  worker start-up seconds. Raises if it fails."""
  repo = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  done = subprocess.run(
      [sys.executable, '-m', 'gencast_tpu_torch.training.train'] + argv
      + ['--metrics_jsonl', metrics], cwd=repo, capture_output=True,
      text=True, timeout=900)
  wall = time.perf_counter() - t0
  if done.returncode:
    raise AssertionError(f'{tag}: train CLI exit {done.returncode}\n'
                         f'{done.stdout[-3000:]}\n{done.stderr[-5000:]}')
  out = done.stdout

  def line(prefix):
    return json.loads(next(x for x in out.splitlines()
                           if x.startswith(prefix))[len(prefix):])

  with open(metrics) as f:
    losses = [r['loss'] for r in map(json.loads, f) if r['event'] == 'train']
  started = re.search(r'worker processes \(started in ([0-9.]+) s\)', out)
  return {'wall': wall, 'stdout': out, 'losses': losses,
          'pipeline': line('[train] pipeline '),
          'launches': line('[train] kernel launches in this process '),
          'worker_start_s': float(started.group(1)) if started else None}


def same_state(a, b) -> bool:
  """Bitwise equality of two checkpoint trees (dicts, lists, tensors)."""
  if isinstance(a, dict):
    return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
  if isinstance(a, (list, tuple)):
    return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
  if isinstance(a, torch.Tensor):
    return torch.equal(a, b)
  return a == b


def nano_era5_cli(spec, statics, dev, card, data, work) -> dict:
  """Phase 29: nano from the 2.5-degree npz directory through the CLI's
  module entry point, each run a fresh process: 16 steps with --prefetch 2,
  --data_workers 2, --profile_dir (the process's only profiler session)
  and checkpoints; the same 16 steps with --prefetch 0 --data_workers 0:
  bitwise equal losses and checkpoint (parameters and optimizer state);
  a resume of the first to step 20, whose losses equal 4 steps taken here
  from the second's checkpoint on the stream's first 4 batches (the
  reference restarts the stream on resume) with steps 16-19's draws. The
  trace holds B, C, D and E for steps 10-15 in the counts the launch
  counters derive, and each run's launches are 'per step x steps', as are
  the 4 steps taken here. Returns each kernel's launches over the CLI's
  runs (the steps taken here only check the resume)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.training import checkpoint, steps, train
  t_phase = time.perf_counter()
  t0 = time.perf_counter()
  source = sources.Era5NpzSource(data, spec.task)
  load_s = time.perf_counter() - t0
  it = sources.batch_iterator(source, 1, seed=0)
  next(it)
  t0 = time.perf_counter()
  for _ in range(8):
    next(it)
  pack_ms = (time.perf_counter() - t0) / 8 * 1e3
  del it, source

  gencast, _ = configs.build_gencast(spec, seed=0, statics=statics,
                                     device=dev)
  per_step = expected_step_launches(gencast)
  del gencast
  trace_dir = os.path.join(work, 'trace')
  ckpt = {k: os.path.join(work, f'ckpt_{k}') for k in ('piped', 'plain')}
  base = ['--preset', spec.name, '--num_layers', str(spec.num_layers),
          '--device', dev.type, '--data', data, '--log_every', '1',
          '--save_every', '8']
  piped = ['--prefetch', '2', '--data_workers', '2']
  runs = {
      'piped': run_train_cli(
          base + piped + ['--steps', str(ERA5_NANO_STEPS), '--profile_dir',
                          trace_dir, '--ckpt_dir', ckpt['piped']],
          os.path.join(work, 'piped.jsonl'), 'nano ERA5, piped'),
      'plain': run_train_cli(
          base + ['--prefetch', '0', '--data_workers', '0', '--steps',
                  str(ERA5_NANO_STEPS), '--ckpt_dir', ckpt['plain']],
          os.path.join(work, 'plain.jsonl'), 'nano ERA5, plain'),
      'resumed': run_train_cli(
          base + piped + ['--steps', str(ERA5_RESUME_STEPS), '--ckpt_dir',
                          ckpt['piped']],
          os.path.join(work, 'resumed.jsonl'), 'nano ERA5, resumed')}
  taken = {'piped': ERA5_NANO_STEPS, 'plain': ERA5_NANO_STEPS,
           'resumed': ERA5_RESUME_STEPS - ERA5_NANO_STEPS}
  for name, run in runs.items():
    want = {k: v * taken[name] for k, v in per_step.items()}
    if run['launches'] != want or len(run['losses']) != taken[name]:
      raise AssertionError(f'nano ERA5 {name}: launches {run["launches"]}, '
                           f'expected {want}; {len(run["losses"])} losses')
  first, last_step = train.PROFILE_STEPS
  profiled = last_step - first + 1
  in_trace = trace_kernel_counts(os.path.join(
      trace_dir, train.PROFILE_TRACE))
  want = {k: v * profiled for k, v in per_step.items()}
  if in_trace != want:
    raise AssertionError(f'nano ERA5 trace of steps {first}-{last_step}: '
                         f'kernels {in_trace}, expected {want}')
  last = f'step_{ERA5_NANO_STEPS - 1}.pt'
  states = [torch.load(os.path.join(ckpt[k], last), map_location='cpu',
                       weights_only=True) for k in ('piped', 'plain')]
  if (runs['piped']['losses'] != runs['plain']['losses']
      or not np.isfinite(runs['piped']['losses']).all()
      or not same_state(*states)):
    raise AssertionError(
        f'nano ERA5: --prefetch 2 --data_workers 2 and --prefetch 0 '
        f'--data_workers 0 differ: losses {runs["piped"]["losses"]} and '
        f'{runs["plain"]["losses"]}, checkpoints equal '
        f'{same_state(*states)}')
  del states
  if f'resumed from step {ERA5_NANO_STEPS - 1}' not in runs['resumed'][
      'stdout']:
    raise AssertionError('nano ERA5: the run did not resume')
  args = train.parse_args(base[:8] + ['--steps', str(ERA5_RESUME_STEPS)])
  here = train.setup(args)
  checkpoint.restore(checkpoint.create_manager(ckpt['plain']), here.wrapped,
                     here.optimizer)
  for c in counters():
    c.reset()
  losses = []
  for step in range(ERA5_NANO_STEPS, ERA5_RESUME_STEPS):
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in next(here.batches).items()}
    loss, _ = steps.train_step(here.wrapped, here.optimizer, batch['inputs'],
                               batch['targets'], batch['forcings'],
                               train.step_generator(args.seed, step, dev))
    losses.append(float(loss))
  resumed_here = {c.name: c.launches for c in counters()}
  want = {k: v * taken['resumed'] for k, v in per_step.items()}
  if losses != runs['resumed']['losses'] or resumed_here != want:
    raise AssertionError(f'nano ERA5 resume: losses {runs["resumed"]["losses"]}'
                         f', the same steps here {losses}; launches here '
                         f'{resumed_here}, expected {want}')
  del here

  def pipeline(run):
    p = run['pipeline']
    wait = 1e3 * p['batch_wait_s']['mean']
    step = 1e3 * p['step_s']['mean']
    start = (f', workers started in {run["worker_start_s"]:.2f} s'
             if run['worker_start_s'] is not None else '')
    return (f'prefetch {p["prefetch"]}, {p["data_workers"]} workers: wall '
            f'{run["wall"]:.1f} s{start}; mean over steps 2-: batch wait '
            f'{wait:.3f} ms, step {step:.2f} ms, step wall '
            f'{wait + step:.2f} ms')

  log(f'[era5 nano CLI] packing {pack_ms:.2f} ms per batch in-process '
      f'(Era5NpzSource, 2.5 degrees, batch 1; the source loads in '
      f'{load_s:.2f} s); 16 steps {pipeline(runs["piped"])}; 16 steps '
      f'{pipeline(runs["plain"])}; losses and checkpoints bitwise equal; '
      f'resumed at step {ERA5_NANO_STEPS}: {pipeline(runs["resumed"])}, '
      f'losses equal to the same steps here; trace of steps '
      f'{first}-{last_step}: {in_trace}, as derived; '
      f'phase {time.perf_counter() - t_phase:.1f} s; {card}')
  return {c.name: sum(r['launches'][c.name] for r in runs.values())
          for c in counters()}


def one_deg_era5(spec, statics, dev, card, data, work, has_h5py) -> dict:
  """Phase 30: full-width 1 degree from the 1-degree npz directory in this
  process: `train.main` for 3 steps (stats computed from the source; A, B,
  E and F launches per step as derived, as phase 10), then `evaluate.main`
  on its checkpoint, 1 member x 2 steps, truth from the directory (with
  --save_netcdf where h5py imports): launches as derived, finite where the
  truth is, the walls and peak memory. Returns each kernel's launches."""
  from gencast_tpu_torch.ops import ln_film, segment, sparse_attention
  from gencast_tpu_torch.training import evaluate
  ckpt = os.path.join(work, 'ckpt_1deg')
  t0 = time.perf_counter()
  trained, seconds, train_peak = train_preset(
      spec, statics, dev, card, ['--preset', '1deg', '--num_layers',
                                 str(spec.num_layers), '--clean_sst_nans',
                                 '--ckpt_dir', ckpt],
      tag='1deg from ERA5', data=data)
  train_wall = time.perf_counter() - t0
  rollout_steps = 2
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  out = os.path.join(work, 'eval_1deg')
  t0 = time.perf_counter()
  run = evaluate.main(['--preset', '1deg', '--num_layers',
                       str(spec.num_layers), '--clean_sst_nans', '--data',
                       data,
                 '--ckpt_dir', ckpt, '--num_members', '1',
                 '--max_rollout_steps', str(rollout_steps), '--out_dir', out,
                 '--plot_vars'] + (['--save_netcdf'] if has_h5py else []))
  eval_wall = time.perf_counter() - t0
  eval_peak = torch.cuda.max_memory_allocated()
  served = {c.name: c.launches for c in counters()}
  calls = rollout_steps * (2 * spec.num_noise_levels - 1)
  expected = {c.name: 0 for c in counters()}
  expected.update({sparse_attention.KERNEL.name: calls * spec.num_layers,
                   segment.KERNEL.name: calls,
                   ln_film.KERNEL_FWD.name: calls * ln_film_fwd_launches(
                       run.model)})
  rollout = np.load(os.path.join(out, 'rollout.npz'))
  preds, truth = rollout['predictions'], rollout['truth']
  with open(os.path.join(out, 'metrics.json')) as f:
    scores = json.load(f)
  finite = bool((np.isfinite(preds) | np.isnan(truth)[None]).all())
  netcdf = os.path.exists(os.path.join(out, 'rollout.nc'))
  if (served != expected or not finite or netcdf != has_h5py
      or preds.shape[:4] != (1, rollout_steps, 181, 360)
      or not np.isfinite(list(scores['rmse'].values())).all()):
    raise AssertionError(f'1deg evaluate from ERA5: launches {served} '
                         f'(expected {expected}), predictions {preds.shape}, '
                         f'finite where the truth is {finite}, rollout.nc '
                         f'{netcdf}, rmse {scores["rmse"]}')
  log(f'[era5 1deg] training 3 steps from the ERA5 directory: wall '
      f'{train_wall:.1f} s with set-up, steps {[round(x, 4) for x in seconds]}'
      f' s, peak {train_peak / 2**30:.2f} GiB; evaluate 1 member x '
      f'{rollout_steps} steps: wall {eval_wall:.1f} s with set-up, peak '
      f'{eval_peak / 2**30:.2f} GiB, launches A '
      f'{served[sparse_attention.KERNEL.name]}, B {served[segment.KERNEL.name]}'
      f' as derived, finite where the truth is, RMSE 2m_temperature '
      f'{scores["rmse"]["2m_temperature"]:.4f}'
      f'{", rollout.nc written" if netcdf else ""}; {card}')
  return {k: trained[k] + served[k] for k in trained}


def quarter_deg_f_row(result, part, shape) -> dict:
  """Kernel F's (part 'dq' or 'dkv') 0.25-degree figures in bf16 for its
  JSON row; the library call is the whole backward (dq, dk and dv)."""
  errs, ms, costs = result
  bound_ms, bound_by = bound(*costs[part], torch.bfloat16)
  return {'shape': list(shape), 'max_abs_err': errs[part][1],
          'ms': ms[part], 'plain_ms': ms[f'{part}_plain'],
          'bound_ms': bound_ms, 'bound_by': bound_by,
          'library_ms': ms['library']}


def quarter_deg_row(result, shape, dtype) -> dict:
  """A kernel's 0.25-degree figures for its JSON row."""
  err, ms, cost = result
  bound_ms, bound_by = bound(*cost, dtype)
  return {'shape': list(shape), 'max_abs_err': err, 'ms': ms['kernel'],
          'plain_ms': ms['plain'], 'bound_ms': bound_ms, 'bound_by': bound_by,
          'library_ms': ms.get('library')}


# --- GraphCast (phases 31-34) ---

# Steps of the served GraphCast rollouts (phase 32).
GC_ROLLOUT_STEPS = 4


def graphcast_b_launches(gc, train: bool, ar_steps: int = 1) -> int:
  """Kernel B launches of one GraphCast forward (train=False) or one
  training step (train=True; with ar_steps K > 1 the K-step autoregressive
  loss, each of its steps recomputed in the backward), derived from the
  model. On the card every edge side of non-uniform degree carries a plan:
  B runs once per receiver sum over such a side each time its net runs
  forward (again in each recomputation: a streamed net's chunks always,
  the whole encoder and decoder and each processor step with remat, each
  group of steps too with remat_group > 1), and in training once per
  gather over such a side (its backward; a streamed net's sender gathers
  always)."""
  outer = 2 if (train and ar_steps > 1) else 1
  remat = train and gc.config.remat
  group = gc.mesh_gnn.remat_group if remat else 1
  per_step = 0
  for net in (gc.grid2mesh, gc.mesh_gnn, gc.mesh2grid):
    if net.edge_chunk_size is not None:
      runs = outer + train + remat  # forward, chunk remat, GNN remat
      for topo in net.topologies:
        stream = net.streams[topo.name]
        if stream.uniform_k is None:
          per_step += stream.num_chunks * (runs + train)
        per_step += stream.num_chunks * train
      continue
    runs = outer + remat
    steps = len(net.processors)
    for inet in net.processors:
      for topo in inet.topologies:
        send_k, recv_k = inet._uniform[topo.name]
        if recv_k is None:
          per_step += runs + train  # the sums, the receiver gather's bwd
        if send_k is None:
          per_step += train  # the sender gather's backward
    if net is gc.mesh_gnn and group > 1:
      # A group's recomputation runs its steps but the last: torch's
      # checkpoint stops once it has what the backward needs, the last
      # step's inputs (that step is recomputed by its own checkpoint).
      groups = -(-steps // group)
      sums = sum(net.processors[0]._uniform[t.name][1] is None
                 for t in net.topologies)
      per_step += (steps - groups) * sums
  return per_step * (ar_steps if train else 1)


def graphcast_launches(gc, train: bool, ar_steps: int = 1) -> dict:
  """Every kernel's launches per GraphCast forward or training step: B as
  derived, no other (its MLPs end in a LayerNorm with a learned scale and
  bias, so kernel E, the LN+FiLM backward, is not on its path)."""
  from gencast_tpu_torch.ops import segment
  launches = {c.name: 0 for c in counters()}
  launches[segment.KERNEL.name] = graphcast_b_launches(gc, train, ar_steps)
  return launches


def graphcast_statics(spec, card):
  """Phase 31: GraphCast_small's statics at 1 degree (the multimesh, no
  attention mask), built, then loaded from the on-disk cache under their
  own key (GenCast's 1-degree entry, from phase 2, is another file): the
  same arrays; the multimesh's counts and degrees."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.graph import compiler
  lat, lon = configs.grid_for_resolution(spec.resolution_deg)
  cache = configs.DEFAULT_CACHE_DIR
  before = set(os.listdir(cache))
  seconds, built = [], []
  for _ in range(2):
    t0 = time.perf_counter()
    built.append(compiler.build_graph_statics(
        spec.mesh_splits, lat, lon,
        radius_query_fraction_edge_length=(
            spec.radius_query_fraction_edge_length),
        build_multimesh=True, cache_dir=cache))
    seconds.append(time.perf_counter() - t0)
  added = set(os.listdir(cache)) - before
  cold, warm = built
  for name in ('multimesh_edges', 'grid2mesh', 'mesh2grid', 'mesh_edges'):
    for field in ('senders', 'receivers', 'features'):
      if not np.array_equal(getattr(getattr(cold, name), field),
                            getattr(getattr(warm, name), field)):
        raise AssertionError(f'GraphCast statics from the cache: {name}.'
                             f'{field} differs from the build')
  mm = warm.multimesh_edges
  indeg = np.bincount(mm.receivers, minlength=warm.num_mesh_nodes)
  outdeg = np.bincount(mm.senders, minlength=warm.num_mesh_nodes)
  want_edges = sum(3 * 20 * 4 ** s for s in range(spec.mesh_splits + 1))
  if (len(added) != 1 or mm.num_edges != want_edges
      or warm.attention_tile_plan is not None
      or warm.attention_mask is not None):
    raise AssertionError(f'GraphCast statics: {len(added)} new cache files, '
                         f'{mm.num_edges} multimesh edges (expected '
                         f'{want_edges}), tile plan or mask built')
  log(f'[graphcast statics] {spec.name}: built in {seconds[0]:.1f} s, '
      f'loaded from the cache in {seconds[1]:.2f} s (a file of its own, '
      f'beside GenCast\'s); multimesh {mm.num_edges} edges into '
      f'{warm.num_mesh_nodes} nodes, in-degree {indeg.min()}-{indeg.max()} '
      f'({int((indeg == indeg.max()).sum())} nodes at the maximum), '
      f'out-degree {outdeg.min()}-{outdeg.max()}; grid2mesh '
      f'{warm.grid2mesh.num_edges} edges, mesh2grid '
      f'{warm.mesh2grid.num_edges}; {card}')
  return warm


def tisr_timing(spec, statics, dev, card):
  """Phase 31: TISR (`ops.solar.tisr_for_grid`, 361 flux evaluations per
  point) for one 1-degree frame on this machine's CPU and on the card, one
  0.25-degree frame on the card, and the packing of one GraphCast_small
  window (three TISR frames among its channels) with TISR on each, the
  card's bitwise the CPU's to 1e-5 of the field's maximum. Returns the
  seconds."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import registry, sources
  from gencast_tpu_torch.ops import solar
  t = np.array([1.0e9])
  lat, lon = configs.grid_for_resolution(spec.resolution_deg)
  out = {}
  for where in ('cpu', dev):
    solar.tisr_for_grid(t, lat, lon, device=where)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    field = solar.tisr_for_grid(t, lat, lon, device=where)
    torch.cuda.synchronize()
    out[f'frame_{torch.device(where).type}_s'] = time.perf_counter() - t0
    out[torch.device(where).type] = field.cpu()
  err = float((out['cuda'] - out['cpu']).abs().max())
  if err > 1e-5 * float(out['cpu'].abs().max()):
    raise AssertionError(f'TISR on the card vs the CPU: {err}')
  q_lat, q_lon = configs.grid_for_resolution(0.25)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  solar.tisr_for_grid(t, q_lat, q_lon, device=dev)
  torch.cuda.synchronize()
  out['frame_0.25deg_cuda_s'] = time.perf_counter() - t0
  task = dataclasses.replace(registry.GRAPHCAST_TASK_13,
                             pressure_levels=spec.task.pressure_levels)
  source = sources.SyntheticSource(task, statics.grid_lat, statics.grid_lon)
  source.sample(0)  # the synthetic fields' cache
  for where in ('cpu', dev):
    source.forcing_device = where
    t0 = time.perf_counter()
    source.sample(1)
    out[f'window_{torch.device(where).type}_s'] = time.perf_counter() - t0
  log(f'[tisr] one 1-degree frame (65,160 points x 361 bins): CPU '
      f'{out["frame_cpu_s"]:.3f} s ({torch.get_num_threads()} threads), card '
      f'{out["frame_cuda_s"]:.4f} s, max abs difference {err:.3e} J/m^2; a '
      f'0.25-degree frame on the card {out["frame_0.25deg_cuda_s"]:.4f} s; '
      f'packing a GraphCast_small window (3 TISR frames) with TISR on the '
      f'CPU {out["window_cpu_s"]:.3f} s, on the card '
      f'{out["window_cuda_s"]:.3f} s; {card}')
  return {k: v for k, v in out.items() if k.endswith('_s')}


def check_graphcast_segment_sums(spec, statics, g, card):
  """Phase 31: kernel B on the plans GraphCast's path takes on the card
  (the multimesh's receivers and senders, the grid2mesh receivers and
  senders), as phase 4 (check_segment_plan)."""
  results = {}
  mm = statics.multimesh_edges
  for name, ids, n in (
      ('multimesh receivers', mm.receivers, statics.num_mesh_nodes),
      ('multimesh senders', mm.senders, statics.num_mesh_nodes),
      ('graphcast grid2mesh receivers', statics.grid2mesh.receivers,
       statics.num_mesh_nodes),
      ('graphcast grid2mesh senders', statics.grid2mesh.senders,
       statics.num_grid_nodes)):
    results.update(check_segment_plan(name, ids, n, spec.d_model, g, card))
  return results


def graphcast_stacks(spec, statics, dev):
  """GraphCast through the kernels and through the plain path
  (use_kernels=False), the same seeded weights perturbed, each in its
  serving stack (unit statistics, bf16 where the spec is): (model, stack,
  plain stack)."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  model, _ = configs.build_graphcast(spec, statics=statics, device=dev)
  flat = bridge.perturbed(bridge.export_reference_params(model), seed=1)
  bridge.load_reference_params(model, flat)
  plain, _ = configs.build_graphcast(spec, statics=statics, device=dev,
                                     use_kernels=False)
  bridge.load_reference_params(plain, flat)
  stats = unit_stats(model.task)
  return (model,
          wrappers.build_stack(model, stats, bf16=spec.cast_bf16).to(dev),
          wrappers.build_stack(plain, stats, bf16=spec.cast_bf16).to(dev))


def graphcast_inputs(model, dev, g, steps):
  """Seeded inputs [1, lat, lon, C_in] and forcings [steps, 1, lat, lon,
  C_frc] (raw space; unit statistics)."""
  grid = (1, model.num_lat, model.num_lon)
  inputs = torch.randn(grid + (model.input_layout.num_channels,),
                       generator=g, device=dev)
  forcings = torch.randn((steps,) + grid
                         + (model.forcing_layout.num_channels,),
                         generator=g, device=dev)
  return inputs, forcings


def serve_graphcast(spec, statics, dev, g, card):
  """Phase 32: GraphCast_small at 1 degree (seeded, perturbed, bf16 stack):
  one forecast step through the kernels against the plain path; a
  4-step `rollout.predict_rollout` whose steps replay the model's CUDA
  graph, against the same rollout eagerly (bitwise equal) and
  `chunked_rollout(mode='predict', chunk_size=2)` (bitwise equal); B
  launches per step as derived, ms per step graphed and eager, the
  graph's replay alone (the forward's device time), the peak memory.
  Returns the timings, with the model's task (GraphCast's variables) under
  'task'."""
  from gencast_tpu_torch import rollout
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.ops import segment
  torch.cuda.reset_peak_memory_stats()
  model, stack, plain_stack = graphcast_stacks(spec, statics, dev)
  inputs, forcings = graphcast_inputs(model, dev, g, GC_ROLLOUT_STEPS)
  per_call = graphcast_b_launches(model, train=False)
  with torch.no_grad():
    segment.KERNEL.reset()
    out_k = stack.predict(inputs, forcings[0])
    torch.cuda.synchronize()
    launched = segment.KERNEL.launches
    out_p = plain_stack.predict(inputs, forcings[0], graphed=False)
    rel = float((out_k - out_p).abs().max() / out_p.abs().max())
    if (launched != per_call or not torch.isfinite(out_k).all()
        or rel > DENOISER_BF16_RTOL):
      raise AssertionError(f'GraphCast step: B launches {launched} '
                           f'(expected {per_call}), kernels vs plain rel err '
                           f'{rel} > {DENOISER_BF16_RTOL} or not finite')
    (cast,) = [m for m in stack.modules()
               if isinstance(m, casting.Bfloat16Cast)]
    (pgraph,) = cast._bf16.predict_graphs.graphs.values()
    ms = time_in_turns({
        'plain': lambda: plain_stack.predict(inputs, forcings[0],
                                             graphed=False),
        'eager': lambda: stack.predict(inputs, forcings[0], graphed=False),
        'graphed': lambda: stack.predict(inputs, forcings[0]),
        'replay': pgraph.graph.graph.replay}, reps=5)
    seconds, outs = {}, {}
    for how, jit in (('graphed', True), ('eager', False)):
      segment.KERNEL.reset()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      outs[how] = rollout.predict_rollout(stack, inputs, forcings, jit=jit)
      torch.cuda.synchronize()
      seconds[how] = time.perf_counter() - t0
      if segment.KERNEL.launches != GC_ROLLOUT_STEPS * per_call:
        raise AssertionError(f'GraphCast rollout ({how}): B launches '
                             f'{segment.KERNEL.launches}, expected '
                             f'{GC_ROLLOUT_STEPS * per_call}')
    check_graphed_equals_eager('GraphCast 4-step rollout', outs['graphed'],
                               outs['eager'])
    chunked = rollout.chunked_rollout(stack, inputs, forcings, chunk_size=2,
                                      mode='predict')
    if not torch.equal(chunked, outs['graphed'].cpu()):
      raise AssertionError('GraphCast chunked rollout differs from the '
                           'unchunked one')
  peak = torch.cuda.max_memory_allocated()
  shape = tuple(outs['graphed'].shape)
  log(f'[graphcast serve] {spec.name} GraphCast_small '
      f'({sum(p.numel() for p in model.parameters())} parameters, bf16): '
      f'kernels vs plain max rel err {rel:.3e} (tol {DENOISER_BF16_RTOL}); '
      f'B {per_call} launches per step, as derived; ms per step graphed '
      f'{ms["graphed"]:.2f} (the graph\'s replay alone {ms["replay"]:.2f}), '
      f'eager {ms["eager"]:.2f}, plain path {ms["plain"]:.2f}; '
      f'{GC_ROLLOUT_STEPS}-step rollout {shape}: graphed '
      f'{seconds["graphed"]:.3f} s, eager {seconds["eager"]:.3f} s, bitwise '
      f'equal; chunked (2) bitwise equal; capture '
      f'{pgraph.graph.capture_seconds:.2f} s, private pool '
      f'{pgraph.graph.pool_bytes / 2**30:.2f} GiB; peak memory '
      f'{peak / 2**30:.2f} GiB; {card}')
  return dict(ms, rollout_graphed_s=seconds['graphed'],
              rollout_eager_s=seconds['eager'], peak=peak, task=model.task)


def graphcast_cli(argv, steps_run, tag, card, start=0):
  """`train.main` of a GraphCast run (`argv`) up to step `steps_run`,
  starting at `start`: finite losses, each kernel's launches per step as
  derived (B only; with --do_sampling_eval --eval_every 1, a forward's
  more per step). Logs the batch wait (--prefetch's thread packs the
  windows, TISR on the card). Returns (the run, its launches)."""
  from gencast_tpu_torch.models.graphcast import GraphCast
  from gencast_tpu_torch.ops import segment
  from gencast_tpu_torch.training import train
  torch.cuda.reset_peak_memory_stats()
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  run = train.main(argv + ['--steps', str(steps_run), '--log_every', '1'])
  wall = time.perf_counter() - t0
  launches = {c.name: c.launches for c in counters()}
  gc = next(m for m in run.model.modules() if isinstance(m, GraphCast))
  ar = int(argv[argv.index('--ar_steps') + 1]) if '--ar_steps' in argv else 1
  per_step = graphcast_launches(gc, train=True, ar_steps=ar)
  taken = steps_run - start
  expected = {k: v * taken for k, v in per_step.items()}
  if '--do_sampling_eval' in argv:
    assert argv[argv.index('--eval_every') + 1] == '1'
    for k, v in graphcast_launches(gc, train=False).items():
      expected[k] += v * taken
  if not (run.start_step == start and len(run.losses) == taken
          and np.isfinite(run.losses).all() and launches == expected):
    raise AssertionError(f'{tag}: from step {run.start_step} (expected '
                         f'{start}), losses {run.losses}, launches '
                         f'{launches} (expected {expected})')
  peak = torch.cuda.max_memory_allocated()
  log(f'[graphcast train {tag}] steps {start + 1}-{steps_run}, losses '
      f'{run.losses}; seconds per step '
      f'{[round(x, 4) for x in run.step_seconds]}, batch wait '
      f'{[round(x, 4) for x in run.batch_seconds]} (wall {wall:.1f} s with '
      f'set-up and data); B {per_step[segment.KERNEL.name]} launches per '
      f'step, no other kernel, as derived; peak memory '
      f'{peak / 2**30:.2f} GiB; {card}')
  run.peak = peak
  return run, launches


def same_run(a, b) -> bool:
  """Equal losses and bitwise equal parameters."""
  return a.losses == b.losses and same_state(
      dict(a.model.named_parameters()), dict(b.model.named_parameters()))


def train_graphcast(spec, statics, dev, card, work):
  """Phase 33: GraphCast_small at 1 degree through the training CLI
  (synthetic data, statistics computed by the first run and read by the
  others): 4 per-step (eager) steps, each followed by a sampling eval
  (--do_sampling_eval --eval_every 1: a predict graph captured, then
  replayed, while --prefetch's thread packs windows with TISR on the
  card); 4 steps with --steps_per_call 2
  (replays of one CUDA graph of the step), bitwise the eager run's, and
  again from the seed, the same bits; --ar_steps 2 for 4 steps with a
  checkpoint, resumed to step 5; --ar_steps 2 --steps_per_call 2, bitwise
  the eager AR run's 4 steps; then `evaluate.main --model graphcast` on
  the checkpoint, 2 steps. Returns (the launches of every run, seconds per
  step by run, the peak)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.models.graphcast import GraphCast
  from gencast_tpu_torch.training import evaluate
  t_phase = time.perf_counter()
  os.makedirs(work, exist_ok=True)
  stats = os.path.join(work, 'stats.npz')
  ckpt = os.path.join(work, 'ckpt')
  base = ['--model', 'graphcast', '--preset', spec.name, '--num_layers',
          str(spec.num_layers), '--data', 'synthetic', '--stats_path', stats]
  eager, l_eager = graphcast_cli(
      base + ['--do_sampling_eval', '--eval_every', '1'], 4,
      'eager, sampling evals', card)
  initial, _ = configs.build_graphcast(spec, statics=statics, device=dev)
  changed = max(float((p.detach() - p0.detach()).abs().max())
                for p, p0 in zip(eager.model.parameters(),
                                 initial.parameters()))
  del initial
  fused = base + ['--steps_per_call', '2']
  graphed, l_graphed = graphcast_cli(fused, 4, 'graphed', card)
  again, l_again = graphcast_cli(fused, 4, 'graphed, again', card)
  if not (changed > 0 and same_run(eager, graphed)
          and same_run(graphed, again)):
    raise AssertionError(f'GraphCast 1deg: parameters changed by {changed}; '
                         f'graphed {graphed.losses} against eager '
                         f'{eager.losses} and again {again.losses}, or the '
                         'parameters differ')
  ar = base + ['--ar_steps', '2']
  ar_eager, l_ar = graphcast_cli(ar + ['--ckpt_dir', ckpt], 4, 'AR 2', card)
  resumed, l_resumed = graphcast_cli(ar + ['--ckpt_dir', ckpt], 5,
                                     'AR 2, resumed', card, start=4)
  ar_graphed, l_ar_graphed = graphcast_cli(ar + ['--steps_per_call', '2'], 4,
                                           'AR 2, graphed', card)
  if not same_run(ar_eager, ar_graphed):
    raise AssertionError(f'GraphCast AR graphed {ar_graphed.losses} against '
                         f'eager {ar_eager.losses}, or the parameters differ')
  for c in counters():
    c.reset()
  t0 = time.perf_counter()
  ev = evaluate.main(['--model', 'graphcast', '--preset', spec.name,
                      '--num_layers', str(spec.num_layers), '--stats_path',
                      stats, '--ckpt_dir', ckpt,
                      '--max_rollout_steps', '2', '--plot_vars',
                      '--out_dir', os.path.join(work, 'eval')])
  ev_wall = time.perf_counter() - t0
  gc = next(m for m in ev.model.modules() if isinstance(m, GraphCast))
  ev_launches = {c.name: c.launches for c in counters()}
  want = {k: 2 * v for k, v in graphcast_launches(gc, train=False).items()}
  if (ev_launches != want or not np.isfinite(ev.predictions).all()
      or ev.predictions.shape[:2] != (1, 2)):
    raise AssertionError(f'GraphCast evaluate: launches {ev_launches} '
                         f'(expected {want}), {ev.predictions.shape}')
  runs = {'eager': eager, 'graphed': graphed, 'ar_eager': ar_eager,
          'ar_graphed': ar_graphed}
  peak = max(r.peak for r in runs.values())
  log(f'[graphcast train] {spec.name}: graphed steps (--steps_per_call 2) '
      f'bitwise the eager ones and again from the seed; AR graphed bitwise '
      f'AR eager; resumed at step 4 from the checkpoint; max |parameter '
      f'change| {changed:.3e}; evaluate 1 x 2 steps finite, RMSE '
      f'2m_temperature {ev.results["rmse"]["2m_temperature"]:.4f}, '
      f'{ev_wall:.1f} s with set-up; peak memory {peak / 2**30:.2f} GiB; '
      f'phase {time.perf_counter() - t_phase:.1f} s; {card}')
  launches = [l_eager, l_graphed, l_again, l_ar, l_resumed, l_ar_graphed,
              ev_launches]
  total = {k: sum(x[k] for x in launches) for k in l_eager}
  return total, {k: r.step_seconds for k, r in runs.items()}, peak


def graphcast_stats(task, path):
  """Normalization statistics for the 0.25-degree GraphCast runs, written
  to `path`: those of the same synthetic source on the 2.5-degree grid
  over 8 frames (per variable and level; on the 0.25-degree grid with 37
  levels they would take GBs and minutes of host time)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import sources
  lat, lon = configs.grid_for_resolution(2.5)
  stats = sources.compute_stats(sources.SyntheticSource(task, lat, lon,
                                                        seed=0),
                                max_samples=8)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  sources.save_stats(stats, path)


def quarter_deg_graphcast(dev, g, card, work):
  """Phase 34: the paper's GraphCast at 0.25 degrees (`--preset 0.25deg
  --task graphcast_37 --remat_group 4`: 37 levels, splits 6, streamed
  grid2mesh and mesh2grid, grouped processor remat): its statics (built,
  then from the cache for the CLI); kernel B against its plain version on
  the splits-6 multimesh's receiver and sender plans, as phase 31; one
  forecast step graphed and eagerly (bitwise equal, B as derived), and
  eagerly through the plain path (use_kernels=False, the same weights)
  within DENOISER_BF16_RTOL; then 2 training steps through the CLI, B as
  derived. Returns (the training launches, seconds per step, the serving
  seconds and the peaks, B's results on the multimesh)."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import registry
  from gencast_tpu_torch.ops import segment
  t_phase = time.perf_counter()
  spec = dataclasses.replace(configs.QUARTER_DEG,
                             task=registry.TASKS['graphcast_37'])
  stats = os.path.join(work, 'stats.npz')
  graphcast_stats(spec.task, stats)
  t0 = time.perf_counter()
  model, statics = configs.build_graphcast(spec, seed=0, device=dev,
                                           remat_group=4)
  built_s = time.perf_counter() - t0
  mm = statics.multimesh_edges
  b_results = {'edges': mm.num_edges}
  for name, ids in (('receivers', mm.receivers), ('senders', mm.senders)):
    b_results.update(check_segment_plan(
        f'0.25deg multimesh {name}', ids, statics.num_mesh_nodes,
        spec.d_model, g, card))
  torch.cuda.empty_cache()
  torch.cuda.reset_peak_memory_stats()
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import wrappers
  stack = wrappers.build_stack(model, sources.load_stats(stats),
                               bf16=True).to(dev)
  inputs, forcings = graphcast_inputs(model, dev, g, 1)
  per_call = graphcast_b_launches(model, train=False)
  outs, seconds = {}, {}
  with torch.no_grad():
    for how, jit in (('graphed', True), ('graphed, replay', True),
                     ('eager', False)):
      segment.KERNEL.reset()
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      outs[how] = stack.predict(inputs, forcings[0], graphed=jit)
      torch.cuda.synchronize()
      seconds[how] = time.perf_counter() - t0
      if (segment.KERNEL.launches != per_call
          or not torch.isfinite(outs[how]).all()):
        raise AssertionError(f'0.25deg GraphCast step ({how}): B launches '
                             f'{segment.KERNEL.launches}, expected '
                             f'{per_call}, or not finite')
  check_graphed_equals_eager('0.25-degree GraphCast step',
                             outs['graphed, replay'], outs['eager'])
  serve_peak = torch.cuda.max_memory_allocated()
  plain, _ = configs.build_graphcast(spec, statics=statics, device=dev,
                                     remat_group=4, use_kernels=False)
  plain.load_state_dict(model.state_dict())
  plain_stack = wrappers.build_stack(plain, sources.load_stats(stats),
                                     bf16=True).to(dev)
  with torch.no_grad():
    out_p = plain_stack.predict(inputs, forcings[0], graphed=False)
  rel = float((outs['eager'] - out_p).abs().max() / out_p.abs().max())
  if not rel <= DENOISER_BF16_RTOL:
    raise AssertionError(f'0.25deg GraphCast step: kernels vs plain rel err '
                         f'{rel} > {DENOISER_BF16_RTOL}')
  del plain, plain_stack, out_p
  log(f'[graphcast 0.25deg serve] graphcast_37 '
      f'({model.input_layout.num_channels} input, '
      f'{model.target_layout.num_channels} target channels; '
      f'{sum(p.numel() for p in model.parameters())} parameters, bf16): '
      f'statics and model in {built_s:.1f} s (multimesh {mm.num_edges} '
      f'edges, grid2mesh {statics.grid2mesh.num_edges}, mesh2grid '
      f'{statics.mesh2grid.num_edges}); one step {tuple(outs["eager"].shape)}'
      f' finite: graphed {seconds["graphed"]:.3f} s (with the capture), '
      f'{seconds["graphed, replay"]:.3f} s replayed, eager '
      f'{seconds["eager"]:.3f} s, bitwise equal; against the plain path '
      f'rel err {rel:.3e} (<= {DENOISER_BF16_RTOL}); B {per_call} launches '
      f'per step, as derived; peak memory {serve_peak / 2**30:.2f} GiB; '
      f'{card}')
  del model, stack, outs, inputs, forcings
  torch.cuda.empty_cache()
  run, launches = graphcast_cli(
      ['--model', 'graphcast', '--preset', '0.25deg', '--task',
       'graphcast_37', '--remat_group', '4', '--data', 'synthetic',
       '--stats_path', stats], 2, '0.25deg graphcast_37', card)
  log(f'[graphcast 0.25deg] phase {time.perf_counter() - t_phase:.1f} s; '
      f'{card}')
  return (launches, run.step_seconds, seconds, serve_peak, run.peak,
          b_results)


def attention_backends(nano_statics, statics, dev, g, card, work) -> dict:
  """Phase 35: the reference's einsum backends (plain PyTorch) against the
  kernels' backends on the same bridged weights, bf16, one denoiser call
  each within DENOISER_BF16_RTOL: nano's 'triblock' against
  'triblock_pallas' (kernel C, 16 launches), and at 1 degree 'dense'
  against 'pallas' (kernel A, 16 launches), after checking on the host
  that the dense k-hop mask and the tile plan's allowed entries are one
  set; the peak memory of the dense call. Then `--preset tiny` (the
  reference's TINY, einsum 'triblock') trains 2 steps with a checkpoint
  and evaluates 2 members x 2 steps through the CLIs on the card: B and E
  launches per step as derived, no attention kernel. Returns each
  kernel's launches in those CLI runs."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.models.gencast import GenCast
  from gencast_tpu_torch.ops import banded_attention, sparse_attention
  from gencast_tpu_torch.training import evaluate, train
  t_phase = time.perf_counter()
  plan = statics.attention_tile_plan
  n = statics.num_mesh_nodes
  dense_mask = configs.dense_attention_mask(statics,
                                            configs.ONE_DEG.attention_k_hop)
  from_plan = dense_from_plan(plan, 'cpu').numpy()
  if not (np.array_equal(dense_mask, from_plan[:n, :n])
          and not from_plan[n:].any() and not from_plan[:, n:].any()):
    raise AssertionError('the dense k-hop mask and the tile plan\'s allowed '
                         'entries are not the same set')
  log(f'[backends] 1-degree dense k-hop mask {dense_mask.shape}: '
      f'{int(dense_mask.sum())} allowed entries, the tile plan\'s set '
      f'exactly ({plan.num_pairs} mask tiles of {plan.tile} x {plan.tile})')
  for spec, einsum, st, kernel in (
      (configs.NANO, 'triblock', nano_statics, banded_attention.KERNEL),
      (configs.ONE_DEG, 'dense', statics, sparse_attention.KERNEL)):
    stats = unit_stats(spec.task)
    stacks = {}
    flat = None
    for kind in (spec.attention_type, einsum):
      model, _ = configs.build_gencast(
          dataclasses.replace(spec, attention_type=kind), seed=0, statics=st,
          device=dev)
      if flat is None:
        flat = bridge.perturbed(bridge.export_reference_params(model), seed=1)
      bridge.load_reference_params(model, flat)
      stacks[kind] = wrappers.build_stack(model, stats,
                                          bf16=spec.cast_bf16).to(dev)
    den = model.denoiser
    grid = (1, st.grid_lat.shape[0], st.grid_lon.shape[0])
    inputs, forcings, noisy = (
        torch.randn(grid + (lay.num_channels,), generator=g, device=dev)
        for lay in (den.input_layout, den.forcing_layout, den.target_layout))
    sigma = torch.full((1,), 3.0, device=dev)
    outs, launched, peaks = {}, {}, {}
    with torch.no_grad():
      for kind, stack in stacks.items():
        for c in counters():
          c.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        outs[kind] = stack(inputs, 3.0 * noisy, sigma, forcings)
        torch.cuda.synchronize()
        peaks[kind] = torch.cuda.max_memory_allocated()
        launched[kind] = {c.name: c.launches for c in counters()
                          if c.launches}
      ms = time_in_turns({kind: (lambda s=stack: s(inputs, 3.0 * noisy,
                                                   sigma, forcings))
                          for kind, stack in stacks.items()}, reps=2)
    got, want = outs[einsum], outs[spec.attention_type]
    rel = float((got - want).abs().max() / want.abs().max())
    if not (torch.isfinite(got).all() and rel <= DENOISER_BF16_RTOL
            and launched[spec.attention_type].get(kernel.name)
            == spec.num_layers and kernel.name not in launched[einsum]):
      raise AssertionError(f'{spec.name} {einsum} against '
                           f'{spec.attention_type}: rel {rel}, launches '
                           f'{launched}')
    log(f'[backends] {spec.name} bf16 denoiser call, {einsum} (einsum) '
        f'against {spec.attention_type} ({kernel.name}): max rel err '
        f'{rel:.3e} (tol {DENOISER_BF16_RTOL}); {ms[einsum]:.2f} ms against '
        f'{ms[spec.attention_type]:.2f} ms per call; peak memory '
        f'{peaks[einsum] / 2**30:.2f} GiB against '
        f'{peaks[spec.attention_type] / 2**30:.2f} GiB; launches {launched}; '
        f'{card}')
    del stacks, model, outs, got, want
    torch.cuda.empty_cache()

  ckpt = os.path.join(work, 'tiny_ckpt')
  for c in counters():
    c.reset()
  run = train.main(['--preset', 'tiny', '--data', 'synthetic', '--steps', '2',
                    '--log_every', '1', '--ckpt_dir', ckpt])
  launches = {c.name: c.launches for c in counters()}
  gencast = next(m for m in run.model.modules() if isinstance(m, GenCast))
  attn = type(gencast.denoiser.architecture.processor.blocks[0].attn).__name__
  want = {k: 2 * v for k, v in expected_step_launches(gencast).items()}
  if (attn != 'TriblockAttention' or launches != want
      or not np.isfinite(run.losses).all()):
    raise AssertionError(f'--preset tiny on the card: {attn}, launches '
                         f'{launches} (expected {want}), losses {run.losses}')
  ev = evaluate.main(['--preset', 'tiny', '--ckpt_dir', ckpt, '--num_members',
                      '2', '--max_rollout_steps', '2', '--out_dir',
                      os.path.join(work, 'tiny_eval'), '--plot_vars'])
  if not (ev.predictions.shape[:2] == (2, 2)
          and np.isfinite(ev.predictions).all()):
    raise AssertionError(f'--preset tiny evaluate: {ev.predictions.shape}')
  log(f'[backends] --preset tiny (the reference\'s TINY, einsum triblock) on '
      f'the card: 2 steps, losses {run.losses}, launches {launches} as '
      f'derived; evaluate 2 members x 2 steps finite; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return launches


RANK_LINE = re.compile(r'\[(?:train|forecast)\] (pipeline|kernel launches in '
                       r'this process) \(rank (\d+) of (\d+)\) (\{.*\})')


def run_ranks(module, argv, tag, timeout=600, env=None):
  """`python3 -m module argv` in a fresh process from the repository root
  (it may start ranks of its own), with `env` added to the environment:
  its wall seconds, stdout, and by rank its 'pipeline' and 'kernel
  launches' lines. Raises if it fails."""
  return finish_ranks(start_ranks(module, argv, env), tag, timeout)


def start_ranks(module, argv, env=None):
  """run_ranks' command started, not waited for: finish_ranks takes it."""
  repo = os.path.dirname(os.path.abspath(__file__))
  t0 = time.perf_counter()
  proc = subprocess.Popen(
      [sys.executable, '-m', module] + argv, cwd=repo, text=True,
      stdout=subprocess.PIPE, stderr=subprocess.PIPE, start_new_session=True,
      env=dict(os.environ, **(env or {})))
  STARTED.append(proc)
  return t0, proc


def stop_ranks(started) -> None:
  """Kills a command start_ranks started, with the ranks it started."""
  _, proc = started
  if proc.poll() is None:
    os.killpg(proc.pid, signal.SIGKILL)
  proc.communicate()


def finish_ranks(started, tag, timeout=600):
  """run_ranks' result of a command start_ranks started (killed, and an
  error, past `timeout` seconds from its start)."""
  t0, proc = started
  try:
    stdout, stderr = proc.communicate(
        timeout=max(1.0, timeout - (time.perf_counter() - t0)))
  except BaseException:
    stop_ranks(started)
    raise
  wall = time.perf_counter() - t0
  if proc.returncode:
    raise AssertionError(f'{tag}: exit {proc.returncode}\n'
                         f'{stdout[-3000:]}\n{stderr[-5000:]}')
  ranks = {}
  for m in RANK_LINE.finditer(stdout):
    ranks.setdefault(int(m.group(2)), {})[m.group(1)] = json.loads(
        m.group(4))
  return {'wall': wall, 'stdout': stdout, 'ranks': ranks}


def checkpoint_params(directory, steps_run):
  return list(torch.load(os.path.join(directory, f'step_{steps_run - 1}.pt'),
                         map_location='cpu',
                         weights_only=True)['params'].values())


def allreduce_ms(path) -> float:
  """The host milliseconds of the all-reduces in a torch.profiler Chrome
  trace: the largest total over the event names that hold 'allreduce'
  (the outermost span encloses the others)."""
  with open(path) as f:
    events = json.load(f)['traceEvents']
  totals = {}
  for e in events:
    name = e.get('name', '')
    if e.get('ph') == 'X' and re.search(r'(?i)all_?reduce', name):
      totals[name] = totals.get(name, 0.0) + e.get('dur', 0) / 1e3
  return max(totals.values(), default=0.0)


def data_parallel_1deg(spec, statics, dev, card, work, stats) -> dict:
  """Phase 36: full-width, full-depth 1-degree training, batch 2, on the
  synthetic source (statistics from the file `stats`), through the
  training CLI: `python3 -m gencast_tpu_torch.training.train --preset 1deg
  --batch_size 2 --dp 2` (two ranks on cuda:0, gloo, one row each) for 16
  steps with --profile_dir, against one process at batch 2 (`train.main`
  here): the first DP_STEPS losses within DP_LOSS_RTOL (bf16, the
  preset's); `--multihost --num_processes 1` (one NCCL rank, here) bitwise
  the one process; the float32 pair at CUT_LAYERS layers (--no-bf16)
  for DP_STEPS steps: losses within
  TRAIN_LOSS_RTOL and each parameter's change within TRAIN_STEP_RTOL of
  the one process's (in bf16 a rank's
  weight gradient is rounded before the average, and Adam turns the
  rounding of a near-zero entry into a full-size update: that figure is
  logged, not held). The float32 --dp 2 run, started from here as a CLI
  process, goes beside the one-process runs (it only checks; the traced
  bf16 --dp 2 run goes alone). Launches of A, F, B and E per step as
  expected_step_launches in every run, per rank at batch 1; each rank's
  trace of steps 10-15 (its only profiler session) holds them too, and
  gives the all-reduce's share of a step. Returns each kernel's launches
  over the --dp 2 run's ranks."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.models.gencast import GenCast
  from gencast_tpu_torch.parallel import meshes
  from gencast_tpu_torch.training import train
  t_phase = time.perf_counter()
  long_steps = train.PROFILE_STEPS[1] + 1
  base = ['--preset', '1deg', '--clean_sst_nans', '--data', 'synthetic',
          '--batch_size', '2', '--log_every', '1', '--stats_path', stats]
  nccl = ['--multihost', '--num_processes', '1', '--process_id', '0',
          '--coordinator', f'localhost:{meshes.free_port()}']
  f32 = ['--no-bf16', '--num_layers', str(CUT_LAYERS), '--steps',
         str(DP_STEPS)]
  runs = {}
  # The float32 --dp 2 run only checks (its times are not metrics): it runs
  # beside this process's runs; the bf16 --dp 2 run, traced, runs alone.
  f32_metrics = os.path.join(work, 'dp_f32.jsonl')
  f32_started = start_ranks('gencast_tpu_torch.training.train', base + f32 + [
      '--dp', '2', '--ckpt_dir', os.path.join(work, 'dp_f32'),
      '--metrics_jsonl', f32_metrics])
  try:
    for name, argv, steps_run in (
        ('one', ['--steps', str(long_steps)], long_steps),
        ('nccl', ['--steps', str(long_steps)] + nccl, long_steps),
        ('one_f32', f32, DP_STEPS)):
      torch.cuda.empty_cache()
      for c in counters():
        c.reset()
      t0 = time.perf_counter()
      run = train.main(base + argv + ['--ckpt_dir',
                                      os.path.join(work, name)])
      launches = {c.name: c.launches for c in counters()}
      per_run = expected_step_launches(next(
          m for m in run.model.modules() if isinstance(m, GenCast)))
      if launches != {k: v * steps_run for k, v in per_run.items()}:
        raise AssertionError(f'1deg {name}: launches {launches}, '
                             f'{per_run} per step expected')
      if name == 'one':
        per_step = per_run
      runs[name] = {'run': run, 'wall': time.perf_counter() - t0,
                    'params': checkpoint_params(os.path.join(work, name),
                                                steps_run)}
      run.model = None
  except BaseException:
    stop_ranks(f32_started)
    raise
  dp_f32 = finish_ranks(f32_started, '1deg --dp 2 float32')
  with open(f32_metrics) as f:
    runs['dp_f32'] = {
        'losses': [r['loss'] for r in map(json.loads, f)
                   if r['event'] == 'train'],
        'wall': dp_f32['wall'],
        'step_s': dp_f32['ranks'][0]['pipeline']['step_s'],
        'params': checkpoint_params(os.path.join(work, 'dp_f32'), DP_STEPS)}
  torch.cuda.empty_cache()
  trace_dir = os.path.join(work, 'trace')
  metrics = os.path.join(work, 'dp.jsonl')
  dp = run_ranks('gencast_tpu_torch.training.train', base + [
      '--steps', str(long_steps), '--dp', '2', '--profile_dir', trace_dir,
      '--metrics_jsonl', metrics], '1deg --dp 2')
  with open(metrics) as f:
    dp['losses'] = [r['loss'] for r in map(json.loads, f)
                    if r['event'] == 'train']
  first, last_step = train.PROFILE_STEPS
  profiled = last_step - first + 1
  got = {r: v.get('kernel launches in this process')
         for r, v in dp['ranks'].items()}
  backends = re.findall(r'backend (\w+)', dp['stdout'])
  want = {k: v * long_steps for k, v in per_step.items()}
  if (sorted(got) != [0, 1] or any(v != want for v in got.values())
      or backends != ['gloo', 'gloo']):
    raise AssertionError(f'1deg --dp 2: backends {backends}, launches by '
                         f'rank {got}, expected {want} each')
  shares = {}
  for rank, lines in sorted(dp['ranks'].items()):
    path = os.path.join(trace_dir, f'train_steps_{first}-{last_step}.rank'
                                   f'{rank}.pt.trace.json')
    in_trace = trace_kernel_counts(path)
    if in_trace != {k: v * profiled for k, v in per_step.items()}:
      raise AssertionError(f'1deg --dp 2 rank {rank} trace of steps '
                           f'{first}-{last_step}: {in_trace}, {per_step} per '
                           f'step expected')
    shares[rank] = (allreduce_ms(path) / profiled,
                    1e3 * lines['pipeline']['step_s']['mean'])

  initial, _ = configs.build_gencast(cut_depth(spec), seed=0,
                                     statics=statics, device=dev)
  start = [p.detach().cpu() for p in initial.parameters()]
  del initial

  def change_rel(a_params, b_params):
    return max(float(((b - p0) - (a - p0)).abs().max()
                     / (a - p0).abs().max())
               for a, b, p0 in zip(a_params, b_params, start)
               if (a - p0).abs().max() > 0)

  def loss_rel(a, b):
    if len(a) != len(b):
      return float('inf')
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))

  one = runs['one']['run'].losses
  bf16 = loss_rel(one[:DP_STEPS], dp['losses'][:DP_STEPS])
  bf16_all = loss_rel(one, dp['losses'])
  f32 = (loss_rel(runs['one_f32']['run'].losses, runs['dp_f32']['losses']),
         change_rel(runs['one_f32']['params'], runs['dp_f32']['params']))
  nccl_equal = (runs['nccl']['run'].losses == one and all(
      torch.equal(a, b) for a, b in zip(runs['one']['params'],
                                        runs['nccl']['params'])))
  if not (bf16 <= DP_LOSS_RTOL and f32[0] <= TRAIN_LOSS_RTOL
          and f32[1] <= TRAIN_STEP_RTOL and nccl_equal):
    raise AssertionError(
        f'1deg data parallel: --dp 2 against one process: bf16 losses of the '
        f'first {DP_STEPS} steps rel {bf16} (tol {DP_LOSS_RTOL}); float32 '
        f'losses rel {f32[0]} (tol {TRAIN_LOSS_RTOL}), worst parameter change '
        f'rel {f32[1]} (tol {TRAIN_STEP_RTOL}); one NCCL rank bitwise '
        f'{nccl_equal}')

  def steps_of(seconds):
    rest = seconds[1:]
    return (f'first {seconds[0]:.4f}, mean {np.mean(rest):.4f}, max '
            f'{max(rest):.4f}')

  dp_steps = {r: {k: round(v, 4) for k, v in lines['pipeline']['step_s']
                  .items()} for r, lines in sorted(dp['ranks'].items())}
  f32_steps = {k: round(v, 4) for k, v in runs['dp_f32']['step_s'].items()}
  log(f'[data parallel 1deg] batch 2, bf16, {long_steps} steps: one process '
      f'step s {steps_of(runs["one"]["run"].step_seconds)} (wall '
      f'{runs["one"]["wall"]:.1f} s); --dp 2 (two ranks on cuda:0, gloo, '
      f'profiled steps {first}-{last_step}) step s by rank {dp_steps} (wall '
      f'{dp["wall"]:.1f} s with start-up); one NCCL rank step s '
      f'{steps_of(runs["nccl"]["run"].step_seconds)} (wall '
      f'{runs["nccl"]["wall"]:.1f} s); the one-process runs beside the '
      f'float32 --dp 2 run; float32 at {CUT_LAYERS} layers, '
      f'{DP_STEPS} steps: one process '
      f'step s {steps_of(runs["one_f32"]["run"].step_seconds)}, --dp 2 '
      f'{f32_steps} (rank 0; wall {runs["dp_f32"]["wall"]:.1f} s with '
      f'start-up); {card}')
  log(f'[data parallel 1deg] --dp 2 against one process: bf16 losses of the '
      f'first {DP_STEPS} steps max rel {bf16:.3e} (tol {DP_LOSS_RTOL}; all '
      f'{long_steps}: {bf16_all:.3e}); float32 losses max rel {f32[0]:.3e} '
      f'(tol {TRAIN_LOSS_RTOL}), worst parameter change rel {f32[1]:.3e} (tol '
      f'{TRAIN_STEP_RTOL}); one NCCL rank bitwise the one process; launches '
      f'per rank-step {per_step}, as derived, in every run and in each '
      f'rank\'s trace of steps {first}-{last_step}; all-reduce ms per step '
      f'and mean step ms by rank '
      f'{ {r: (round(a, 2), round(b, 2)) for r, (a, b) in shares.items()} }'
      f', share {[round(a / b, 3) for a, b in shares.values()]}; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return {k: sum(v[k] for v in got.values()) for k in per_step}


def pod_ensemble_1deg(dev, card, work) -> dict:
  """Phase 37: `python3 -m gencast_tpu_torch.scripts.ensemble_forecast_pod
  --preset 1deg --members 2 --steps 2 --score` on two ranks on cuda:0
  (gloo; one member each): its members bitwise the one-device
  `parallel.ensemble.ensemble_rollout` of the same model and seed (here),
  its on-device scores within POD_SCORE_RTOL of ops.metrics on those
  members, A and B launches per rank as derived; seconds per member-step
  both ways. Returns each kernel's launches over the ranks."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import ln_film, metrics, segment, \
      sparse_attention
  from gencast_tpu_torch.parallel import ensemble
  from gencast_tpu_torch.scripts import ensemble_forecast_pod as pod
  t_phase = time.perf_counter()
  members, steps = 2, 2
  out = os.path.join(work, 'forecast.npz')
  argv = ['--preset', '1deg', '--members', str(members), '--steps',
          str(steps), '--score', '--clean_sst_nans', '--out', out]
  run = run_ranks('gencast_tpu_torch.scripts.ensemble_forecast_pod',
                  argv + ['--num_processes', '2'], 'pod forecast, 2 ranks')
  args = pod.parse_args(argv)
  wrapped, statics, (inputs, forcings, targets) = pod.build_forecast(args,
                                                                      dev)
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  # One member per call here too, as each rank runs its member: the bits
  # of a batch-1 sampler call.
  want = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                   num_members=members, member_chunk=1)
  here_s = (time.perf_counter() - t0) / (members * steps)
  got = np.zeros(want.shape, np.float32)
  for rank in range(2):
    z = np.load(f'{os.path.splitext(out)[0]}.p{rank}.npz')
    got[z['members']] = z['predictions']
  bitwise = np.array_equal(got.view(np.uint32), want.numpy().view(np.uint32))
  lat_w = torch.as_tensor(layout_lib.latitude_weights(
      np.asarray(statics.grid_lat)), device=dev)
  mem = want.to(dev)
  layout = wrappers.find_layout_provider(wrapped).target_layout
  reference = {
      'crps': metrics.crps_ensemble(mem, targets, lat_w),
      'rmse': metrics.ensemble_mean_rmse(mem, targets, lat_w),
      'spread': metrics.ensemble_spread(mem, lat_w)}
  with open(f'{os.path.splitext(out)[0]}.scores.json') as f:
    scores = json.load(f)['scores']
  worst = 0.0
  for name, arr in reference.items():
    for var, v in metrics.per_variable(arr, layout).items():
      w, s = np.asarray(v)[:, 0], np.asarray(scores[name][var])
      if not np.array_equal(np.isnan(w), np.isnan(s)):
        raise AssertionError(f'pod {name} {var}: {s} against {w}')
      ok = ~np.isnan(w)
      if ok.any():
        worst = max(worst, float(np.abs(s[ok] - w[ok]).max()
                                 / np.abs(w[ok]).max()))
  spec = configs.ONE_DEG
  calls = steps * (2 * spec.num_noise_levels - 1)
  per_rank = {sparse_attention.KERNEL.name: calls * spec.num_layers,
              segment.KERNEL.name: calls,
              ln_film.KERNEL_FWD.name: calls * ln_film_fwd_launches(wrapped)}
  launched = {r: {k: v for k, v in lines['kernel launches in this process']
                  .items() if v} for r, lines in run['ranks'].items()}
  if not (bitwise and worst <= POD_SCORE_RTOL and sorted(launched) == [0, 1]
          and all(v == per_rank for v in launched.values())):
    raise AssertionError(f'pod forecast: members bitwise {bitwise}, scores '
                         f'worst rel {worst} (tol {POD_SCORE_RTOL}), launches '
                         f'{launched} (expected {per_rank} each)')
  member_step = [float(x) for x in re.findall(
      r'\(([0-9.]+) s per kept member-step', run['stdout'])]
  log(f'[pod 1deg] 2 ranks on cuda:0, {members} members x {steps} steps, '
      f'--score: members bitwise the one-device ensemble_rollout; scores on '
      f'the devices against ops.metrics: worst rel {worst:.3e} (tol '
      f'{POD_SCORE_RTOL}); launches per rank {per_rank}, as derived; seconds '
      f'per member-step by rank {member_step} (first calls and capture '
      f'included), one device here {here_s:.3f}; wall {run["wall"]:.1f} s; '
      f'phase {time.perf_counter() - t_phase:.1f} s; {card}')
  return {k: sum(v[k] for v in launched.values()) for k in per_rank}


# The reference's (published) names of the port's node and edge sets: the
# inverse of training/translate.py's maps.
PUBLISHED_NODES = {'grid': 'grid_nodes', 'mesh': 'mesh_nodes'}
PUBLISHED_EDGES = {'g2m': 'grid2mesh', 'm2g': 'mesh2grid', 'mesh': 'mesh'}
# Phase 38's seeds: the source model, its perturbation, the mesh embedder's
# dummy rows, the translation tool's fresh model and the model restored
# here.
PUBLISHED_SEEDS = dict(source=21, perturb=22, dummy=23, tool=24, target=25)


def _haiku_linear(linear: dict) -> dict:
  return {{'kernel': 'w', 'bias': 'b'}[k]: v for k, v in linear.items()}


def _published_mlp(layers: dict) -> dict:
  """An MLP's dense layers {0, 1, ...} as the reference's Sequential, whose
  activations take the odd slots: {0, 2, ...}."""
  return {'network': {'network': {'layers': {
      str(2 * int(i)): _haiku_linear(lin) for i, lin in layers.items()}}}}


def _published_cond_mlp(mlp: dict, extra_rows=None) -> dict:
  out = _published_mlp(mlp['network']['layers'])
  if extra_rows is not None:
    first = out['network']['network']['layers']['0']
    first['w'] = np.concatenate([first['w'], extra_rows])
  out['norm_conditioning_layer'] = {
      'conditional_linear_layer': _haiku_linear(mlp['film']['linear'])}
  return out


def _published_gnn(net: dict, mesh_extra_rows) -> dict:
  """A TypedGraphNet's state as the reference's DeepTypedGraphNet."""
  out = {'processor_networks': {
      i: {'graph_network': {
          'update_edge_fns': {PUBLISHED_EDGES[e]: {
              'edge_fn': _published_cond_mlp(m)}
              for e, m in p['edge_mlps'].items()},
          'update_node_fns': {PUBLISHED_NODES[n]: {
              'node_fn': _published_cond_mlp(m)}
              for n, m in p['node_mlps'].items()}}}
      for i, p in net['processors'].items()}}
  embedder = {}
  if 'node_embedders' in net:
    embedder['embed_node_fns'] = {
        PUBLISHED_NODES[n]: _published_cond_mlp(
            m, mesh_extra_rows if n == 'mesh' else None)
        for n, m in net['node_embedders'].items()}
  if 'edge_embedders' in net:
    embedder['embed_edge_fns'] = {
        PUBLISHED_EDGES[e]: _published_cond_mlp(m)
        for e, m in net['edge_embedders'].items()}
  if embedder:
    out['embedder_network'] = embedder
  if 'node_decoders' in net:
    out['decoder_network'] = {'embed_node_fns': {
        PUBLISHED_NODES[n]: _published_mlp(m['layers'])
        for n, m in net['node_decoders'].items()}}
  return out


def _published_transformer(processor: dict) -> dict:
  """The mesh transformer's state ([L]-stacked blocks) as the reference's
  per-block modules."""
  blocks = processor['blocks']
  proj = blocks['attn']['proj']

  def linear(tree, i):
    return _haiku_linear({k: v[i] for k, v in tree.items()})

  def block(i):
    return {
        'attn_module': {
            'q_proj': {'linear': linear(proj['q'], i)},
            'k_proj': {'linear': linear(proj['k'], i)},
            'v_proj': {'linear': linear(proj['v'], i)},
            'final_linear': linear(proj['out'], i)},
        'ffw_module': {'mlp': {'layers': {
            '0': linear(blocks['ffw']['lin1'], i),
            '2': linear(blocks['ffw']['lin2'], i)}}},
        'norm_cond_attn': {
            'conditional_linear_layer': linear(blocks['film1']['linear'], i)},
        'norm_cond_ffw': {
            'conditional_linear_layer': linear(blocks['film2']['linear'], i)}}

  return {'blocks': {str(i): block(i)
                     for i in range(proj['q']['kernel'].shape[0])},
          'final_norm_cond': {'conditional_linear_layer': _haiku_linear(
              processor['final_film']['linear'])}}


def _module_paths(tree: dict, prefix: str = ''):
  """(module path 'a/b/c', its leaves) of every module of a nested tree."""
  leaves = {k: v for k, v in tree.items() if not isinstance(v, dict)}
  if leaves:
    yield prefix, leaves
  for k, v in tree.items():
    if isinstance(v, dict):
      yield from _module_paths(v, f'{prefix}/{k}' if prefix else k)


def published_checkpoint(flat, configs: dict, dialect: str = 'flat',
                         seed: int = 0) -> dict:
  """A DeepMind `CheckPoint` tree (`deepmind_checkpoint.save` writes it) of
  the GenCast denoiser whose parameters `flat` holds in the reference's
  flat layout ('denoiser/architecture/...' keys: the port's
  `bridge.export_reference_params`, or the JAX package's state flattened
  with '/'), in the published layout: the reference's module names,
  Haiku's leaf names (w, b), the mesh-node embedder's dummy input rows (one
  per grid data channel, seeded normal values: the reference feeds that
  embedder zeros there) and `configs` ({config name: dict}). The params are
  nested under 'denoiser' (`dialect` 'nested') or keyed by Haiku's flat
  module paths ('flat': 'denoiser/~/a/b/c': {w, b}). Harness code: what
  phase 38 and the CPU tests translate."""
  from gencast_tpu_torch.tools import translate_checkpoint
  den = translate_checkpoint.nest(
      {k: np.asarray(v) for k, v in flat.items()})['denoiser']
  arch = den['architecture']
  embedders = arch['grid2mesh']['node_embedders']
  grid_rows = embedders['grid']['network']['layers']['0']['kernel'].shape[0]
  mesh_first = embedders['mesh']['network']['layers']['0']['kernel']
  extra = np.random.default_rng(seed).standard_normal(
      (grid_rows - mesh_first.shape[0], mesh_first.shape[1])
  ).astype(mesh_first.dtype)
  published = {
      'noise_level_encoder': {
          f'linear_{i}': _haiku_linear(lin)
          for i, lin in den['noise_encoder']['linears'].items()},
      'predictor': {
          'grid2mesh_gnn': _published_gnn(arch['grid2mesh'], extra),
          'mesh_gnn': {'batch_first_transformer': _published_transformer(
              arch['processor'])},
          'mesh2grid_gnn': _published_gnn(arch['mesh2grid'], None)}}
  if dialect == 'nested':
    params = {'denoiser': published}
  elif dialect == 'flat':
    params = {f'denoiser/~/{path}': leaves
              for path, leaves in _module_paths(published)}
  else:
    raise ValueError(f'unknown dialect {dialect!r}: nested or flat')
  return {'description': 'GenCast denoiser, seeded weights, in the '
                         'published layout',
          'license': 'CC-BY-NC-SA-4.0', 'params': params, **configs}


def graphed_denoiser_call(stack, inputs, forcings, noisy, sigma):
  """One denoiser call of the bf16 serving copy in `stack`, replayed from a
  CUDA graph (`cuda_lib.GraphedCall`, as `GenCast.sample` replays its
  calls): the first call warms up and captures, the second replays. Returns
  the replay's output (float32) and the (A, B) launches of the replay."""
  from gencast_tpu_torch.models import casting
  from gencast_tpu_torch.ops import cuda_lib, segment, sparse_attention
  serving = next(m for m in stack.modules()
                 if isinstance(m, casting.Bfloat16Cast))._bf16
  call = cuda_lib.GraphedCall(
      [t.to(torch.bfloat16) for t in (inputs, forcings, noisy)] + [sigma])
  with torch.no_grad():
    call(serving._precond_denoise)  # the warm-up, then the capture
    for counter in (sparse_attention.KERNEL, segment.KERNEL):
      counter.reset()
    out = call(serving._precond_denoise).float()
    torch.cuda.synchronize()
  return out, (sparse_attention.KERNEL.launches, segment.KERNEL.launches)


def published_1deg(spec, statics, dev, card, work, stats) -> dict:
  """Phase 38: a published GenCast checkpoint at 1 degree, full width and
  depth. A seeded, perturbed ONE_DEG model written as a DeepMind CheckPoint
  npz in the published layout (Haiku's flat dialect,
  `published_checkpoint`); `python3 -m
  gencast_tpu_torch.tools.translate_checkpoint --preset 1deg` on it in a
  fresh process; its step_0.pt restored into a model of another seed: every
  parameter bitwise the source's, one graphed denoiser call and one sampled
  12-hour step from one generator bitwise the source's, A and B launches
  per call and step as derived; then `python3 -m
  gencast_tpu_torch.training.evaluate --preset 1deg --ckpt_dir` in a fresh
  process, 1 member x 1 step, restores step 0 and writes finite scores
  (statistics: phase 10's file `stats`). Returns the launches of the
  translated model's call and step."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import segment, sparse_attention
  from gencast_tpu_torch.tools import translate_checkpoint as tool
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import deepmind_checkpoint as dm_ckpt
  t_phase = t0 = time.perf_counter()
  seconds = {}
  source, _ = configs.build_gencast(spec, seed=PUBLISHED_SEEDS['source'],
                                    statics=statics, device=dev)
  bridge.load_reference_params(source, bridge.perturbed(
      bridge.export_reference_params(source), PUBLISHED_SEEDS['perturb']))
  tree = published_checkpoint(bridge.export_reference_params(source),
                              tool.preset_configs(source, spec), 'flat',
                              PUBLISHED_SEEDS['dummy'])
  npz = os.path.join(work, 'gencast_1deg_published.npz')
  dm_ckpt.save(npz, tree)
  seconds['write npz'] = time.perf_counter() - t0
  size = os.path.getsize(npz)
  ckpt_dir = os.path.join(work, 'translated')
  flags = ['--preset', '1deg', '--clean_sst_nans']
  run = run_ranks('gencast_tpu_torch.tools.translate_checkpoint',
                  ['--ref', npz, '--out', ckpt_dir, '--seed',
                   str(PUBLISHED_SEEDS['tool'])] + flags,
                  'translate_checkpoint')
  seconds['translate (fresh process)'] = run['wall']
  translated_line = re.search(r'\[translate\] (\d+) of (\d+) parameter '
                              r'arrays translated', run['stdout'])

  t0 = time.perf_counter()
  unit = unit_stats(spec.task)
  src_stack = wrappers.build_stack(source, unit, bf16=spec.cast_bf16,
                                   clean_sst_nans=True).to(dev)
  target, _ = configs.build_gencast(spec, seed=PUBLISHED_SEEDS['target'],
                                    statics=statics, device=dev)
  stack = wrappers.build_stack(target, unit, bf16=spec.cast_bf16,
                               clean_sst_nans=True).to(dev)
  step = ckpt_lib.restore(ckpt_lib.create_manager(ckpt_dir), stack)
  pairs = list(zip(src_stack.named_parameters(), stack.named_parameters()))
  differing = [a[0] for a, b in pairs if not torch.equal(a[1], b[1])]
  if step != 0 or differing or not translated_line:
    raise AssertionError(f'translated checkpoint: step {step}, parameters '
                         f'differing from the source {differing[:5]} of '
                         f'{len(pairs)}\n{run["stdout"][-2000:]}')
  seconds['restore'] = time.perf_counter() - t0

  t0 = time.perf_counter()
  g = torch.Generator(device=dev).manual_seed(PUBLISHED_SEEDS['target'])
  den = target.denoiser
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs, forcings, noisy = (
      torch.randn(grid + (lay.num_channels,), generator=g, device=dev)
      for lay in (den.input_layout, den.forcing_layout, den.target_layout))
  sigma = torch.full((1,), 3.0, device=dev)
  calls = 2 * spec.num_noise_levels - 1
  per_call = (spec.num_layers, 1)
  launches = {sparse_attention.KERNEL.name: 0, segment.KERNEL.name: 0}
  outs, forecasts = {}, {}
  for name, s in (('source', src_stack), ('translated', stack)):
    outs[name], launched = graphed_denoiser_call(s, inputs, forcings,
                                                 noisy * 3.0, sigma)
    for counter in (sparse_attention.KERNEL, segment.KERNEL):
      counter.reset()
    forecasts[name] = s.sample(inputs, forcings, torch.Generator(
        device=dev).manual_seed(PUBLISHED_SEEDS['tool']))
    torch.cuda.synchronize()
    step_launched = (sparse_attention.KERNEL.launches,
                     segment.KERNEL.launches)
    if (launched != per_call
        or step_launched != tuple(calls * n for n in per_call)):
      raise AssertionError(f'{name}: launches (A, B) per graphed call '
                           f'{launched}, per forecast step {step_launched}; '
                           f'expected {per_call} and {calls} times that')
    if name == 'translated':
      launches = {sparse_attention.KERNEL.name: launched[0] + step_launched[0],
                  segment.KERNEL.name: launched[1] + step_launched[1]}
  for what, got in (('graphed denoiser call', outs),
                    ('forecast step', forecasts)):
    if not (torch.equal(got['source'], got['translated'])
            and torch.isfinite(got['translated']).all()):
      raise AssertionError(f'translated {what} differs from the source '
                           'model\'s or is not finite')
  seconds['call and forecast step, both models'] = time.perf_counter() - t0
  del src_stack, source, outs, forecasts

  out_dir = os.path.join(work, 'eval')
  ev = run_ranks('gencast_tpu_torch.training.evaluate',
                 flags + ['--ckpt_dir', ckpt_dir, '--stats_path', stats,
                          '--num_members', '1', '--max_rollout_steps', '1',
                          '--plot_vars', '--out_dir', out_dir],
                 'evaluate from the translated checkpoint')
  seconds['evaluate (fresh process)'] = ev['wall']
  with open(os.path.join(out_dir, 'metrics.json')) as f:
    rmse = json.load(f)['rmse']
  dummy_rows = sum(lay.num_channels for lay in (
      den.input_layout, den.forcing_layout, den.target_layout))
  if ('restored checkpoint step 0' not in ev['stdout']
      or not all(np.isfinite(v) for v in rmse.values())):
    raise AssertionError(f'evaluate from the translated checkpoint: rmse '
                         f'{rmse}\n{ev["stdout"][-2000:]}')
  log(f'[published 1deg] a seeded ONE_DEG model ({len(pairs)} parameter '
      f'arrays, {sum(p.numel() for p in target.parameters())} values) as a '
      f'DeepMind CheckPoint npz of {size / 2**20:.1f} MiB (Haiku flat module '
      f'paths, w/b, {dummy_rows} dummy rows): translate_checkpoint '
      f'({translated_line.group(1)} of {translated_line.group(2)} arrays '
      f'translated) restored into a model of another seed bitwise the '
      f'source; a graphed denoiser call and a 12-hour step bitwise the '
      f'source\'s, launches (A, B) {per_call} per call as derived; evaluate '
      f'restored step 0, 1 member x 1 step, finite RMSE; seconds '
      f'{json.dumps({k: round(v, 1) for k, v in seconds.items()})}; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return launches


def mfu_line(what: str, seconds: float, model_flops: float, card: str) -> str:
  from gencast_tpu_torch.training import flops
  return (f'[mfu] {what}: {1e3 * seconds:.2f} ms, {model_flops:.4e} model '
          f'FLOPs, {model_flops / seconds / 1e12:.1f} TFLOP/s, MFU '
          f'{100 * flops.mfu(model_flops, seconds):.2f}% of '
          f'{flops.H100_SXM_BF16_DENSE_PEAK_FLOPS / 1e12:.1f} TFLOP/s (H100 '
          f'SXM dense bf16); {card}')


def tools_and_accounting(spec, work, card, timed) -> None:
  """Phase 39: `python3 -m gencast_tpu_torch.tools.trace_sampler <dir>
  1deg` in a fresh process (`profile_step --mode sample --steps 1`): its
  trace file exists and its breakdown
  (`trace_qdeg.parse`) holds kernel A 16 times per denoiser call and B once,
  over the 39 calls of the traced forecast step; then one [mfu] line per
  entry of `timed` ((what, seconds an earlier phase measured, model
  FLOPs): no run is added)."""
  from gencast_tpu_torch import utils
  from gencast_tpu_torch.tools import trace_qdeg
  t_phase = time.perf_counter()
  out = os.path.join(work, 'chip_smoke_trace_1deg')
  run = run_ranks('gencast_tpu_torch.tools.trace_sampler', [out, '1deg'],
                  'trace_sampler')
  path = os.path.join(out, utils.TRACE_FILE)
  if not os.path.exists(path):
    raise AssertionError(f'trace_sampler wrote no trace at {path}')
  breakdown = trace_qdeg.parse(out, top=8)
  calls = 2 * spec.num_noise_levels - 1
  found = {f: breakdown['families'].get(f, [0.0, 0]) for f in ('A', 'B')}
  expected = {'A': calls * spec.num_layers, 'B': calls}
  if {f: n for f, (_, n) in found.items()} != expected:
    raise AssertionError(f'trace_sampler: kernels A, B {found} in the trace, '
                         f'expected {expected} launches')
  traced = [line for line in run['stdout'].splitlines()
            if line.startswith('[profile]')
            and ('profiled:' in line or 'model FLOPs per' in line)]
  for line in traced or ['no wall line']:
    log(f'[trace_sampler] {line}')
  log(f'[trace_sampler] 1deg: trace of {os.path.getsize(path) / 2**20:.1f} '
      f'MiB, {breakdown["total_ms"]:.1f} ms of device time, A '
      f'{found["A"][1]} launches ({found["A"][0]:.2f} ms), B {found["B"][1]} '
      f'({found["B"][0]:.2f} ms) over {calls} calls, as derived; wall '
      f'{run["wall"]:.1f} s; {card}')
  shutil.rmtree(out, ignore_errors=True)
  for what, seconds, model_flops in timed:
    log(mfu_line(what, seconds, model_flops, card))
  log(f'[timing] phase 39 in {time.perf_counter() - t_phase:.1f} s; {card}')


# Phase 42: the pod forecast's members over a model axis of 2 (bf16 nano,
# 2 steps of 39 denoiser calls, each row-parallel sum of two bf16 partials
# in float32) against the one-device members, max relative.
POD_MP_RTOL = 5e-2
# Phase 42's GraphCast_small under --mp 2: one processor step (its full
# depth runs in phases 32-34, and every step holds the same column/row
# pairs); the run is bound by the host's all-reduces, a few per pair.
GC_MP_LAYERS = 1


def rank_launches(run) -> dict:
  """{rank: kernel launches} from run_ranks' stdout (kernels never launched
  left out)."""
  return {r: {k: v for k, v in lines['kernel launches in this process']
              .items() if v} for r, lines in run['ranks'].items()}


def model_axis_1deg(spec, statics, dev, card, work, stats,
                    beside=contextlib.nullcontext) -> dict:
  """Phase 40: full-width, full-depth 1-degree training at batch 1 under
  `--mp 2` (`python3 -m gencast_tpu_torch.training.train --preset 1deg --mp
  2`: two ranks on cuda:0, gloo, eager, each holding 2 of the 4 heads and
  half of every MLP hidden width) for DP_STEPS steps with a checkpoint,
  against one process (`train.main` here): bf16 losses within
  DP_LOSS_RTOL. The float32 pair at CUT_LAYERS layers (--no-bf16, one
  process here and --mp 2), both with GENCAST_SPARSE_FUSED_BWD=1 (kernel G
  and its dq reduce in place of F): losses within TRAIN_LOSS_RTOL, each
  parameter's change within TRAIN_STEP_RTOL of the one process's. In every
  run the launches per rank-step are one process's
  (expected_step_launches; at full depth A 16, F 16 + 16, B 4, E 42): the
  kernels run on the rank's heads and on the full-width rows that the
  replicated LayerNorm+FiLM and aggregations see. The --mp 2 checkpoint
  (full tensors) is then restored by a --mp 1 evaluate (1 member x 1
  step, every RMSE finite). The bf16 --mp 2 run traces steps 1-2
  (`--profile_dir --profile_steps 1 2`, each rank's only profiler
  session): each rank's trace holds the launches of 2 steps, and gives the
  all-reduces' share of a step (allreduce_ms, as phase 36). Logs seconds
  per step, the model axis's all-reduces per step (calls and float32
  bytes from the CLI's pipeline line; the share from the traces) and peak
  memory per rank. The float32 --mp 2 run goes beside the one process's
  float32 run and the evaluate (it only checks; the bf16 runs, whose times
  are logged, run alone). Returns each kernel's launches over the ranks of
  the --mp 2 runs."""
  from gencast_tpu_torch.models.gencast import GenCast
  from gencast_tpu_torch.nn import transformer
  from gencast_tpu_torch.training import evaluate, train
  t_phase = time.perf_counter()
  base = ['--preset', '1deg', '--clean_sst_nans', '--data', 'synthetic',
          '--log_every', '1', '--stats_path', stats, '--prefetch', '0',
          '--steps', str(DP_STEPS)]
  f32 = ['--no-bf16', '--num_layers', str(CUT_LAYERS)]
  fused = {transformer.FUSED_BWD_ENV: '1'}
  runs, per_step, got = {}, {}, {}

  def one_process(name, argv, env):
    torch.cuda.empty_cache()
    for c in counters():
      c.reset()
    before = os.environ.get(transformer.FUSED_BWD_ENV)
    os.environ.update(env)
    try:
      run = train.main(base + argv + ['--ckpt_dir',
                                      os.path.join(work, name)])
    finally:
      if before is None:
        os.environ.pop(transformer.FUSED_BWD_ENV, None)
      else:
        os.environ[transformer.FUSED_BWD_ENV] = before
    per_step[name] = expected_step_launches(next(
        m for m in run.model.modules() if isinstance(m, GenCast)))
    launches = {c.name: c.launches for c in counters()}
    if launches != {k: v * DP_STEPS for k, v in per_step[name].items()}:
      raise AssertionError(f'1deg {name}: launches {launches}, '
                           f'{per_step[name]} per step expected')
    runs[name] = {'run': run, 'params': checkpoint_params(
        os.path.join(work, name), DP_STEPS)}
    run.model = None
    torch.cuda.empty_cache()

  def mp_argv(name, argv):
    return base + argv + ['--mp', '2', '--metrics_jsonl',
                          os.path.join(work, f'{name}.jsonl'), '--ckpt_dir',
                          os.path.join(work, name)]

  def mp_result(name, mp, like):
    with open(os.path.join(work, f'{name}.jsonl')) as f:
      losses = [r['loss'] for r in map(json.loads, f)
                if r['event'] == 'train']
    got[name] = rank_launches(mp)
    want = {k: v * DP_STEPS for k, v in per_step[like].items() if v}
    backends = re.findall(r'backend (\w+)', mp['stdout'])
    if (sorted(got[name]) != [0, 1]
        or any(v != want for v in got[name].values())
        or backends != ['gloo', 'gloo']
        or 'model axis 2: ' not in mp['stdout']):
      raise AssertionError(f'1deg --mp 2 ({name}): backends {backends}, '
                           f'launches by rank {got[name]}, expected {want} '
                           'each')
    runs[name] = {'losses': losses, 'ranks': mp['ranks'],
                  'params': checkpoint_params(os.path.join(work, name),
                                              DP_STEPS)}

  one_process('one', [], {})
  trace_dir = os.path.join(work, 'trace')
  traced = (1, 2)
  profile = ['--profile_dir', trace_dir, '--profile_steps'] + [
      str(x) for x in traced]
  mp_result('mp', run_ranks('gencast_tpu_torch.training.train',
                            mp_argv('mp', profile), '1deg --mp 2 (mp)'), 'one')

  # Each rank's trace of steps 1-2 of the bf16 run: the launches of those
  # steps, and the all-reduces' host ms over the step's (steps 1-2 are the
  # pipeline line's mean).
  profiled = traced[1] - traced[0] + 1
  shares = {}
  for rank, lines in sorted(runs['mp']['ranks'].items()):
    path = os.path.join(trace_dir, f'train_steps_{traced[0]}-{traced[1]}'
                                   f'.rank{rank}.pt.trace.json')
    in_trace = trace_kernel_counts(path)
    if in_trace != {k: v * profiled for k, v in per_step['one'].items()}:
      raise AssertionError(f'1deg --mp 2 rank {rank} trace of steps '
                           f'{traced[0]}-{traced[1]}: {in_trace}, '
                           f'{per_step["one"]} per step expected')
    shares[rank] = (allreduce_ms(path) / profiled,
                    1e3 * lines['pipeline']['step_s']['mean'])

  # The float32 --mp 2 run only checks (its times are not metrics): it runs
  # beside this process's float32 run and the evaluate, and `beside()`
  # (checks whose time is no metric either) around them.
  f32_started = start_ranks('gencast_tpu_torch.training.train',
                            mp_argv('mp_f32', f32), env=fused)
  try:
    with beside():
      one_process('one_f32', f32, fused)
      # The --mp 2 checkpoint (full tensors) restored at --mp 1 by evaluate.
      ev = evaluate.main(['--preset', '1deg', '--clean_sst_nans',
                          '--stats_path', stats, '--ckpt_dir',
                          os.path.join(work, 'mp'), '--num_members', '1',
                          '--max_rollout_steps', '1', '--plot_vars',
                          '--out_dir', os.path.join(work, 'eval')])
      rmse = ev.results['rmse']
      if not np.isfinite(list(rmse.values())).all():
        raise AssertionError(f'evaluate of the --mp 2 checkpoint: rmse '
                             f'{rmse}')
      del ev
      torch.cuda.empty_cache()
  except BaseException:
    stop_ranks(f32_started)
    raise
  mp_result('mp_f32', finish_ranks(f32_started, '1deg --mp 2 (mp_f32)'),
            'one_f32')

  from gencast_tpu_torch import configs
  initial, _ = configs.build_gencast(cut_depth(spec), seed=0,
                                     statics=statics, device=dev)
  start = [p.detach().cpu() for p in initial.parameters()]
  del initial

  def change_rel(a_params, b_params):
    return max(float(((b - p0) - (a - p0)).abs().max()
                     / (a - p0).abs().max())
               for a, b, p0 in zip(a_params, b_params, start)
               if (a - p0).abs().max() > 0)

  def loss_rel(a, b):
    if len(a) != len(b):
      return float('inf')
    return max(abs(x - y) / abs(x) for x, y in zip(a, b))

  bf16 = loss_rel(runs['one']['run'].losses, runs['mp']['losses'])
  f32 = (loss_rel(runs['one_f32']['run'].losses, runs['mp_f32']['losses']),
         change_rel(runs['one_f32']['params'], runs['mp_f32']['params']))
  if not (bf16 <= DP_LOSS_RTOL and f32[0] <= TRAIN_LOSS_RTOL
          and f32[1] <= TRAIN_STEP_RTOL):
    raise AssertionError(
        f'1deg --mp 2 against one process: bf16 losses rel {bf16} (tol '
        f'{DP_LOSS_RTOL}); float32 losses rel {f32[0]} (tol '
        f'{TRAIN_LOSS_RTOL}), worst parameter change rel {f32[1]} (tol '
        f'{TRAIN_STEP_RTOL})')
  ms_by_rank = {r: (round(a, 2), round(b, 2)) for r, (a, b) in shares.items()}
  share_by_rank = [round(a / b, 3) for a, b in shares.values()]
  for name in ('mp', 'mp_f32'):
    lines = {r: v['pipeline'] for r, v in sorted(runs[name]['ranks'].items())}
    step_s = {r: v['step_s'] for r, v in lines.items()}
    reduce = {r: v['model_axis_all_reduce'] for r, v in lines.items()}
    share = ('; beside the one process\'s float32 run and the evaluate'
             if name != 'mp' else
             f'; all-reduce ms per step and mean step ms by rank, traced '
             f'steps {traced[0]}-{traced[1]}: {ms_by_rank}, share '
             f'{share_by_rank}')
    log(f'[model axis 1deg] {name}: --mp 2 (two ranks on cuda:0, gloo, '
        f'eager), batch 1, {DP_STEPS} steps: step s by rank {step_s}; '
        f'model-axis all-reduces of a step by rank {reduce} (float32 '
        f'bytes){share}; peak memory GiB by rank '
        f'{ {r: round(v["peak_memory_gib"], 2) for r, v in lines.items()} }'
        f'; {card}')
  one = {k: [round(x, 4) for x in runs[k]['run'].step_seconds]
         for k in ('one', 'one_f32')}
  log(f'[model axis 1deg] --mp 2 against one process: bf16 losses max rel '
      f'{bf16:.3e} (tol {DP_LOSS_RTOL}); float32 at {CUT_LAYERS} layers '
      f'with G: losses max rel {f32[0]:.3e} (tol {TRAIN_LOSS_RTOL}), worst '
      f'parameter change rel {f32[1]:.3e} (tol {TRAIN_STEP_RTOL}); launches '
      f'per rank-step as derived, {per_step["one"]} (bf16), '
      f'{per_step["one_f32"]} (float32 with G); one process step s {one}; '
      f'the --mp 2 checkpoint evaluated at --mp 1, RMSE finite; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return {k: sum(v.get(k, 0) for run in got.values() for v in run.values())
          for k in per_step['one']}


def per_rank_heads(statics, nano_statics, g, card) -> dict:
  """Phase 41: kernels A and F at the 1-degree transformer's padded shape,
  and C and D at nano's, with the heads of one rank of a model axis of 2
  and of 4 ([1, 10304, 2, 128], [1, 10304, 1, 128]; [1, 2624, 2, 64],
  [1, 2624, 1, 64]), float32 and bf16, against their plain versions (the
  tolerances of phases 3, 7, 11 and 12), with card ms, bound and library
  ms. Returns the bf16 figures by kernel and head count."""
  t_phase = time.perf_counter()
  dev = g.device
  plan = statics.attention_tile_plan
  mt = torch.as_tensor(plan.mask_tiles, device=dev)
  plan_t = tuple(torch.as_tensor(a, device=dev) for a in (
      plan.fwd_kv_ids, plan.fwd_pair_ids, plan.bwd_q_ids, plan.bwd_pair_ids))
  dense = dense_from_plan(plan, dev)
  allowed = int(plan.mask_tiles.sum(dtype=np.int64))
  mask = nano_statics.attention_mask
  mask_t = torch.as_tensor(mask.blocks.astype(np.uint8), device=dev)
  dense_b = dense_from_blocks(mask.blocks, dev)
  allowed_b = int(mask.blocks.sum(dtype=np.int64))
  nano_n = mask.num_blocks * mask.block_size
  out = {}
  for heads in (2, 1):
    for dtype, atol, rtol in ((torch.float32, ATTN_F32_ATOL, BWD_F32_RTOL),
                              (torch.bfloat16, ATTN_BF16_ATOL,
                               BWD_BF16_RTOL)):
      a_shape = (plan.padded_n, heads, 128)
      c_shape = (nano_n, heads, 64)
      res = {
          'A': check_attention(a_shape, dtype, atol, mt, *plan_t[:2],
                               plan.tile, g, dense, allowed),
          'F': check_attention_bwd(a_shape, dtype, rtol, mt, plan_t,
                                   plan.tile, g, dense, allowed),
          'C': check_banded(c_shape, dtype, atol, mask_t, mask.block_size, g,
                            dense_b, allowed_b),
          'D': check_banded_bwd(c_shape, dtype, rtol, mask_t,
                                mask.block_size, g, dense_b, allowed_b)}
      if dtype == torch.bfloat16:
        out[heads] = res
      ms = {k: (round(v[1]['kernel'], 4) if 'kernel' in v[1] else
                {p: round(v[1][p], 4) for p in ('dq', 'dkv')})
            for k, v in res.items()}
      log(f'[per-rank heads] H={heads} {dtype}: A, F at [1, {plan.padded_n}, '
          f'{heads}, 128], C, D at [1, {nano_n}, {heads}, 64] against their '
          f'plain versions, card ms {ms}')
  del dense, dense_b
  torch.cuda.empty_cache()
  log(f'[timing] phase 41 in {time.perf_counter() - t_phase:.1f} s; {card}')
  return out


def per_rank_rows(res, shapes) -> dict:
  """The JSON line's figures of kernels A, F-dq, F-dkv, C, D-dq and D-dkv
  at one rank's heads (phase 41's bf16 results `res`; `shapes`, those of
  A and F and of C and D): {kernel name: {...}}."""
  from gencast_tpu_torch.ops import banded_attention, sparse_attention
  bf16 = torch.bfloat16
  err_a, ms_a, cost_a = res['A']
  errs_f, ms_f, costs_f = res['F']
  err_c, ms_c, cost_c = res['C']
  errs_d, ms_d, costs_d = res['D']

  def entry(shape, err, ms, plain_ms, library_ms, cost):
    bound_ms, bound_by = bound(*cost, bf16)
    return {'shape': shape, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': library_ms}

  a, c = shapes
  return {
      sparse_attention.KERNEL.name: entry(
          a, err_a, ms_a['kernel'], ms_a['plain'], ms_a['library'], cost_a),
      sparse_attention.KERNEL_DQ.name: entry(
          a, errs_f['dq'][1], ms_f['dq'], ms_f['dq_plain'], ms_f['library'],
          costs_f['dq']),
      sparse_attention.KERNEL_DKV.name: entry(
          a, errs_f['dkv'][1], ms_f['dkv'], ms_f['dkv_plain'],
          ms_f['library'], costs_f['dkv']),
      banded_attention.KERNEL.name: entry(
          c, err_c, ms_c['kernel'], ms_c['plain'], ms_c['library'], cost_c),
      banded_attention.KERNEL_DQ.name: entry(
          c, errs_d['dq'][1], ms_d['dq'], ms_d['dq_plain'], ms_d['library'],
          costs_d['dq']),
      banded_attention.KERNEL_DKV.name: entry(
          c, errs_d['dkv'][1], ms_d['dkv'], ms_d['dkv_plain'],
          ms_d['library'], costs_d['dkv'])}


def pod_and_graphcast_mp(spec, dev, card, work, beside_pod,
                         beside_gc) -> dict:
  """Phase 42: `python3 -m gencast_tpu_torch.scripts.ensemble_forecast_pod
  --preset nano --members 2 --steps 2 --score --num_processes 4` (ensemble
  2 x model 2 on cuda:0, gloo): each member saved once, within POD_MP_RTOL
  of the one-device member, its scores within POD_SCORE_RTOL of
  ops.metrics on the saved members, C 16 and B 1 launches per denoiser
  call and rank; GraphCast_small at GC_MP_LAYERS processor step trained 2
  steps under --mp 2, B per rank-step as derived. GraphCast's ranks start
  with the pod's; `beside_pod()` (phase 38 and phase 22's profiler check)
  runs here while the pod's ranks run, then `beside_gc()` (phase 43's
  ranks) while GraphCast's finish. None of these times is a metric: each
  run only checks (the pod's seconds per member-step, eager over 4 ranks
  on one card, are logged, not held; phase 37 gives the pod's metric).
  Returns each kernel's launches by path, over the ranks."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import layout as layout_lib
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import banded_attention, ln_film, metrics, \
      segment
  from gencast_tpu_torch.parallel import ensemble
  from gencast_tpu_torch.scripts import ensemble_forecast_pod as pod
  t_phase = time.perf_counter()
  nano = configs.NANO
  members, steps = 2, 2
  out = os.path.join(work, 'forecast_mp.npz')
  argv = ['--preset', 'nano', '--members', str(members), '--steps',
          str(steps), '--score', '--out', out]
  gc_spec = dataclasses.replace(spec, num_layers=GC_MP_LAYERS)
  gc, _ = configs.build_graphcast(gc_spec, device=dev)
  gc_step = graphcast_launches(gc, train=True)
  del gc
  torch.cuda.empty_cache()
  pod_started = start_ranks('gencast_tpu_torch.scripts.ensemble_forecast_pod',
                            argv + ['--num_processes', '4'])
  gc_started = start_ranks('gencast_tpu_torch.training.train', [
      '--model', 'graphcast', '--preset', '1deg', '--num_layers',
      str(GC_MP_LAYERS), '--data', 'synthetic', '--steps', '2', '--mp', '2',
      '--log_every', '1', '--prefetch', '0'])
  try:
    beside_pod()
    run = finish_ranks(pod_started, 'pod forecast, 4 ranks')
  except BaseException:
    stop_ranks(pod_started)
    stop_ranks(gc_started)
    raise
  wrapped, statics, (inputs, forcings, targets) = pod.build_forecast(
      pod.parse_args(argv), dev)
  # One member per call, as each rank runs its member.
  want = ensemble.ensemble_rollout(wrapped, inputs, forcings, seed=0,
                                   num_members=members,
                                   member_chunk=1).numpy()
  got = np.zeros(want.shape, np.float32)
  for e in range(2):
    z = np.load(f'{os.path.splitext(out)[0]}.p{e}.npz')
    got[z['members']] = z['predictions']
  member_rel = float(np.abs(got - want).max() / np.abs(want).max())
  mem = torch.as_tensor(got, device=dev)
  lat_w = torch.as_tensor(layout_lib.latitude_weights(
      np.asarray(statics.grid_lat)), device=dev)
  layout = wrappers.find_layout_provider(wrapped).target_layout
  reference = {
      'crps': metrics.crps_ensemble(mem, targets, lat_w),
      'rmse': metrics.ensemble_mean_rmse(mem, targets, lat_w),
      'spread': metrics.ensemble_spread(mem, lat_w)}
  with open(f'{os.path.splitext(out)[0]}.scores.json') as f:
    scores = json.load(f)['scores']
  worst = 0.0
  for name, arr in reference.items():
    for var, v in metrics.per_variable(arr, layout).items():
      w, s = np.asarray(v)[:, 0], np.asarray(scores[name][var])
      worst = max(worst, float(np.abs(s - w).max() / np.abs(w).max()))
  pod_fwd = ln_film_fwd_launches(wrapped)
  del wrapped, mem
  calls = steps * (2 * nano.num_noise_levels - 1)
  pod_want = {banded_attention.KERNEL.name: calls * nano.num_layers,
              segment.KERNEL.name: calls,
              ln_film.KERNEL_FWD.name: calls * pod_fwd}
  pod_got = rank_launches(run)
  if not (member_rel <= POD_MP_RTOL and worst <= POD_SCORE_RTOL
          and run['stdout'].count('mesh ensemble=2 model=2') == 4
          and sorted(pod_got) == [0, 1, 2, 3]
          and all(v == pod_want for v in pod_got.values())):
    raise AssertionError(f'pod forecast, ensemble 2 x model 2: members rel '
                         f'{member_rel} (tol {POD_MP_RTOL}), scores rel '
                         f'{worst} (tol {POD_SCORE_RTOL}), launches '
                         f'{pod_got} (expected {pod_want} each)')
  member_step = [float(x) for x in re.findall(
      r'\(([0-9.]+) s per kept member-step', run['stdout'])]
  log(f'[pod nano] 4 ranks on cuda:0 (ensemble 2 x model 2, gloo, eager), '
      f'{members} members x {steps} steps, --score: members against the '
      f'one-device members max rel {member_rel:.3e} (tol {POD_MP_RTOL}); '
      f'scores against ops.metrics worst rel {worst:.3e} (tol '
      f'{POD_SCORE_RTOL}); launches per rank {pod_want}, as derived; '
      f'seconds per kept member-step by rank {member_step} (beside phase '
      f'38, phase 22\'s profiler check and GraphCast_small --mp 2: no '
      f'metric); wall {run["wall"]:.1f} s; {card}')

  try:
    beside_gc()
    gc_run = finish_ranks(gc_started, 'GraphCast_small --mp 2')
  except BaseException:
    stop_ranks(gc_started)
    raise
  gc_got = rank_launches(gc_run)
  gc_want = {k: 2 * v for k, v in gc_step.items() if v}
  gc_losses = [float(x) for x in re.findall(r'step \d+/2 loss=([-0-9.naif]+)',
                                            gc_run['stdout'])]
  if (sorted(gc_got) != [0, 1] or any(v != gc_want for v in gc_got.values())
      or len(gc_losses) != 4 or not np.isfinite(gc_losses).all()):
    raise AssertionError(f'GraphCast --mp 2: launches {gc_got} (expected '
                         f'{gc_want} each), losses {gc_losses}')
  gc_ms = {r: round(1e3 * v['pipeline']['step_s']['mean'], 2)
           for r, v in gc_run['ranks'].items()}
  log(f'[graphcast mp] GraphCast_small at {GC_MP_LAYERS} processor step, '
      f'--mp 2 (two ranks on cuda:0, gloo, eager), 2 steps: losses '
      f'{gc_losses[:2]}, B {gc_want} per rank as derived (beside the pod, '
      f'phase 38 and phase 43); mean step ms by '
      f'rank {gc_ms}; phase {time.perf_counter() - t_phase:.1f} s; {card}')
  return {'pod_nano_mp': {k: sum(v.get(k, 0) for v in pod_got.values())
                          for k in pod_want},
          'graphcast_mp': {k: sum(v.get(k, 0) for v in gc_got.values())
                           for k in gc_want}}


def start_dryrun():
  """`python3 -m gencast_tpu_torch.tools.dryrun_multichip 8` started (a
  check whose time is no metric: it runs beside phase 40's float32 --mp 2
  run); finish_dryrun takes it."""
  return start_ranks('gencast_tpu_torch.tools.dryrun_multichip', ['8'])


def finish_dryrun(started, dev, card) -> dict:
  """Phase 42's dryrun: mesh (2, 2, 2), the grid nodes sharded over the
  model axis, every kernel of its paths launched on every rank, B on the
  TINY kernel path as derived from each rank's grid rows. Returns each
  kernel's launches over the ranks."""
  from gencast_tpu_torch.ops import ln_film, segment
  dry = finish_ranks(started, 'dryrun_multichip 8')
  dry_got = {int(r): json.loads(j) for r, j in re.findall(
      r'\[dryrun\] rank (\d+) launches (\{.*\})', dry['stdout'])}
  tiny_got = {int(r): json.loads(j) for r, j in re.findall(
      r'\[dryrun\] rank (\d+) TINY kernel path launches (\{.*\})',
      dry['stdout'])}
  tiny_b = dryrun_tiny_b_launches(dev)
  path_kernels = {c.name for c in counters()[:8]} | {ln_film.KERNEL_FWD.name}
  seen = {k for v in dry_got.values() for k in v}
  b_name = segment.KERNEL.name
  b_by_rank = {r: v.get(b_name, 0) for r, v in sorted(tiny_got.items())}
  if ('dryrun_multichip ok: mesh=(2,2,2)' not in dry['stdout']
      or dry['stdout'].count('dryrun kernels ok') != 2
      or 'grid nodes sharded over the model axis: True' not in dry['stdout']
      or 'not ported' in dry['stdout']
      or sorted(dry_got) != list(range(8)) or seen != path_kernels
      or b_by_rank != {r: tiny_b[r % 2] for r in range(8)}):
    raise AssertionError(f'dryrun_multichip 8: B on the TINY kernel path by '
                         f'rank {b_by_rank}, derived {tiny_b} by model '
                         f'index\n{dry["stdout"][-3000:]}')
  log(f'[dryrun] {[ln for ln in dry["stdout"].splitlines() if "ok" in ln]}; '
      f'grid nodes sharded over the model axis; kernels launched on every '
      f'rank: {sorted(seen)}; B on the TINY kernel path (the rank\'s grid '
      f'rows\' plans and stream chunks) by rank {b_by_rank}, as derived; '
      f'wall {dry["wall"]:.1f} s (beside phase 40\'s float32 --mp 2 run); '
      f'{card}')
  return {k: sum(v.get(k, 0) for v in dry_got.values()) for k in seen}


def dryrun_tiny_b_launches(dev) -> dict:
  """Kernel B's launches in the loss and backward of the dryrun's TINY
  kernel path (`tools.dryrun_multichip._kernel_paths`: triblock_pallas,
  plans forced, streamed edges, save_attention) on the rank of each model
  index of a model axis of 2, derived from the model with that rank's
  grid rows (expected_step_launches): {model index: launches}."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.parallel import tensor
  from gencast_tpu_torch.ops import segment
  spec = dataclasses.replace(
      configs.TINY, attention_type='triblock_pallas',
      remat_policy='save_attention', use_agg_plans=True,
      agg_plan_min_degree=1, edge_chunk_size=1024, num_noise_levels=2)
  out = {}
  for index in range(2):
    model, _ = configs.build_gencast(spec, seed=0, device=dev,
                                     node_sharding_axis='model')
    tensor.shard_model(model, tensor.ModelAxis(None, 2, index))
    out[index] = expected_step_launches(model)[segment.KERNEL.name]
  return out


# Phase 43: 1-degree steps of the node-sharded run (and of its one-process
# reference); the first update takes the full rate (no warmup), so the
# second loss sees the first step's gradients.
NODE_STEPS = 2
# Its denoiser call against one process, max|sharded - one| / max|one|:
# float32, the same arithmetic in other summation orders (grid2mesh's
# mesh-side sums as two partial sums; each row-parallel product as two)
# through 16 layers, as STREAMED_F32_RTOL; bf16, each rank's partial
# product rounded to bf16 before the float32 sum (DENOISER_BF16_RTOL's
# flipped roundings carried through 16 layers).
NODE_F32_RTOL = 1e-4
NODE_BF16_RTOL = 5e-2
# Its float32 training pair's first gradients against one process, per
# parameter max|sharded - one| / max|one|: TRAIN_GRAD_RTOL's summation
# orders through 16 layers instead of 2 (a partial gradient missing,
# halved or counted twice is off by O(1)).
NODE_GRAD_RTOL = 1e-3


def node_axis_stack(spec, stats_path, dev, axis):
  """GenCast of `spec` with `node_sharding_axis='model'` (seed 0, its
  weights perturbed by `bridge.perturbed`), its bf16 stack with
  --clean_sst_nans over the statistics file `stats_path`, sharded over
  `axis` (None: nothing sharded, the unsharded model): (model, stack,
  stats, statics)."""
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import casting, wrappers
  from gencast_tpu_torch.parallel import tensor
  model, statics = configs.build_gencast(spec, seed=0, device=dev,
                                         node_sharding_axis='model')
  bridge.load_reference_params(model, bridge.perturbed(
      bridge.export_reference_params(model), seed=7))
  stats = sources.load_stats_auto(stats_path, model.task.pressure_levels)
  stack = wrappers.build_stack(model, stats, bf16=True,
                               clean_sst_nans=True).to(dev)
  tensor.shard_model(stack, axis)
  casting.refresh_all(stack)
  return model, stack, stats, statics


def rel_by_parameter(got, want):
  """max over parameters of max|got - want| / max|want| (parameters whose
  `want` is all zeros must be zeros in `got`), and the worst one's name."""
  worst = (0.0, None)
  for name, w in want.items():
    g, scale = got[name].to(w.device), float(w.abs().max())
    err = float((g - w).abs().max())
    r = err / scale if scale > 0 else (0.0 if err == 0 else float('inf'))
    worst = max(worst, (r, name), key=lambda x: x[0])
  return worst


def node_axis_run(spec, stats_path, dev, axis, reference=None) -> dict:
  """node_axis_stack's model over `axis`, with perturbed weights (the
  seeded init's zero output projections would leave the processor's
  row-parallel sums exact and the first loss without gradients): one
  denoiser call of seeded inputs through the bf16 stack and through a
  float32 stack; from those weights, NODE_STEPS float32 training steps at
  batch 1 on the synthetic source's batches (batch_iterator, seed 0) with
  the CLI's draws of each step, AdamW without warmup, keeping the first
  step's gradients and each parameter's change (full tensors, gathered
  over the axis); then from the same weights the same steps through the
  bf16 stack, measured. Returns the two calls' outputs (on the host) and
  seconds, the float32 losses, the bf16 losses, each bf16 step's seconds,
  kernel launches and the axis's all_reduce calls and bytes, the launches
  derived from the model (expected_step_launches), and the bf16 steps'
  peak memory. Without `reference` also the float32 gradients and changes
  (on the host); with it (a file of those from one process), their worst
  relative errors against it (rel_by_parameter; for the changes also
  ||change - one's|| / ||one's||)."""
  from gencast_tpu_torch.data import sources
  from gencast_tpu_torch.models import casting, wrappers
  from gencast_tpu_torch.parallel import tensor
  from gencast_tpu_torch.training import steps, train
  model, stack, stats, statics = node_axis_stack(spec, stats_path, dev, axis)
  out = {'rows': model.denoiser.architecture.node_rows}
  d = model.denoiser
  g = torch.Generator().manual_seed(3)
  grid = (1, d.num_lat, d.num_lon)
  inputs, noisy, forcings = (
      torch.randn(grid + (lay.num_channels,), generator=g).to(dev)
      for lay in (d.input_layout, d.target_layout, d.forcing_layout))
  sigma = torch.tensor([2.0], device=dev)
  f32_stack = wrappers.build_stack(model, stats, bf16=False,
                                   clean_sst_nans=True).to(dev)
  with torch.no_grad():
    for name, s in (('bf16', stack), ('f32', f32_stack)):
      torch.cuda.synchronize(dev)
      t0 = time.perf_counter()
      out[f'call_{name}'] = s(inputs, noisy, sigma, forcings).cpu()
      out[f'call_{name}_s'] = time.perf_counter() - t0
  del inputs, noisy, forcings
  torch.cuda.empty_cache()

  source = sources.SyntheticSource(model.task, np.asarray(statics.grid_lat),
                                   np.asarray(statics.grid_lon),
                                   num_times=40, seed=0)
  perturbed = [p.detach().clone() for p in model.parameters()]
  dims = tensor.sharded_dims(model)

  def train_steps(s, on_step=None):
    with torch.no_grad():
      for p, p0 in zip(model.parameters(), perturbed):
        p.copy_(p0)
    casting.refresh_all(s)
    optimizer = steps.create_optimizer(s, steps.OptimizerConfig(
        warmup_steps=0, total_steps=NODE_STEPS))
    batches = sources.batch_iterator(source, 1, seed=0)
    losses = []
    for step in range(NODE_STEPS):
      batch = {k: torch.as_tensor(v).to(dev)
               for k, v in next(batches).items()}
      if on_step is not None:
        on_step(step, optimizer)
      loss, _ = steps.train_step(s, optimizer, batch['inputs'],
                                 batch['targets'], batch['forcings'],
                                 train.step_generator(0, step, dev))
      losses.append(float(loss))
      if on_step is not None:
        on_step(None, optimizer)
    return losses

  # The float32 pair: the first step's gradients (taken before the
  # update) and each parameter's change after the steps, full tensors.
  kept = {}

  def keep_first_gradients(step, optimizer):
    if step != 0:
      return
    update = optimizer.update

    def update_keeping():
      kept['grads'] = tensor.gather_state_dict(
          {n: (p.grad.detach().clone() if p.grad is not None
               else torch.zeros_like(p))
           for n, p in model.named_parameters()}, dims, axis)
      optimizer.update = update
      update()

    optimizer.update = update_keeping

  out['f32_losses'] = train_steps(f32_stack, keep_first_gradients)
  with torch.no_grad():
    change = tensor.gather_state_dict(
        {n: p.detach() - p0 for (n, p), p0 in zip(model.named_parameters(),
                                                  perturbed)}, dims, axis)
  if reference is None:
    out['f32_grads'] = {n: v.cpu() for n, v in kept['grads'].items()}
    out['f32_change'] = {n: v.cpu() for n, v in change.items()}
  else:
    want = torch.load(reference, map_location=dev)
    out['f32_grad_rel'] = rel_by_parameter(kept['grads'], want['grads'])
    out['f32_change_rel'] = max(
        ((float((change[n] - w).norm() / w.norm()), n)
         for n, w in want['change'].items() if w.norm() > 0),
        key=lambda x: x[0])
    out['f32_change_max_rel'] = rel_by_parameter(change, want['change'])
    del want
  del kept, change, f32_stack
  torch.cuda.empty_cache()

  traffic = axis.traffic if axis is not None else {'calls': 0, 'bytes': 0}
  out.update(step_s=[], launches=[], all_reduce=[])
  timing = {}

  def measure(step, optimizer):
    if step is not None:
      for c in counters():
        c.reset()
      timing['before'] = dict(traffic)
      torch.cuda.synchronize(dev)
      timing['t0'] = time.perf_counter()
      return
    torch.cuda.synchronize(dev)
    out['step_s'].append(time.perf_counter() - timing['t0'])
    out['launches'].append({c.name: c.launches for c in counters()})
    out['all_reduce'].append({k: traffic[k] - timing['before'][k]
                              for k in timing['before']})

  torch.cuda.reset_peak_memory_stats(dev)
  out['losses'] = train_steps(stack, measure)
  out['peak_gib'] = torch.cuda.max_memory_allocated(dev) / 2**30
  out['derived'] = expected_step_launches(model)
  return out


def node_axis_rank(rank, world, coordinator, spec, stats_path, out_dir,
                   device='cuda') -> None:
  """One rank of phase 43 (spawned by `meshes.spawn`): node_axis_run over
  the model axis of `world` ranks on cuda:0 (gloo), against the one
  process's float32 gradients and changes in out_dir/one_f32.pt; writes
  its results to out_dir/rank<r>.pt."""
  from gencast_tpu_torch.parallel import meshes, tensor
  backend, dev = meshes.initialize(coordinator, world, rank, device=device)
  try:
    mesh = meshes.make_mesh(model=world)
    out = node_axis_run(spec, stats_path, dev, tensor.axis_of(mesh),
                        reference=os.path.join(out_dir, 'one_f32.pt'))
    out['backend'] = backend
    torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
  finally:
    meshes.shutdown()


def rank_plans_b(spec, statics, g, card) -> dict:
  """Kernel B (check_segment_plan, float32 and bf16, without the split
  variants) on the plans of each rank's edges under a node axis of 2 at 1
  degree: the grid2mesh receivers (mesh nodes, this rank's partial sums),
  its senders (this rank's grid rows) and the mesh2grid senders (mesh
  nodes). Returns {(name, dtype): (max abs err, ms, bound inputs)} and each
  plan's [E, C] under ('shape', name)."""
  from gencast_tpu_torch.models.denoiser import DenoiserConfig, rank_topology
  from gencast_tpu_torch.nn.gnn import EdgeTopology
  from gencast_tpu_torch.parallel import tensor
  cfg = DenoiserConfig(use_agg_plans=True,
                       agg_plan_min_degree=spec.agg_plan_min_degree)
  m = statics.num_mesh_nodes
  topos = [EdgeTopology(name, snd, rcv, edges.senders, edges.receivers)
           for name, snd, rcv, edges in (
               ('g2m', 'grid', 'mesh', statics.grid2mesh),
               ('m2g', 'mesh', 'grid', statics.mesh2grid))]
  results = {}
  for r in range(2):
    lo, hi = tensor.node_rows(len(statics.grid_lat), len(statics.grid_lon),
                              tensor.ModelAxis(None, 2, r))
    g2m, _ = rank_topology(topos[0], lo, hi, m, cfg)
    m2g, _ = rank_topology(topos[1], lo, hi, m, cfg)
    for name, ids, n in (
        (f'rank {r} grid2mesh receivers', g2m.receivers, m),
        (f'rank {r} grid2mesh senders', g2m.senders, hi - lo),
        (f'rank {r} mesh2grid senders', m2g.senders, m)):
      results.update(check_segment_plan(name, ids, n, spec.d_model, g, card,
                                        variants=False))
      results[('shape', name)] = [len(ids), spec.d_model]
  return results


def node_axis_b(spec, statics, g, card) -> dict:
  """Phase 43's kernel B on each rank's plans (rank_plans_b), timed
  alone (in phase 41, before phase 42's ranks start)."""
  t0 = time.perf_counter()
  b_results = rank_plans_b(spec, statics, g, card)
  b_ms = {key[0]: round(value[1]['kernel'], 4)
          for key, value in b_results.items() if key[1] == torch.bfloat16}
  log(f'[node axis 1deg] kernel B on each rank\'s plans (bf16 in, card ms): '
      f'{b_ms}, float32 and bf16 against the plain version (tol '
      f'{SEGMENT_RTOL}); {time.perf_counter() - t0:.1f} s; {card}')
  return b_results


def node_axis_1deg(spec, dev, card, work, stats) -> dict:
  """Phase 43: the grid-node axis at 1 degree, full width, `spec`'s depth
  (chip_smoke runs it at CUT_LAYERS: phase 40 drives the model axis at
  full depth, and a rank's grid rows do not depend on the depth)
  (`DenoiserConfig.node_sharding_axis='model'`), through the Python API as
  the reference's dryrun uses it (kernel B on each rank's plans:
  node_axis_b): node_axis_run in this process (one process, the
  reference) and on two spawned ranks on cuda:0 (gloo, eager; each holds
  half the grid's latitude rows, 2 of the 4 heads and half of each
  transformer MLP's hidden width). Checks, from perturbed weights: the
  float32 training pair's losses within TRAIN_LOSS_RTOL, every first
  gradient within NODE_GRAD_RTOL and every parameter's change within
  TRAIN_STEP_RTOL of one process's, as ||change - one's|| / ||one's||
  (the largest entry's figure is logged, not held: Adam turns the noise of
  a near-zero gradient entry into a full-size update); a missing, halved
  or doubled partial gradient fails both; the bf16 ranks' losses against one process within
  DP_LOSS_RTOL and equal on both ranks, the denoiser call within
  NODE_BF16_RTOL (bf16) and NODE_F32_RTOL (float32), the launches of
  each rank-step as derived from the rank's model (at 16 layers A 16, F 16
  + 16, B 4, E 42) and the model axis's all_reduces of each rank-step as
  derived (one forward sum of grid2mesh's mesh-side partials, two per
  layer in the processor, the output gathered; two copies per layer
  backward, four in the GNNs and one sum of the GNNs' partial gradients:
  71 at 16 layers). Logs seconds,
  all_reduce calls and float32 bytes and peak memory per rank-step (its
  seconds are no metric: it runs beside GraphCast's --mp 2 ranks).
  Returns each kernel's launches over the ranks' steps."""
  from gencast_tpu_torch.parallel import meshes
  t_phase = time.perf_counter()
  one = node_axis_run(spec, stats, dev, None)
  torch.save({'grads': one.pop('f32_grads'), 'change': one.pop('f32_change')},
             os.path.join(work, 'one_f32.pt'))
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  meshes.spawn(node_axis_rank, 2, (spec, stats, work))
  ranks_wall = time.perf_counter() - t0
  ranks = [torch.load(os.path.join(work, f'rank{r}.pt'), weights_only=False)
           for r in range(2)]
  layers = spec.num_layers
  calls = (1 + 2 * layers + 1) + (2 * layers + 4 + 1)

  def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())

  losses = max(abs(x - y) / abs(y) for r in ranks
               for x, y in zip(r['losses'], one['losses']))
  call_rel = {k: max(rel(r[f'call_{k}'], one[f'call_{k}']) for r in ranks)
              for k in ('bf16', 'f32')}
  f32_losses = max(abs(x - y) / abs(y) for r in ranks
                   for x, y in zip(r['f32_losses'], one['f32_losses']))
  grad_rel = max((r['f32_grad_rel'] for r in ranks), key=lambda x: x[0])
  change_rel = max((r['f32_change_rel'] for r in ranks), key=lambda x: x[0])
  change_max = max((r['f32_change_max_rel'] for r in ranks),
                   key=lambda x: x[0])
  bad = []
  if not (f32_losses <= TRAIN_LOSS_RTOL and grad_rel[0] <= NODE_GRAD_RTOL
          and change_rel[0] <= TRAIN_STEP_RTOL
          and all(len(r['f32_losses']) == NODE_STEPS for r in ranks)):
    bad.append(f'float32 losses {[r["f32_losses"] for r in ranks]} against '
               f'one process {one["f32_losses"]} (max rel {f32_losses:.3e}, '
               f'tol {TRAIN_LOSS_RTOL}); first gradients worst rel '
               f'{grad_rel} (tol {NODE_GRAD_RTOL}); parameter changes worst '
               f'rel {change_rel} (tol {TRAIN_STEP_RTOL})')
  if not (losses <= DP_LOSS_RTOL and ranks[0]['losses'] == ranks[1]['losses']
          and len(ranks[0]['losses']) == NODE_STEPS):
    bad.append(f'losses {[r["losses"] for r in ranks]} against one '
               f'process {one["losses"]} (max rel {losses:.3e})')
  if not (call_rel['bf16'] <= NODE_BF16_RTOL
          and call_rel['f32'] <= NODE_F32_RTOL):
    bad.append(f'denoiser call max rel {call_rel}')
  for r, res in enumerate(ranks):
    main_path = ('sparse_attention_fwd', 'sparse_attention_bwd_dq',
                 'sparse_attention_bwd_dkv', 'segment_sum', 'ln_film_bwd')
    if (res['backend'] != 'gloo' or any(l != res['derived']
                                        for l in res['launches'])
        or not all(res['derived'].get(k) for k in main_path)
        or any(a['calls'] != calls for a in res['all_reduce'])):
      bad.append(f'rank {r}: backend {res["backend"]}, launches '
                 f'{res["launches"]} (derived {res["derived"]}), '
                 f'all_reduces {res["all_reduce"]} ({calls} calls derived)')
  if any(l != one['derived'] for l in one['launches']):
    bad.append(f'one process: launches {one["launches"]}, derived '
               f'{one["derived"]}')
  if bad:
    raise AssertionError('1deg node axis: ' + '; '.join(bad))
  for r, res in enumerate(ranks):
    log(f'[node axis 1deg] rank {r} (grid rows {res["rows"]}), --mp 2 with '
        f'the grid nodes sharded (two ranks on cuda:0, gloo, eager), batch '
        f'1, {spec.num_layers} layers: step s {[round(x, 4) for x in res["step_s"]]}; all_reduces per '
        f'step {res["all_reduce"]} (float32 bytes); peak memory '
        f'{res["peak_gib"]:.2f} GiB; launches per step {res["launches"][-1]}'
        f', as derived; denoiser call s bf16 {res["call_bf16_s"]:.3f}, '
        f'float32 {res["call_f32_s"]:.3f}; {card}')
  log(f'[node axis 1deg] against one process, from perturbed weights: '
      f'float32 training, {NODE_STEPS} steps: losses max rel '
      f'{f32_losses:.3e} (tol {TRAIN_LOSS_RTOL}), every first gradient '
      f'(gathered) worst rel {grad_rel[0]:.3e} ({grad_rel[1]}; tol '
      f'{NODE_GRAD_RTOL}), every parameter\'s change worst rel '
      f'{change_rel[0]:.3e} (root-sum-square; {change_rel[1]}; tol '
      f'{TRAIN_STEP_RTOL}; by the largest entry {change_max[0]:.3e}, '
      f'{change_max[1]}, logged); bf16 '
      f'losses max rel {losses:.3e} '
      f'(tol {DP_LOSS_RTOL}), {ranks[0]["losses"]} on both ranks, one '
      f'process {one["losses"]}; denoiser call max rel bf16 '
      f'{call_rel["bf16"]:.3e} (tol {NODE_BF16_RTOL}), float32 '
      f'{call_rel["f32"]:.3e} (tol {NODE_F32_RTOL}); one process step s '
      f'{[round(x, 4) for x in one["step_s"]]}, peak {one["peak_gib"]:.2f} '
      f'GiB; ranks wall {ranks_wall:.1f} s; phase '
      f'{time.perf_counter() - t_phase:.1f} s; {card}')
  return {k: sum(step.get(k, 0) for r in ranks for step in r['launches'])
          for k in ranks[0]['launches'][0]}


# Phase 44: ensemble members as one batch. Members and forecast steps of
# each preset's batch (nano 8 x 2 graphed, 1 degree 4 x 1), and the member
# batches at which kernels A, C and B are checked.
MEMBER_BATCHES = {'nano': (8, 2), '1deg': (4, 1)}
MEMBER_BATCH_WIDTHS = (4, 8)  # B's f = members x 512
# A member of a batch against its one-member run, max|batched - own| /
# max|own|, where they are not bitwise equal: the rows are each their own
# (the conditioning GEMMs row by row, nn/mlp.py `RowwiseLinear`; kernels
# A, B and C per batch entry), but cuBLAS may pick another algorithm for the M·B
# rows of a GEMM than for B, which sums a bf16 product's float32 terms in
# another order; a flipped bf16 rounding is then carried through the
# step's 39 denoiser calls and the next step (DENOISER_BF16_RTOL's
# reasoning).
MEMBER_BATCH_RTOL = 5e-2


def member_batch_kernels(spec, statics, nano_statics, g, card) -> dict:
  """Phase 44, first part: kernels A, C and B at the member batches'
  shapes against their plain versions, float32 and bf16, with card ms,
  bound and library ms: A at [4, 10304, 4, 128] and the ragged
  [4, 10242, 4, 128] (four 1-degree members), C at [8, 2624, 4, 64] (eight
  nano members), B on the 1-degree and nano grid2mesh receiver plans (the
  sampler's one B launch a call) at f = 4 x 512 and 8 x 512, the edge rows
  of 4 and 8 members of d_model 512 (nano's 8 x 256 is 2,048 too).
  A's slow plain version (70 ms a call) and library call are timed over 3
  calls a turn, as at 0.25 degrees. Returns {key: (max abs err, ms, bound
  inputs)} as the checks give them."""
  from gencast_tpu_torch import configs
  out = {}
  members = MEMBER_BATCHES['1deg'][0]
  plan = statics.attention_tile_plan
  h = spec.num_heads
  d = spec.d_model // h
  mt, ids, pids = (torch.as_tensor(a, device=g.device) for a in (
      plan.mask_tiles, plan.fwd_kv_ids, plan.fwd_pair_ids))
  dense = dense_from_plan(plan, g.device)
  allowed = int(plan.mask_tiles.sum(dtype=np.int64))
  for dtype, atol in ((torch.float32, ATTN_F32_ATOL),
                      (torch.bfloat16, ATTN_BF16_ATOL)):
    for rows in (plan.padded_n, statics.num_mesh_nodes):
      out[('A', dtype, rows)] = check_attention(
          (rows, h, d), dtype, atol, mt, ids, pids, plan.tile, g,
          dense[:rows, :rows], allowed, reps=3, batch=members)
  del dense
  nano = configs.NANO
  mask = nano_statics.attention_mask
  shape = (mask.num_blocks * mask.block_size, nano.num_heads,
           nano.d_model // nano.num_heads)
  mask_t = torch.as_tensor(mask.blocks.astype(np.uint8), device=g.device)
  dense_b = dense_from_blocks(mask.blocks, g.device)
  allowed_b = int(mask.blocks.sum(dtype=np.int64))
  for dtype, atol in ((torch.float32, ATTN_F32_ATOL),
                      (torch.bfloat16, ATTN_BF16_ATOL)):
    out[('C', dtype)] = check_banded(
        shape, dtype, atol, mask_t, mask.block_size, g, dense_b, allowed_b,
        batch=MEMBER_BATCHES['nano'][0])
  del dense_b
  for preset, st in (('1deg', statics), ('nano', nano_statics)):
    for width in MEMBER_BATCH_WIDTHS:
      f = width * spec.d_model
      got = check_segment_plan(
          f'{preset} grid2mesh receivers, f = {width} x {spec.d_model}',
          st.grid2mesh.receivers, st.num_mesh_nodes, f, g, card,
          variants=False)
      for (_, dtype), result in got.items():
        out[('B', preset, width, dtype)] = result
      out[('B shape', preset, width)] = [st.grid2mesh.num_edges, f]
  log(f'[member batch] kernels A at [{members}, {plan.padded_n}, {h}, {d}] '
      f'and [{members}, {statics.num_mesh_nodes}, {h}, {d}], C at '
      f'[{MEMBER_BATCHES["nano"][0]}, {", ".join(map(str, shape))}], B at '
      f'f = {[w * spec.d_model for w in MEMBER_BATCH_WIDTHS]} on the 1-degree '
      f'and nano grid2mesh receiver plans: all within their tolerances of '
      f'their plain versions, float32 and bf16; {card}')
  return out


def member_batch_forecast(spec, statics, dev, card) -> dict:
  """Phase 44, a preset's forecast: MEMBER_BATCHES[preset] members x steps
  of `rollout.sample_rollout` on a seeded, perturbed bf16 stack (unit
  statistics), graphed: first each member alone from its (seed, m)
  generator, then all members as one batch from the same generators
  (`sample_rollout` given them as `generators`: each denoiser call
  samples every member's rows), twice, the first capturing the batch's
  graph. Each
  member bitwise its own run or within MEMBER_BATCH_RTOL (the largest
  error logged); the two batched runs bitwise equal; launches per batched
  call as derived (A or C once per layer, B once); seconds per
  member-step both ways, each graph's capture seconds and private pool,
  peak memory both ways. Returns each kernel's launches over the phase's
  runs."""
  from gencast_tpu_torch import bridge, configs, rollout
  from gencast_tpu_torch.models import wrappers
  from gencast_tpu_torch.ops import banded_attention, ln_film, segment, \
      sparse_attention
  from gencast_tpu_torch.parallel import ensemble
  t_part = time.perf_counter()
  members, steps = MEMBER_BATCHES[spec.name]
  model, _ = configs.build_gencast(spec, seed=0, statics=statics, device=dev)
  bridge.load_reference_params(model, bridge.perturbed(
      bridge.export_reference_params(model), seed=1))
  stack = wrappers.build_stack(model, unit_stats(spec.task),
                               bf16=spec.cast_bf16).to(dev)
  den = model.denoiser
  gen = torch.Generator(device=dev).manual_seed(44)
  grid = (1, statics.grid_lat.shape[0], statics.grid_lon.shape[0])
  inputs = torch.randn(grid + (den.input_layout.num_channels,),
                       generator=gen, device=dev)
  forcings = torch.randn((steps,) + grid + (den.forcing_layout.num_channels,),
                         generator=gen, device=dev)
  attn = (banded_attention.KERNEL if spec.attention_type == 'triblock_pallas'
          else sparse_attention.KERNEL)
  calls = steps * (2 * spec.num_noise_levels - 1)
  per_call = {attn.name: spec.num_layers, segment.KERNEL.name: 1,
              ln_film.KERNEL_FWD.name: ln_film_fwd_launches(model)}
  launches = {c.name: 0 for c in counters()}

  def run(**draws):
    for c in counters():
      c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = rollout.sample_rollout(stack, inputs, forcings, **draws)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for c in counters():
      launches[c.name] += c.launches
    return out, wall, {c.name: c.launches for c in counters() if c.launches}

  torch.cuda.reset_peak_memory_stats()
  own, own_s = [], []
  for key in ensemble.member_keys(44, members, device=dev):
    out, wall, _ = run(generator=key)
    own.append(out)
    own_s.append(wall)
  own = torch.stack(own)
  own_peak = torch.cuda.max_memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  batched, batched_s = [], []
  for _ in range(2):
    out, wall, got = run(
        generators=ensemble.member_keys(44, members, device=dev))
    want = {k: calls * v for k, v in per_call.items()}
    if got != want:
      raise AssertionError(f'{spec.name} member batch: launches {got}, '
                           f'expected {want} ({calls} calls of {per_call})')
    batched.append(out)
    batched_s.append(wall)
  batched_peak = torch.cuda.max_memory_allocated()
  shape = (members, steps) + grid + (den.target_layout.num_channels,)
  if not (tuple(batched[0].shape) == shape
          and bool(torch.isfinite(batched[0]).all())
          and torch.equal(batched[0], batched[1])):
    raise AssertionError(f'{spec.name} member batch: {tuple(batched[0].shape)}'
                         f' (expected {shape}), finite '
                         f'{bool(torch.isfinite(batched[0]).all())}, the two '
                         'batched runs bitwise equal '
                         f'{torch.equal(batched[0], batched[1])}')
  bitwise = [torch.equal(batched[0][m], own[m]) for m in range(members)]
  errs = [rel_err(batched[0][m], own[m])[0] for m in range(members)]
  if max(errs) > MEMBER_BATCH_RTOL:
    raise AssertionError(f'{spec.name} member batch against one-member '
                         f'runs: max rel err by member {errs} (tol '
                         f'{MEMBER_BATCH_RTOL})')
  graphs = {call.buffers[0].shape[0]: call.graph
            for call in sampler_graphs(stack)}
  one_s = float(np.mean(own_s[1:])) / steps  # member 0 captured batch 1
  batch_s = batched_s[1] / (members * steps)
  log(f'[member batch] {spec.name}: {members} members x {steps} steps, '
      f'graphed: each member against its one-member run bitwise '
      f'{sum(bitwise)} of {members}, max rel err {max(errs):.3e} (tol '
      f'{MEMBER_BATCH_RTOL}; by member {[f"{e:.2e}" for e in errs]}); '
      f'launches per batched call {per_call}, as derived; seconds per '
      f'member-step one at a time {one_s:.4f} (member 0 with the batch-1 '
      f'capture {own_s[0]:.3f} s for {steps} steps), as one batch '
      f'{batch_s:.4f} ({batched_s[0]:.3f} s with the capture, '
      f'{batched_s[1]:.3f} s replayed; {one_s / batch_s:.2f}x); graphs '
      + ', '.join(f'batch {b}: captured in {gr.capture_seconds:.2f} s, '
                  f'private pool {gr.pool_bytes / 2**30:.3f} GiB'
                  for b, gr in sorted(graphs.items()))
      + f'; peak memory one at a time {own_peak / 2**30:.2f} GiB, as one '
      f'batch {batched_peak / 2**30:.2f} GiB; part '
      f'{time.perf_counter() - t_part:.1f} s; {card}')
  return {k: v for k, v in launches.items() if v}


def quarter_deg_batch2(spec, model, stack, dev, g, card) -> None:
  """Phase 23, third part: one 0.25-degree denoiser call at batch 2 (two
  rows, each its own noise level) against two batch-1 calls of the same
  rows, through the kernels (the streamed grid2mesh chunks at a batch:
  A 16 and B 13 launches, as at batch 1): each row bitwise its own call
  or within MEMBER_BATCH_RTOL; the batch-2 call's peak memory."""
  from gencast_tpu_torch.ops import segment, sparse_attention
  den = model.denoiser
  chunks = den.architecture.grid2mesh.streams['g2m'].num_chunks
  grid = (2, den.num_lat, den.num_lon)
  inputs = torch.randn(grid + (den.input_layout.num_channels,), generator=g,
                       device=dev)
  forcings = torch.randn(grid + (den.forcing_layout.num_channels,),
                         generator=g, device=dev)
  noisy = torch.randn(grid + (den.target_layout.num_channels,), generator=g,
                      device=dev) * 3.0
  sigma = torch.tensor([3.0, 0.5], device=dev)
  with torch.no_grad():
    own = [stack(inputs[r:r + 1], noisy[r:r + 1], sigma[r:r + 1],
                 forcings[r:r + 1]) for r in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for counter in (sparse_attention.KERNEL, segment.KERNEL):
      counter.reset()
    t0 = time.perf_counter()
    both = stack(inputs, noisy, sigma, forcings)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  peak = torch.cuda.max_memory_allocated()
  launched = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
  bitwise = [torch.equal(both[r:r + 1], own[r]) for r in range(2)]
  errs = [rel_err(both[r:r + 1], own[r])[0] for r in range(2)]
  if not (launched == (spec.num_layers, chunks) and max(errs) <=
          MEMBER_BATCH_RTOL and bool(torch.isfinite(both).all())):
    raise AssertionError(f'0.25deg denoiser at batch 2: launches (A, B) '
                         f'{launched} (expected ({spec.num_layers}, '
                         f'{chunks})), rel err by row {errs} (tol '
                         f'{MEMBER_BATCH_RTOL})')
  log(f'[0.25deg denoiser] batch 2 {tuple(both.shape)} against two batch-1 '
      f'calls: bitwise {sum(bitwise)} of 2 rows, max rel err '
      f'{max(errs):.3e} (tol {MEMBER_BATCH_RTOL}); launches A {launched[0]},'
      f' B {launched[1]} (one per grid2mesh chunk, as at batch 1); '
      f'{1e3 * wall:.1f} ms eager; peak memory {peak / 2**30:.2f} GiB; {card}')


def parallel_phases(spec, statics, nano_statics, dev, g, card, stats,
                    clock) -> dict:
  """Phases 35-37 (their work under build/, removed after; `stats` is
  phase 10's 1-degree statistics file); returns each
  path's kernel launches: 'tiny_einsum' (phase 35's CLI runs), 'dp_1deg'
  and 'pod_1deg' (the ranks of phases 36 and 37)."""
  work = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'build',
                      'chip_smoke_parallel')
  shutil.rmtree(work, ignore_errors=True)
  os.makedirs(work)
  out = {}
  for phase, name, run in (
      (35, 'tiny_einsum', lambda: attention_backends(
          nano_statics, statics, dev, g, card, work)),
      (36, 'dp_1deg', lambda: data_parallel_1deg(spec, statics, dev, card,
                                                 work, stats)),
      (37, 'pod_1deg', lambda: pod_ensemble_1deg(dev, card, work))):
    out[name] = run()
    torch.cuda.empty_cache()
    clock.done(phase)
  shutil.rmtree(work, ignore_errors=True)
  return out


def main() -> int:
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device; this check runs on the card only',
          file=sys.stderr)
    return 1
  # The graph statics' on-disk cache of this run, empty at its start: each
  # configuration's statics are built once (the 0.25-degree ones in 21 s),
  # then loaded by every later phase and CLI run.
  repo = os.path.dirname(os.path.abspath(__file__))
  cache_root = os.path.join(repo, 'build', 'chip_smoke_cache')
  shutil.rmtree(cache_root, ignore_errors=True)
  os.environ['GENCAST_TPU_TORCH_CACHE'] = cache_root
  # The 1-degree synthetic source's statistics: computed and saved by phase
  # 10's training run, loaded by the later 1-degree runs on that source
  # (phases 17, 19 and 36), which each took 7-10 s to compute them.
  one_deg_stats = os.path.join(cache_root, 'stats_1deg.npz')
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.graph import plans
  from gencast_tpu_torch.nn import transformer
  from gencast_tpu_torch.ops import banded_attention, cuda_lib, ln_film, \
      segment, sparse_attention

  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  dev = torch.device('cuda', 0)
  t_start = time.perf_counter()
  clock = PhaseClock()
  card = card_line()
  results = {}

  # --- 1. setup ---
  log(f'[setup] {card}; torch {torch.__version__}, CUDA {torch.version.cuda};'
      ' TF32 off for matmul and cuDNN')
  t0 = time.perf_counter()
  cuda_lib.library()
  log(f'[setup] kernels built in {time.perf_counter() - t0:.2f} s')
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

  clock.done(1)
  # Phase 21's 0.25-degree statics, built beside phases 2-20 (CPU only).
  q_report = os.path.join(cache_root, 'quarter_statics.json')
  os.makedirs(cache_root, exist_ok=True)
  q_job = start_quarter_statics(q_report)
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

  clock.done(2)
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
  tiny = dataclasses.replace(configs.TINY_PALLAS, attention_tile_size=64,
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

  clock.done(3)
  # --- 4. kernel B vs plain: the 1-degree training step's plans ---
  segment_results = check_segment_sums(spec, statics, g, card)

  clock.done(4)
  # --- 5. denoiser: kernel path vs plain path; small forecast vs CPU ---
  model, stack, plain_stack = kernel_and_plain_stacks(spec, statics, dev,
                                                     'denoiser')

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
    check_ln_film_fwd_call(model, stack, (inputs, noisy, sigma, forcings),
                           spec.name, card)
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
  del out_k, out_p, plain_stack

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

  clock.done(5)
  # --- 6. serving: two forecast requests, then the first again eagerly ---
  calls = 2 * spec.num_noise_levels - 1
  for counter in (sparse_attention.KERNEL, segment.KERNEL):
    counter.reset()
  seconds, forecasts = [], []
  # Requests 1 and 2 replay the denoiser's CUDA graph (the first captures
  # it); request 1 again with graphed=False, the eager path, from the same
  # generator seed must give its bits.
  for seed, graphed in ((1, True), (2, True), (1, False)):
    before = (sparse_attention.KERNEL.launches, segment.KERNEL.launches)
    gen = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    forecast = stack.sample(inputs, forcings, gen, graphed=graphed)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    forecasts.append(forecast)
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
    log(f'[serve] request {seed} ({"graphed" if graphed else "eager"}): '
        f'{tuple(forecast.shape)} float32, finite; {seconds[-1]:.3f} s '
        f'({1e3 * seconds[-1] / calls:.2f} ms per denoiser call); launches '
        f'A {added[0]}, B {added[1]}')
  check_graphed_equals_eager('1-degree forecast step', forecasts[0],
                             forecasts[2])
  log(f'[serve] 1-degree forecast step: graphed {seconds[0]:.3f} s (with '
      f'the capture), {seconds[1]:.3f} s; eager {seconds[2]:.3f} s; '
      f'{graph_note(stack)}; {card}')
  serve_launches = {'A': sparse_attention.KERNEL.launches,
                    'B': segment.KERNEL.launches}
  if min(serve_launches.values()) == 0:
    raise AssertionError(f'a kernel was not launched: {serve_launches}')
  del forecasts

  clock.done(6)
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

  clock.done(7)
  # --- 8. kernel E vs plain at every shape of the training steps ---
  nano = configs.NANO
  nano_statics = configs.build_statics(nano)
  e_shapes = ln_film_shapes([(spec, statics), (nano, nano_statics)])
  e_results = check_ln_film_shapes(e_shapes, g, card)
  fwd_shapes = ln_film_fwd_shapes(e_shapes, FWD_MEMBERS)
  fwd_results = check_ln_film_fwd_shapes(fwd_shapes, g, card)
  e_seen = set()

  clock.done(8)
  # --- 9. TINY training step: card kernels vs CPU plain path ---
  for remat_policy in ('full', 'save_attention'):
    train_tiny_against_cpu(dev, remat_policy, configs.TINY_PALLAS)

  clock.done(9)
  # --- 10. training: three full-width 1-degree steps through the CLI ---
  del model, stack
  with recording_ln_film_shapes(e_seen):
    one_deg_launches, one_deg_seconds, one_deg_peak = train_preset(
        spec, statics, dev, card, ['--preset', '1deg', '--clean_sst_nans',
                                   '--stats_path', one_deg_stats])

  clock.done(10)
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

  clock.done(11)
  # --- 12. kernel D vs plain, from kernel C's lse ---
  for name, (shape, mask_t, bs, dense_b, allowed_b) in banded.items():
    for dtype, rtol in ((torch.float32, BWD_F32_RTOL),
                        (torch.bfloat16, BWD_BF16_RTOL)):
      results[('D', name, dtype)] = check_banded_bwd(
          shape, dtype, rtol, mask_t, bs, g, dense_b, allowed_b)
  del banded

  clock.done(12)
  # --- 13. nano serving: the denoiser, then two 10-step forecasts ---
  nano_call_ms = serve_nano(dev, g)

  clock.done(13)
  # --- 14. TINY tri-block training step: card kernels vs CPU plain path ---
  train_tiny_against_cpu(dev, 'full', configs.TINY_TRIBLOCK)

  clock.done(14)
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

  clock.done(15)
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

  clock.done(16)
  # --- 17. the 1-degree path with the fused backward: train, resume,
  # evaluate ---
  fused_launches = fused_path(cut_depth(spec), statics, dev, card,
                              one_deg_seconds, one_deg_peak, one_deg_stats)

  clock.done(17)
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

  clock.done(18)
  # --- 19. fused training: CUDA-graph replays against eager steps ---
  fused_nano = fused_training(['--preset', 'nano'], dev, card, k=4,
                              rounds=2, tag='nano')
  fused_1deg = fused_training(['--preset', '1deg', '--clean_sst_nans',
                               '--stats_path', one_deg_stats], dev,
                              card, k=4, rounds=2, tag='1deg')
  before = os.environ.get(transformer.FUSED_BWD_ENV)
  os.environ[transformer.FUSED_BWD_ENV] = '1'
  try:
    fused_1deg_g = fused_training(['--preset', '1deg', '--clean_sst_nans',
                                   '--stats_path', one_deg_stats],
                                  dev, card, k=2, rounds=1,
                                  tag='1deg, GENCAST_SPARSE_FUSED_BWD=1')
  finally:
    if before is None:
      del os.environ[transformer.FUSED_BWD_ENV]
    else:
      os.environ[transformer.FUSED_BWD_ENV] = before

  clock.done(19)
  # --- 20. the training CLI's fused path: checkpoints and a resume ---
  cli_launches = fused_cli(nano, nano_statics, dev, card)
  log(f'[timing] phases 1-20 in {time.perf_counter() - t_start:.1f} s')

  clock.done(20)
  # --- 21. the 0.25-degree statics, built then loaded from the cache ---
  qdeg = configs.QUARTER_DEG
  q_statics = quarter_deg_statics(qdeg, card, q_job, q_report)

  clock.done(21)
  # --- 22. kernels A, F, B and E at the 0.25-degree shapes ---
  q_model, q_stack, q_plain_stack = kernel_and_plain_stacks(
      qdeg, q_statics, dev, '0.25deg denoiser')
  q_results, q_e_results, q_e_shapes = check_quarter_deg_kernels(
      qdeg, q_statics, q_model, g, card)

  clock.done(22)
  # --- 23. the 0.25-degree denoiser, kernels vs plain; the 1-degree
  # denoiser, streamed vs dense ---
  q_inputs, q_forcings, q_call_ms = quarter_deg_denoiser(
      qdeg, q_statics, q_model, q_stack, q_plain_stack, dev, g, card)
  del q_plain_stack
  torch.cuda.empty_cache()
  quarter_deg_batch2(qdeg, q_model, q_stack, dev, g, card)
  torch.cuda.empty_cache()
  streamed_against_dense(statics, dev, g, card)

  clock.done(23)
  # --- 24. serving: one 0.25-degree forecast step, graphed and eager ---
  t0 = time.perf_counter()
  q_graphed_s, q_eager_s, q_serve_peak, q_serve_launches = serve_quarter_deg(
      qdeg, q_model, q_stack, q_inputs, q_forcings, dev, card)
  log(f'[timing] phase 24 in {time.perf_counter() - t0:.1f} s')
  del q_model, q_stack, q_inputs, q_forcings
  torch.cuda.empty_cache()

  clock.done(24)
  # --- 25. 0.25-degree training: CLI steps, twice from one seed, fused ---
  q_work = os.path.join(repo, 'build', 'chip_smoke_0.25deg')
  shutil.rmtree(q_work, ignore_errors=True)
  (q_launches, q_step_s, q_fused_s, q_train_peak, q_ckpt,
   q_stats) = train_quarter_deg(cut_depth(qdeg), q_statics, q_e_shapes, dev,
                                card, q_work)

  clock.done(25)
  # --- 26. 0.25-degree evaluate with --chunk_size 1 ---
  q_eval_wall, q_eval_peak = evaluate_quarter_deg(
      cut_depth(qdeg), dev, card, q_ckpt, q_stats, q_work)
  shutil.rmtree(q_work, ignore_errors=True)

  clock.done(26)
  # --- 27. chunked rollout at nano, the host copies overlapped or not ---
  offload_nano(dev, card)

  clock.done(27)
  # --- 28. ERA5-format corpora ---
  t0 = time.perf_counter()
  era5_work = os.path.join(repo, 'build', 'chip_smoke_era5')
  shutil.rmtree(era5_work, ignore_errors=True)
  era5_dirs, _, has_h5py = era5_corpora(era5_work, card)

  clock.done(28)
  # --- 29. nano from ERA5 through the CLI's module entry point ---
  nano_era5_launches = nano_era5_cli(cut_depth(nano), nano_statics, dev,
                                     card, era5_dirs['nano'], era5_work)

  clock.done(29)
  # --- 30. 1 degree from ERA5 in this process: train, then evaluate ---
  one_deg_era5_launches = one_deg_era5(cut_depth(spec), statics, dev, card,
                                       era5_dirs['1deg'], era5_work,
                                       has_h5py)
  shutil.rmtree(era5_work, ignore_errors=True)
  log(f'[timing] phases 28-30 in {time.perf_counter() - t0:.1f} s')

  clock.done(30)
  # --- 31. GraphCast_small's 1-degree statics; TISR; B on its plans ---
  t0 = t_phase = time.perf_counter()
  torch.cuda.reset_peak_memory_stats()
  gc_statics = graphcast_statics(spec, card)
  tisr_timing(spec, gc_statics, dev, card)
  gc_segment = check_graphcast_segment_sums(spec, gc_statics, g, card)
  log(f'[timing] phase 31 in {time.perf_counter() - t_phase:.1f} s, peak '
      f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}')

  clock.done(31)
  # --- 32. serving GraphCast_small: a step, rollouts graphed and eager ---
  t_phase = time.perf_counter()
  gc_serve = serve_graphcast(spec, gc_statics, dev, g, card)
  log(f'[timing] phase 32 in {time.perf_counter() - t_phase:.1f} s; {card}')

  clock.done(32)
  # --- 33. training GraphCast_small through the CLI, AR, graphed;
  # evaluate ---
  gc_work = os.path.join(repo, 'build', 'chip_smoke_graphcast')
  shutil.rmtree(gc_work, ignore_errors=True)
  gc_launches, gc_seconds, gc_peak = train_graphcast(cut_depth(spec),
                                                     gc_statics, dev,
                                                     card, gc_work)
  shutil.rmtree(gc_work, ignore_errors=True)

  clock.done(33)
  # --- 34. the paper's GraphCast at 0.25 degrees: serve, train ---
  gc_work = os.path.join(repo, 'build', 'chip_smoke_graphcast_0.25deg')
  shutil.rmtree(gc_work, ignore_errors=True)
  (gcq_launches, gcq_step_s, gcq_serve_s, gcq_serve_peak,
   gcq_train_peak, gcq_segment) = quarter_deg_graphcast(dev, g, card, gc_work)
  shutil.rmtree(gc_work, ignore_errors=True)
  log(f'[timing] phases 31-34 in {time.perf_counter() - t0:.1f} s')
  clock.done(34)

  # --- 35-37. the einsum attention backends; data parallel and the
  # member-sharded ensemble across ranks ---
  new_launches = parallel_phases(spec, statics, nano_statics, dev, g, card,
                                 one_deg_stats, clock)

  # --- 39. trace_sampler on the card; model FLOPs and MFU of the times
  # measured above ---
  from gencast_tpu_torch.training import flops
  fwd = flops.denoiser_forward_flops(spec, statics)
  q_fwd = flops.denoiser_forward_flops(qdeg, q_statics)
  gc_fwd, gc_cut_fwd = (
      flops.graphcast_forward_flops(gc_spec, gc_statics,
                                    task=gc_serve['task'])
      for gc_spec in (spec, cut_depth(spec)))

  def train_flops(forward):
    return flops.train_step_flops(forward).total

  calls = 2 * spec.num_noise_levels - 1
  tools_and_accounting(spec, os.path.join(repo, 'build'), card, [
      ('1deg denoiser call, in a graphed forecast step (phase 6)',
       seconds[1] / calls, fwd.total),
      ('1deg forecast step, graphed (phase 6)', seconds[1],
       flops.sampler_step_flops(fwd, spec.num_noise_levels).total),
      ('1deg training step, graphed (phase 19)', fused_1deg[1][-1],
       train_flops(fwd)),
      ('nano training step, graphed (phase 19)', fused_nano[1][-1],
       train_flops(flops.denoiser_forward_flops(nano, nano_statics))),
      ('0.25deg denoiser call, eager (phase 23)',
       q_call_ms['kernel'] / 1e3, q_fwd.total),
      (f'0.25deg training step at {CUT_LAYERS} layers, eager (phase 25)',
       q_step_s[-1], train_flops(flops.denoiser_forward_flops(
           cut_depth(qdeg), q_statics))),
      ('GraphCast_small 1deg forward, graphed (phase 32)',
       gc_serve['graphed'] / 1e3, gc_fwd.total),
      (f'GraphCast_small 1deg training step at {CUT_LAYERS} processor '
       'steps, graphed (phase 33)', gc_seconds['graphed'][-1],
       train_flops(gc_cut_fwd))])
  clock.done(39)

  # --- 40-42. the model axis (--mp): 1-degree training over two ranks
  # (with phase 42's dryrun_multichip beside its float32 run); the kernels
  # at a rank's heads and plans; the pod forecast over ensemble x model
  # and GraphCast under --mp 2 (with phases 38 and 43 beside them) ---
  work = os.path.join(repo, 'build', 'chip_smoke_model_axis')
  shutil.rmtree(work, ignore_errors=True)
  os.makedirs(work)

  @contextlib.contextmanager
  def dryrun_beside():
    t0 = time.perf_counter()
    started = start_dryrun()
    try:
      yield
    except BaseException:
      stop_ranks(started)
      raise
    new_launches['dryrun'] = finish_dryrun(started, dev, card)
    clock.beside('42 (dryrun_multichip)', 40, time.perf_counter() - t0)

  new_launches['mp_1deg'] = model_axis_1deg(spec, statics, dev, card, work,
                                            one_deg_stats, dryrun_beside)
  torch.cuda.empty_cache()
  clock.done(40)
  heads = per_rank_heads(statics, nano_statics, g, card)
  node_b = node_axis_b(spec, statics, g, card)
  clock.done(41)

  def beside_pod():
    # --- 38. a published GenCast checkpoint at 1 degree: translate in a
    # fresh process, restore, serve bitwise, evaluate; and phase 22's
    # profiler check: checks whose time is no metric, run while the pod
    # forecast's ranks run ---
    t0 = time.perf_counter()
    e_profile = start_ln_film_profile(q_e_shapes)
    pub_work = os.path.join(repo, 'build', 'chip_smoke_published')
    shutil.rmtree(pub_work, ignore_errors=True)
    os.makedirs(pub_work)
    new_launches['published_1deg'] = published_1deg(
        spec, statics, dev, card, pub_work, one_deg_stats)
    shutil.rmtree(pub_work, ignore_errors=True)
    finish_ln_film_profile(e_profile, q_e_shapes, card)
    torch.cuda.empty_cache()
    clock.beside(38, 42, time.perf_counter() - t0)

  def beside_gc():
    # --- 43. the grid-node axis at CUT_LAYERS layers: 1-degree training
    # steps and a denoiser call on two ranks with the grid nodes sharded,
    # while GraphCast's --mp 2 ranks finish ---
    t0 = time.perf_counter()
    node_work = os.path.join(repo, 'build', 'chip_smoke_node_axis')
    shutil.rmtree(node_work, ignore_errors=True)
    os.makedirs(node_work)
    new_launches['node_1deg'] = node_axis_1deg(
        cut_depth(spec), dev, card, node_work, one_deg_stats)
    shutil.rmtree(node_work, ignore_errors=True)
    torch.cuda.empty_cache()
    clock.beside(43, 42, time.perf_counter() - t0)

  new_launches.update(pod_and_graphcast_mp(spec, dev, card, work, beside_pod,
                                           beside_gc))
  shutil.rmtree(work, ignore_errors=True)
  torch.cuda.empty_cache()
  clock.done(42)

  # --- 44. ensemble members as one batch: A, C and B at the batches'
  # shapes; nano and 1-degree member batches against one-member runs ---
  member_kernels = member_batch_kernels(spec, statics, nano_statics, g, card)
  torch.cuda.empty_cache()
  for preset, preset_statics in ((nano, nano_statics), (spec, statics)):
    new_launches[f'member_batch_{preset.name}'] = member_batch_forecast(
        preset, preset_statics, dev, card)
    torch.cuda.empty_cache()
  clock.done(44)

  # Rows at the shapes of the main paths, in the dtype they run: A and F at
  # the transformer's padded 1-degree shape in bf16, B on the grid2mesh
  # receiver plan from bf16 edges (float32 out), E in bf16 at the largest
  # shape it gets (the 1-degree mesh2grid edges; the mesh-node shape, 33 of
  # its 42 calls per 1-degree step, in extra fields), C and D at nano's
  # [1, 2624, 4, 64] in bf16, G and its dq reduce as A. A, B, E and F also
  # carry their 0.25-degree figures (phase 22, bf16): A and F at the padded
  # and the ragged shape, B on the grid2mesh chunk's receiver and sender
  # plans, E at the largest chunk and at the transformer's shape.
  # Launches come from the training runs of each kernel's paths (1 degree,
  # nano, the 1-degree path with the fused backward, and 0.25 degrees), by
  # path where a kernel runs on more than one.
  bf16 = torch.bfloat16
  err_a, ms_a, cost_a = results[('A', bf16, plan.padded_n)]
  err_b, ms_b, cost_b = segment_results[('grid2mesh receivers', bf16)]
  err_e, ms_e, cost_e = e_results[
      ((statics.mesh2grid.num_edges, 1, spec.d_model), bf16)]
  fwd_e, ms_fwd, cost_fwd = fwd_results[
      ((statics.mesh2grid.num_edges, 1, spec.d_model), bf16)]
  _, ms_e_mesh, cost_e_mesh = e_results[
      ((1, plan.padded_n, spec.d_model), bf16)]
  errs_f, ms_f, costs_f = results[('F', bf16)]
  err_c, ms_c, cost_c = results[('C', 'nano', bf16)]
  errs_d, ms_d, costs_d = results[('D', 'nano', bf16)]
  errs_g, ms_g, costs_g = results[('G', bf16)]
  q_plan = q_statics.attention_tile_plan
  q_attn = (1, q_plan.padded_n, qdeg.num_heads, qdeg.d_model // qdeg.num_heads)
  q_rows = {'0.25deg_ragged': q_statics.num_mesh_nodes,
            '0.25deg': q_plan.padded_n}
  q_e_big = max(s for s, axis in q_e_shapes if axis == 1)
  # Phase 44's member batches (bf16): A at four 1-degree members, C at
  # eight nano members, B at f = 4 and 8 x 512 on both grid2mesh plans.
  b_1deg, b_nano = MEMBER_BATCHES['1deg'][0], MEMBER_BATCHES['nano'][0]
  nano_rows = nano_statics.attention_mask.num_blocks * \
      nano_statics.attention_mask.block_size
  kernels = [
      dict(row(sparse_attention.KERNEL, err_a, ms_a['kernel'], ms_a['plain'],
               ms_a['library'], *cost_a, bf16),
           **{key: quarter_deg_row(q_results[('A', bf16, rows)],
                                   q_attn[:1] + (rows,) + q_attn[2:], bf16)
              for key, rows in q_rows.items()},
           **{f'member_batch_{b_1deg}{tag}': quarter_deg_row(
               member_kernels[('A', bf16, rows)], [b_1deg, rows, h, d], bf16)
              for tag, rows in (('', plan.padded_n),
                                ('_ragged', statics.num_mesh_nodes))}),
      dict(row(segment.KERNEL, err_b, ms_b['kernel'], ms_b['plain'],
               ms_b['library'], *cost_b, bf16),
           dtype='bfloat16 in, float32 out',
           cast_then_kernel_ms=ms_b['cast_then_kernel'],
           unsplit_ms=ms_b['unsplit'],
           float32_in_ms=segment_results[('grid2mesh receivers',
                                          torch.float32)][1]['kernel'],
           **{f'0.25deg_chunk_{side}': quarter_deg_row(
               q_results[('B', bf16, side)], q_results[('B shape', side)],
               bf16) for side in ('recv', 'send')},
           **{f'graphcast_multimesh_{side}': quarter_deg_row(
               gc_segment[(f'multimesh {name}', bf16)],
               [gc_statics.multimesh_edges.num_edges, spec.d_model], bf16)
              for side, name in (('recv', 'receivers'),
                                 ('send', 'senders'))},
           **{f'graphcast_0.25deg_multimesh_{side}': quarter_deg_row(
               gcq_segment[(f'0.25deg multimesh {name}', bf16)],
               [gcq_segment['edges'], spec.d_model], bf16)
              for side, name in (('recv', 'receivers'),
                                 ('send', 'senders'))},
           **{'node_axis_' + name.replace(' ', '_'): quarter_deg_row(
               node_b[(name, bf16)], node_b[('shape', name)], bf16)
              for name, dtype in node_b
              if name != 'shape' and dtype == bf16},
           **{f'member_batch_{preset}_f{width * spec.d_model}':
              quarter_deg_row(member_kernels[('B', preset, width, bf16)],
                              member_kernels[('B shape', preset, width)],
                              bf16)
              for preset in ('1deg', 'nano')
              for width in MEMBER_BATCH_WIDTHS}),
      dict(row(banded_attention.KERNEL, err_c, ms_c['kernel'], ms_c['plain'],
               ms_c['library'], *cost_c, bf16),
           **{f'member_batch_{b_nano}': quarter_deg_row(
               member_kernels[('C', bf16)],
               [b_nano, nano_rows, nano.num_heads,
                nano.d_model // nano.num_heads], bf16)}),
      row(banded_attention.KERNEL_DQ, errs_d['dq'][1], ms_d['dq'],
          ms_d['dq_plain'], ms_d['library'], *costs_d['dq'], bf16),
      row(banded_attention.KERNEL_DKV, errs_d['dkv'][1], ms_d['dkv'],
          ms_d['dkv_plain'], ms_d['library'], *costs_d['dkv'], bf16),
      dict(row(ln_film.KERNEL, err_e[1], ms_e['kernel'], ms_e['plain'],
               ms_e['library'], *cost_e, bf16),
           mesh_shape=[1, plan.padded_n, spec.d_model],
           mesh_ms=ms_e_mesh['kernel'],
           mesh_bound_ms=bound(*cost_e_mesh, bf16)[0],
           mesh_library_ms=ms_e_mesh['library'],
           **{'0.25deg_' + ('mesh' if axis == 0 else 'chunk'): quarter_deg_row(
               (q_e_results[(shape, bf16)][0][1],)
               + q_e_results[(shape, bf16)][1:], shape, bf16)
              for shape, axis in q_e_shapes
              if axis == 0 or shape == q_e_big}),
      # No single PyTorch call computes LN+FiLM at a batch: library_ms is
      # layer_norm with the one member's scale and offset as its weight and
      # bias; the member batch and 0.25-degree entries are bf16 too.
      dict(row(ln_film.KERNEL_FWD, fwd_e['max_err'], ms_fwd['kernel'],
               ms_fwd['plain'], ms_fwd['library'], *cost_fwd, bf16),
           bitwise_share=fwd_e['bitwise_share'],
           **{f'member_batch_{FWD_MEMBERS}_' + ('mesh' if axis == 0 else
                                                'edges'): quarter_deg_row(
               (fwd_results[(shape, bf16)][0]['max_err'],)
               + fwd_results[(shape, bf16)][1:], shape, bf16)
              for shape, axis in fwd_shapes[-2:]},
           **{'0.25deg_' + ('mesh' if axis == 0 else 'chunk'): quarter_deg_row(
               (q_results[('LN+FiLM fwd', bf16, shape)][0]['max_err'],)
               + q_results[('LN+FiLM fwd', bf16, shape)][1:], shape, bf16)
              for shape, axis in q_e_shapes
              if axis == 0 or shape == q_e_big}),
      dict(row(sparse_attention.KERNEL_DQ, errs_f['dq'][1], ms_f['dq'],
               ms_f['dq_plain'], ms_f['library'], *costs_f['dq'], bf16),
           **{key: quarter_deg_f_row(q_results[('F', bf16, rows)], 'dq',
                                     q_attn[:1] + (rows,) + q_attn[2:])
              for key, rows in q_rows.items()}),
      dict(row(sparse_attention.KERNEL_DKV, errs_f['dkv'][1], ms_f['dkv'],
               ms_f['dkv_plain'], ms_f['library'], *costs_f['dkv'], bf16),
           **{key: quarter_deg_f_row(q_results[('F', bf16, rows)], 'dkv',
                                     q_attn[:1] + (rows,) + q_attn[2:])
              for key, rows in q_rows.items()}),
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
  # A, F, C and D at one rank's heads under a model axis of 2 and of 4
  # (phase 41, bf16).
  for h, key in ((2, 'mp2_rank'), (1, 'mp4_rank')):
    rows = per_rank_rows(heads[h], ([1, plan.padded_n, h, 128],
                                    [1, nano_rows, h, 64]))
    for k in kernels:
      if k['name'] in rows:
        k[key] = rows[k['name']]
  for k in kernels:
    by_path = {'1deg': one_deg_launches[k['name']],
               'nano': nano_launches[k['name']],
               '1deg_fused': fused_launches[k['name']],
               'nano_graphed': fused_nano[0][k['name']],
               '1deg_graphed': fused_1deg[0][k['name']],
               '1deg_fused_graphed': fused_1deg_g[0][k['name']],
               'nano_cli_graphed': cli_launches[k['name']],
               '0.25deg': q_launches[k['name']],
               'nano_era5': nano_era5_launches[k['name']],
               '1deg_era5': one_deg_era5_launches[k['name']],
               'graphcast_1deg': gc_launches[k['name']],
               'graphcast_0.25deg': gcq_launches[k['name']],
               **{path: counts.get(k['name'], 0)
                  for path, counts in new_launches.items()}}
    k['launches'] = sum(by_path.values())
    if sum(1 for n in by_path.values() if n) > 1:
      k['launches_by_path'] = by_path
    if k['launches'] == 0:
      raise AssertionError(f'{k["name"]} was not launched by training')
  log(f'[summary] 1-degree: seconds per request {seconds}; denoiser call '
      f'kernel path {denoiser_ms["kernel"]:.2f} ms, plain path '
      f'{denoiser_ms["plain"]:.2f} ms; nano denoiser call kernel path '
      f'{nano_call_ms:.2f} ms')
  log(f'[summary] 0.25-degree: denoiser call kernel path '
      f'{q_call_ms["kernel"]:.1f} ms, plain path {q_call_ms["plain"]:.1f} ms;'
      f' forecast step graphed {q_graphed_s:.3f} s (with the capture), eager '
      f'{q_eager_s:.3f} s, peak {q_serve_peak / 2**30:.2f} GiB; training '
      f'step {[round(x, 4) for x in q_step_s]} s, fused '
      f'{[round(x, 4) for x in q_fused_s]} s, peak '
      f'{q_train_peak / 2**30:.2f} GiB; evaluate (1 member, 2 steps) '
      f'{q_eval_wall:.1f} s, peak {q_eval_peak / 2**30:.2f} GiB; {card}')
  log(f'[summary] GraphCast_small at 1 degree: a forecast step graphed '
      f'{gc_serve["graphed"]:.2f} ms (the replay alone '
      f'{gc_serve["replay"]:.2f}), eager {gc_serve["eager"]:.2f} ms; at '
      f'{CUT_LAYERS} processor steps a training step eager '
      f'{[round(x, 4) for x in gc_seconds["eager"]]} s, '
      f'graphed {[round(x, 4) for x in gc_seconds["graphed"]]} s, AR 2 eager '
      f'{[round(x, 4) for x in gc_seconds["ar_eager"]]} s, graphed '
      f'{[round(x, 4) for x in gc_seconds["ar_graphed"]]} s, peak '
      f'{gc_peak / 2**30:.2f} GiB; graphcast_37 at 0.25 degrees: a forecast '
      f'step {gcq_serve_s["graphed, replay"]:.3f} s replayed, '
      f'{gcq_serve_s["eager"]:.3f} s eager, peak '
      f'{gcq_serve_peak / 2**30:.2f} GiB; a training step '
      f'{[round(x, 4) for x in gcq_step_s]} s, peak '
      f'{gcq_train_peak / 2**30:.2f} GiB; the run '
      f'{time.perf_counter() - t_start:.1f} s; {card}')
  shutil.rmtree(cache_root, ignore_errors=True)
  log(clock.line(card))
  print(json.dumps({'kernels': kernels}))
  print(card_line())
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  if sys.argv[1:2] == ['--profile-ln-film']:
    sys.exit(profile_ln_film_main(sys.argv[2]))
  if sys.argv[1:2] == ['--ln-film-fwd']:
    sys.exit(ln_film_fwd_main())
  if sys.argv[1:2] == ['--quarter-statics']:
    sys.exit(quarter_statics_job(sys.argv[2]))
  try:
    code = main()
  finally:
    killed = stop_processes()
    if killed:
      print(f'chip_smoke: stopped processes left running: {killed}',
            file=sys.stderr)
  sys.exit(code)
