"""What the per-layer metric files compute, from the traced window.

Each reader takes the run's `Context` and returns a number, or None where
the cell gives it nothing to read (a forecast metric in a training cell,
a kernel the window never launched). A share of a roofline or of the
peak is never 0 for want of data: it is then left out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from perfbench.lib import families, flops, roofline
from perfbench.lib.trace import Trace


@dataclasses.dataclass
class Context:
  cell: Any                    # the traffic's Cell
  trace: Optional[Trace]
  peak_bytes: int
  graph: Any = None            # the reference's graph statics

  def of(self, kind: str) -> bool:
    return self.cell.kind == kind and self.trace is not None


def idle_share(ctx: Context, kind: str) -> Optional[float]:
  if not ctx.of(kind):
    return None
  return ctx.trace.idle_share()


def peak_mem_gib(ctx: Context, kind: str) -> Optional[float]:
  if ctx.cell.kind != kind or ctx.peak_bytes <= 0:
    return None
  return ctx.peak_bytes / 2 ** 30


def mfu(ctx: Context, kind: str) -> Optional[float]:
  """Model FLOPs of the traced window's whole requests or steps over its
  wall, over the bf16 peak."""
  if not ctx.of(kind) or ctx.trace.units == 0:
    return None
  work = ctx.cell.flops_per_unit(ctx.graph) * ctx.trace.units
  peak = flops.H100_SXM_BF16_DENSE_PEAK_FLOPS
  return 100.0 * work / ctx.trace.wall_s / peak


def attn_roofline(ctx: Context, kind: str) -> Optional[float]:
  """Sum over the block-sparse attention launches of the least time each
  could take, over their device time."""
  if not ctx.of(kind):
    return None
  shapes = ctx.cell.attention_launch(ctx.graph)
  launches = ctx.trace.launches()
  bound = spent = 0.0
  for name, seconds in ctx.trace.device_seconds().items():
    fam = families.family(name)
    if fam not in shapes:
      continue
    ops, moved = roofline.attention_costs(**shapes[fam])[fam]
    bound += launches[name] * roofline.bound_s(ops, moved)
    spent += seconds
  return 100.0 * bound / spent if spent > 0 else None


def elementwise_share(ctx: Context, kind: str) -> Optional[float]:
  if not ctx.of(kind):
    return None
  fam = ctx.trace.family_seconds()
  total = sum(fam.values())
  return 100.0 * fam.get('elementwise', 0.0) / total if total > 0 else None
