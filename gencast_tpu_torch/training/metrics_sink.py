"""Training metrics sinks: JSONL file and optional wandb.

A copy of `gencast_tpu.training.metrics_sink` (the port imports nothing of
the JAX package): one JSON line per event with the same keys ('event',
'step', 'time' and the values), and wandb only when the package is there;
without it `--wandb` degrades to a warning, as in the reference.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsSink:
  """Appends metric events as JSON lines; optionally mirrors to wandb."""

  def __init__(self, jsonl_path: Optional[str] = None,
               use_wandb: bool = False, wandb_project: str = 'gencast_tpu',
               run_config: Optional[dict] = None):
    self._file = None
    if jsonl_path:
      parent = os.path.dirname(jsonl_path)
      if parent:
        os.makedirs(parent, exist_ok=True)
      self._file = open(jsonl_path, 'a')
    self._wandb = None
    if use_wandb:
      # Broad except: in air-gapped environments wandb.init fails with
      # network/auth errors, not ImportError; either way training must
      # not die at startup over a logging sink.
      try:
        import wandb  # type: ignore
        wandb.init(project=wandb_project, config=run_config or {})
        self._wandb = wandb
      except Exception as e:  # pylint: disable=broad-except
        print(f'[metrics] wandb unavailable ({type(e).__name__}: {e}); '
              'logging to JSONL/stdout only')

  def log(self, event: str, step: int, **values):
    record = {'event': event, 'step': step, 'time': time.time(), **values}
    if self._file is not None:
      self._file.write(json.dumps(record) + '\n')
      self._file.flush()
    if self._wandb is not None:
      self._wandb.log({f'{event}/{k}': v for k, v in values.items()},
                      step=step)

  def log_image(self, event: str, step: int, name: str, path: str):
    """Mirrors an image file (e.g. an eval triptych PNG) to wandb; the
    JSONL record keeps only the path. Reference role: training-time
    triptych logging (reference training/train_helpers.py:366-391)."""
    if self._file is not None:
      self._file.write(json.dumps(
          {'event': event, 'step': step, 'time': time.time(),
           'image': name, 'path': path}) + '\n')
      self._file.flush()
    if self._wandb is not None:
      self._wandb.log({f'{event}/{name}': self._wandb.Image(path)},
                      step=step)

  def close(self):
    if self._file is not None:
      self._file.close()
      self._file = None
    if self._wandb is not None:
      self._wandb.finish()
