"""The system under test: gencast_tpu_torch, built from a configuration file.

The only module of the benchmark's library that imports the program. It
turns a configuration into the program's `ModelSpec` and task, builds the
model through `configs.build_gencast`, puts the benchmark's weights into
its float32 masters and wraps it as the training and evaluation CLIs do
(`wrappers.build_stack`: bf16 compute where the configuration says so,
SST's missing values filled, normalization with residuals). Graph statics
and kernels are built in, and loaded from, the checkout's build directory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import torch

_SPEC_KEYS = ('resolution_deg', 'mesh_splits', 'd_model', 'num_layers',
              'num_heads', 'attention_k_hop', 'attention_type',
              'attention_tile_size', 'ffw_hidden', 'hidden_layers',
              'radius_query_fraction_edge_length', 'noise_basis_dtype',
              'edge_chunk_size', 'use_agg_plans', 'agg_plan_min_degree',
              'cast_bf16', 'remat_policy', 'remat_gnns')


def spec(config: dict):
  """The program's ModelSpec of `config`."""
  from gencast_tpu_torch import configs
  from gencast_tpu_torch.data import registry
  task = registry.TaskSpec(
      input_variables=tuple(config['input_variables']),
      target_variables=tuple(config['target_variables']),
      forcing_variables=tuple(config['forcing_variables']),
      pressure_levels=tuple(config['pressure_levels']),
      num_input_frames=config['num_input_frames'])
  s = config['sampler']
  return configs.ModelSpec(
      name=config['name'], task=task,
      stochastic_churn_rate=s['stochastic_churn_rate'],
      num_noise_levels=s['num_noise_levels'],
      **{k: config[k] for k in _SPEC_KEYS})


def sampler_config(config: dict):
  """The program's SamplerConfig of `config` (for the check that the
  program runs the configuration's schedule)."""
  from gencast_tpu_torch.models.gencast import SamplerConfig
  s = dict(config['sampler'])
  if s['churn_max_noise_level'] is None:
    s['churn_max_noise_level'] = math.inf
  return SamplerConfig(**s)


@dataclasses.dataclass
class Program:
  model: torch.nn.Module    # the unwrapped GenCast
  stack: torch.nn.Module    # the wrapper stack the CLIs build


def build(config: dict, device) -> Program:
  from gencast_tpu_torch import configs
  model, _ = configs.build_gencast(spec(config), device=device)
  if model.sampler_config != sampler_config(config):
    raise ValueError(f'the program samples with {model.sampler_config}, the '
                     f'configuration states {config["sampler"]}')
  return Program(model=model, stack=None)


def shapes(p: Program) -> List[Tuple[str, Tuple[int, ...]]]:
  return [(n, tuple(t.shape)) for n, t in p.model.named_parameters()]


def load(p: Program, weights: Dict[str, torch.Tensor], stats: dict,
         config: dict) -> None:
  """The weights into the masters, then the wrapper stack around them
  (its bf16 serving copy is made from the masters as they are now)."""
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.models import wrappers
  with torch.no_grad():
    for n, t in p.model.named_parameters():
      t.copy_(weights[n])
  st = layout.Stats(mean=stats['mean'], std=stats['std'],
                    diffs_std=stats['diffs_std'])
  p.stack = wrappers.build_stack(
      p.model, st, bf16=config['cast_bf16'],
      clean_sst_nans=config.get('fill_nans_of') == 'sea_surface_temperature'
  ).to(next(p.model.parameters()).device)


def model_name(name: str) -> str:
  """The GenCast-level name of a parameter named in the wrapper stack
  (each wrapper holds the next as `predictor`)."""
  while name.startswith('predictor.'):
    name = name[len('predictor.'):]
  return name
