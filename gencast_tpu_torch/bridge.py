"""Carries parameters between the reference package and the port.

The reference's parameters travel as a flat `{path: np.ndarray}` dict whose
keys are its state paths joined by '/', e.g.
`denoiser/architecture/grid2mesh/node_embedders/grid/network/layers/0/kernel`
(the caller builds it from `nnx.state(model, nnx.Param)`; this module never
imports jax). The port's modules mirror those paths, so the mapping is:

* `kernel` [in, out] -> `weight` [out, in] (transposed); `bias` -> `bias`;
* the transformer's stacked layer axis (`processor/blocks/...`, leading axis
  L) -> one `processor.blocks.{i}....` parameter per layer.

Loading is strict: a reference key with no port parameter, a port parameter
left unloaded, or a shape mismatch raises.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

_STACKED = 'processor/blocks/'
_LEAVES = {'kernel': 'weight', 'bias': 'bias'}


def _port_entries(key: str, value: np.ndarray
                  ) -> Iterator[Tuple[str, np.ndarray]]:
  """(port parameter name, value in the port's layout) for one reference
  entry."""
  prefix, leaf = key.rsplit('/', 1)
  if leaf not in _LEAVES:
    raise KeyError(f'reference parameter {key!r}: unknown leaf {leaf!r}')
  name = _LEAVES[leaf]

  def convert(a):
    return np.swapaxes(a, -1, -2) if leaf == 'kernel' else a

  if _STACKED in key:
    head, tail = prefix.split(_STACKED)
    for i in range(value.shape[0]):
      yield (f'{head}{_STACKED}{i}/{tail}/{name}'.replace('/', '.'),
             convert(value[i]))
  else:
    yield f'{prefix}/{name}'.replace('/', '.'), convert(value)


def load_reference_params(model: nn.Module,
                          flat: Mapping[str, np.ndarray]) -> None:
  """Copies the reference's flat parameters into `model` (strict)."""
  params = dict(model.named_parameters())
  loaded = set()
  with torch.no_grad():
    for key, value in flat.items():
      for name, array in _port_entries(key, np.asarray(value)):
        if name not in params:
          raise KeyError(f'reference parameter {key!r} has no port '
                         f'counterpart {name!r}')
        p = params[name]
        if tuple(p.shape) != array.shape:
          raise ValueError(f'{name}: port shape {tuple(p.shape)}, reference '
                           f'{array.shape} (from {key!r})')
        p.copy_(torch.as_tensor(np.ascontiguousarray(array), dtype=p.dtype))
        loaded.add(name)
  missing = sorted(set(params) - loaded)
  if missing:
    raise KeyError(f'port parameters not loaded: {missing[:5]}'
                   f'{" ..." if len(missing) > 5 else ""}')


def _export(named: Iterator[Tuple[str, torch.Tensor]]
            ) -> Dict[str, np.ndarray]:
  flat: Dict[str, np.ndarray] = {}
  stacked: Dict[str, Dict[int, np.ndarray]] = {}
  for name, p in named:
    path = name.replace('.', '/')
    prefix, leaf = path.rsplit('/', 1)
    key_leaf = {v: k for k, v in _LEAVES.items()}[leaf]
    a = p.detach().float().cpu().numpy().copy()  # not a view of p
    if key_leaf == 'kernel':
      a = np.swapaxes(a, -1, -2)
    if _STACKED in path:
      head, tail = prefix.split(_STACKED)
      index, rest = tail.split('/', 1)
      key = f'{head}{_STACKED}{rest}/{key_leaf}'
      stacked.setdefault(key, {})[int(index)] = a
    else:
      flat[f'{prefix}/{key_leaf}'] = a
  for key, layers in stacked.items():
    flat[key] = np.stack([layers[i] for i in range(len(layers))])
  return flat


def export_reference_params(model: nn.Module) -> Dict[str, np.ndarray]:
  """The inverse of load_reference_params: the port's parameters as a flat
  dict in the reference's keys and layouts (float32 numpy)."""
  return _export(model.named_parameters())


def export_reference_grads(model: nn.Module) -> Dict[str, np.ndarray]:
  """The port's parameter gradients (`.grad`, zeros where None) in the
  reference's keys and layouts, to hold them against the reference's
  gradients of the same loss."""
  return _export((name, p.grad if p.grad is not None else torch.zeros_like(p))
                 for name, p in model.named_parameters())


def perturbed(flat: Mapping[str, np.ndarray], seed: int
              ) -> Dict[str, np.ndarray]:
  """Every parameter plus seeded normal noise scaled by 1/sqrt(fan_in) of
  its layer (keys in the reference's layout).

  A freshly initialized GenCast has zero attention and feed-forward output
  projections and FiLM weights of ~1e-8, which would hide any error in the
  attention path; comparisons run on perturbed weights.
  """
  rng = np.random.default_rng(seed)
  out = {}
  for key in sorted(flat):
    a = np.asarray(flat[key])
    fan_in = flat[key.rsplit('/', 1)[0] + '/kernel'].shape[-2]
    out[key] = (a + rng.standard_normal(a.shape) / np.sqrt(fan_in)
                ).astype(a.dtype)
  return out
