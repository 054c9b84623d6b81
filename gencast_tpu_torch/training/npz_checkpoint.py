"""Typed dataclass-tree <-> flat npz serialization.

Counterpart of `gencast_tpu.training.npz_checkpoint`, grammar for grammar
(a file either package writes reads back equal through the other): a
(possibly nested) dataclass/dict tree is flattened to ':'-joined keys and
stored as one .npz, sequences carry a `__type__` entry and None a
`__none__` one; loading reconstructs the typed structure from annotations,
including Optional and nested dataclasses (the reference's
common/checkpoint.py). numpy only.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, BinaryIO, Optional, Type, TypeVar, Union

import numpy as np

_T = TypeVar('_T')
_SEP = ':'


def _flatten(tree: Any, prefix: str, out: dict) -> None:
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    for f in dataclasses.fields(tree):
      _flatten(getattr(tree, f.name), f'{prefix}{f.name}{_SEP}', out)
  elif isinstance(tree, dict):
    for k, v in tree.items():
      if _SEP in k:
        raise ValueError(f'dict key may not contain {_SEP!r}: {k}')
      _flatten(v, f'{prefix}{k}{_SEP}', out)
  elif isinstance(tree, (list, tuple)):
    out[prefix + '__type__'] = np.array(type(tree).__name__)
    for i, v in enumerate(tree):
      _flatten(v, f'{prefix}{i}{_SEP}', out)
  elif tree is None:
    out[prefix + '__none__'] = np.array(True)
  else:
    out[prefix.rstrip(_SEP)] = np.asarray(tree)


def dump(file: Union[str, BinaryIO], tree: Any) -> None:
  """Serializes a dataclass/dict/list tree of arrays & scalars to npz."""
  flat = {}
  _flatten(tree, '', flat)
  np.savez(file, **flat)


def _strip_optional(t):
  origin = typing.get_origin(t)
  if origin is Union:
    args = [a for a in typing.get_args(t) if a is not type(None)]
    if len(args) == 1:
      return args[0], True
  return t, False


def _unflatten(flat: dict, prefix: str, target_type: Optional[Type] = None):
  if prefix + '__none__' in flat:
    return None
  direct = prefix.rstrip(_SEP)
  if direct in flat:
    v = flat[direct]
    if target_type in (int, float, bool, str):
      return target_type(v.item() if v.ndim == 0 else v)
    if v.ndim == 0 and v.dtype.kind in 'USO':
      return v.item()
    return v

  if target_type is not None:
    target_type, _ = _strip_optional(target_type)

  children = {}
  for key in flat:
    if key.startswith(prefix) and len(key) > len(prefix):
      child = key[len(prefix):].split(_SEP, 1)[0]
      children.setdefault(child, None)
  children.pop('__type__', None)

  if target_type is not None and dataclasses.is_dataclass(target_type):
    hints = typing.get_type_hints(target_type)
    kwargs = {f.name: _unflatten(flat, f'{prefix}{f.name}{_SEP}',
                                 hints.get(f.name))
              for f in dataclasses.fields(target_type)}
    return target_type(**kwargs)

  seq_type = flat.get(prefix + '__type__')
  if seq_type is not None:
    n = len(children)
    items = [_unflatten(flat, f'{prefix}{i}{_SEP}') for i in range(n)]
    return tuple(items) if seq_type.item() == 'tuple' else items

  if target_type is not None:
    origin = typing.get_origin(target_type)
    if origin in (tuple, list):
      args = typing.get_args(target_type)
      elem = args[0] if args and args[-1] is Ellipsis else None
      n = len(children)
      items = [_unflatten(flat, f'{prefix}{i}{_SEP}', elem)
               for i in range(n)]
      return tuple(items) if origin is tuple else items

  return {k: _unflatten(flat, f'{prefix}{k}{_SEP}') for k in
          sorted(children)}


def load(file: Union[str, BinaryIO], target_type: Type[_T] = dict) -> _T:
  """Loads an npz written by `dump`, reconstructing `target_type`."""
  with np.load(file, allow_pickle=False) as z:
    flat = {k: z[k] for k in z.files}
  return _unflatten(flat, '', None if target_type is dict else target_type)
