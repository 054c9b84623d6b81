"""Published-GenCast checkpoint ingestion (the DeepMind `CheckPoint` npz).

Counterpart of `gencast_tpu.training.deepmind_checkpoint` (numpy only). The
published GenCast weights ship as a single npz holding a flattened
`CheckPoint` dataclass tree (the reference's gencast/gencast.py CheckPoint,
serialized by its common/checkpoint.py): nested dicts/dataclasses are
flattened into npz entry names joined with ':' — e.g.
`params:<module path>:<leaf>`, `sampler_config:max_noise_level`. This
module reads and writes that container and maps its `params` tree onto the
denoiser's state in the reference's layout:

* container: `:`-joined flat npz  <->  nested dict tree (load/save);
* leaf dialects: Haiku-era leaf names (w/b/offset) are normalized to the
  NNX names (kernel/bias) translate.py expects, and flat Haiku module
  paths ("a/b/c": {w,b}) are nested;
* structure: the nested params tree goes through translate.gencast_denoiser,
  whose output `bridge.load_reference_params` carries into the port's
  modules (tools/translate_checkpoint.py).

Scalar config fields (task/sampler/noise configs) are exposed as plain
dict trees for callers to compare with the port's presets.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

SEP = ':'

# Haiku-era leaf names -> flax/NNX leaf names. Haiku Linear kernels are
# [in, out] like flax's, so renaming is the whole translation.
_LEAF_RENAMES = {'w': 'kernel', 'b': 'bias', 'offset': 'bias'}


def flatten_tree(tree: Mapping[str, Any],
                 prefix: str = '') -> Dict[str, Any]:
  """Nested dict tree -> {'a:b:c': leaf} (the published flattening)."""
  out: Dict[str, Any] = {}
  for k, v in tree.items():
    k = str(k)
    assert SEP not in k, k
    key = f'{prefix}{SEP}{k}' if prefix else k
    if isinstance(v, Mapping):
      out.update(flatten_tree(v, key))
    elif isinstance(v, (list, tuple)):
      out.update(flatten_tree(dict(enumerate(v)), key))
    else:
      out[key] = v
  return out


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
  """{'a:b:c': leaf} -> nested dicts (list/tuple nodes stay int-keyed
  dicts — translate.py's accessors handle both)."""
  tree: Dict[str, Any] = {}
  for key, v in flat.items():
    node = tree
    parts = key.split(SEP)
    for p in parts[:-1]:
      node = node.setdefault(p, {})
    node[parts[-1]] = v
  return tree


def save(path: str, tree: Mapping[str, Any]) -> None:
  """Writes a CheckPoint-schema npz (tree must already be dict-shaped:
  {'description': ..., 'license': ..., 'params': {...}, ...})."""
  np.savez(path, **flatten_tree(tree))


def is_checkpoint_npz(path: str) -> bool:
  """True if the npz at `path` is a flattened CheckPoint container."""
  try:
    with np.load(path, allow_pickle=False) as z:
      return any(k == 'params' or k.startswith('params' + SEP)
                 for k in z.files)
  except Exception:  # noqa: BLE001 - not an npz at all
    return False


def load(path: str) -> Dict[str, Any]:
  """Reads a CheckPoint-schema npz into a nested dict tree.

  0-d string/bytes arrays (description, license, str config fields) are
  unwrapped to Python scalars; numeric 0-d arrays stay arrays so exact
  dtypes survive round-trips.
  """
  with np.load(path, allow_pickle=False) as z:
    flat = {k: z[k] for k in z.files}
  for k, v in flat.items():
    if isinstance(v, np.ndarray) and v.ndim == 0 and v.dtype.kind in 'US':
      flat[k] = str(v)
  return unflatten_tree(flat)


def _is_leaf_dict(d: Mapping) -> bool:
  return all(not isinstance(v, Mapping) for v in d.values())


def normalize_params(params: Mapping[str, Any]) -> Dict[str, Any]:
  """Normalizes a CheckPoint params tree to the NNX naming translate.py
  consumes: nests flat Haiku module paths ('mod/sub/linear_0': {w, b})
  and renames Haiku leaf names to kernel/bias."""
  # Flat Haiku dialect: top-level keys are '/'-joined module paths.
  if any('/' in str(k) for k in params.keys()):
    nested: Dict[str, Any] = {}
    for path, leaves in params.items():
      node = nested
      for p in str(path).split('/'):
        if p == '~':  # haiku's anonymous scope separator carries no info
          continue
        node = node.setdefault(p, {})
      node.update(leaves if isinstance(leaves, Mapping) else {'w': leaves})
    params = nested

  def rename(tree):
    if not isinstance(tree, Mapping):
      return tree
    out = {}
    for k, v in tree.items():
      k = str(k)
      if not isinstance(v, Mapping) and k in _LEAF_RENAMES:
        k = _LEAF_RENAMES[k]
      out[k] = rename(v)
    return out

  return rename(params)


def find_denoiser(params: Mapping[str, Any]) -> Mapping[str, Any]:
  """Locates the denoiser subtree inside wrapper nesting (the published
  GenCast params wrap it in the predictor chain)."""
  node = params
  for _ in range(6):
    if 'noise_level_encoder' in node:  # already the denoiser itself
      return node
    for key in ('denoiser', 'predictor', 'model', 'gen_cast', 'gencast'):
      if key in node and isinstance(node[key], Mapping):
        node = node[key]
        break
    else:
      break
  if 'noise_level_encoder' in node:
    return node
  raise KeyError(
      f'could not locate denoiser params; top-level keys: '
      f'{sorted(map(str, params.keys()))[:10]}')


def denoiser_state(tree: Mapping[str, Any]) -> Dict[str, Any]:
  """CheckPoint tree -> the denoiser's nested state in the reference's
  layout (ready for translate.merge_into)."""
  from gencast_tpu_torch.training import translate
  params = normalize_params(tree['params'])
  return translate.gencast_denoiser(find_denoiser(params))


def config_tree(tree: Mapping[str, Any], name: str) -> Dict[str, Any]:
  """Returns a config sub-dataclass as {field: python scalar}."""
  out = {}
  for k, v in tree.get(name, {}).items():
    if isinstance(v, np.ndarray) and v.ndim == 0:
      v = v.item()
    out[str(k)] = v
  return out
