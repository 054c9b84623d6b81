"""Translate a published or reference GenCast checkpoint into a checkpoint
of the port.

Counterpart of `tools/translate_checkpoint.py`. Reads either:
  * a DeepMind `CheckPoint` npz (the published GenCast weights: flattened
    ':'-keyed container, Haiku-era leaf names, nested or flat 'a/b/c'
    module paths; training/deepmind_checkpoint.py), or
  * a reference typed-npz tree (the reference's common/checkpoint.py
    format; training/npz_checkpoint.py), its `params` where present,

translates the denoiser's parameters (training/translate.py), merges them
into the parameters of a freshly built model of the preset
(`bridge.export_reference_params`: leaves the translation does not name
keep the model's values, a translated key the model lacks raises, as does
a shape mismatch), loads them strictly (`bridge.load_reference_params`)
and writes `--out`/step_0.pt with training/checkpoint.py, parameters only,
named as the wrapper stack of the training and evaluate CLIs with the same
flags (`train.build_spec`, `train.build_wrapped`). A reference orbax
directory is refused: reading one needs orbax, which imports jax.

The tool takes the evaluate CLI's model flags, so pass the ones evaluate
will get (`--preset`, `--clean_sst_nans`, `--bf16`, the architecture
overrides); `--data` and `--stats_path` change no parameter and are
ignored. It prints the file's sampler, noise and architecture configs
beside the preset's and refuses none of them.

Examples:
  # On the CPU at TINY:
  python -m gencast_tpu_torch.tools.translate_checkpoint --ref X.npz \
      --preset tiny --device cpu --out /path/to/ckpt
  python -m gencast_tpu_torch.training.evaluate --preset tiny --device cpu \
      --ckpt_dir /path/to/ckpt --stats_path /path/to/netcdf_stats

  # Published GenCast 1 degree, served on the card:
  python -m gencast_tpu_torch.tools.translate_checkpoint --ref X.npz \
      --preset 1deg --clean_sst_nans --out /path/to/ckpt
  python -m gencast_tpu_torch.training.evaluate --preset 1deg \
      --clean_sst_nans --ckpt_dir /path/to/ckpt \
      --stats_path /path/to/netcdf_stats
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Mapping, Tuple

import numpy as np

# The CheckPoint's config fields the tool prints beside the preset's.
_CONFIGS = ('sampler_config', 'noise_config', 'denoiser_architecture_config')


def parse_args(argv=None):
  from gencast_tpu_torch.training import train
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--ref', required=True,
                 help='a DeepMind CheckPoint npz or a reference typed-npz '
                      'tree (an orbax directory is refused)')
  p.add_argument('--out', required=True,
                 help='checkpoint directory; step_0.pt is written there')
  train.add_model_flags(p)
  args = p.parse_args(argv)
  train.check_model_flags(p, args)
  if args.model != 'gencast':
    p.error('--model: a GenCast checkpoint translates into GenCast only')
  return args


def find_denoiser_subtree(tree: Mapping) -> Mapping:
  """Locates the reference GenCast denoiser state inside possible wrapper
  nesting (NaNCleaner/InputsAndResiduals store the model under
  'predictor'; evaluation-time trees may be wrapped once more)."""
  node = tree
  for _ in range(6):
    if 'denoiser' in node:
      return node['denoiser']
    if 'predictor' in node:
      node = node['predictor']
      continue
    if 'model' in node:
      node = node['model']
      continue
    break
  raise KeyError(f'could not locate denoiser in tree: {list(tree.keys())}')


def _scalars(tree: Mapping) -> dict:
  """`tree` with its 0-d arrays, at any depth, as Python scalars."""
  return {k: _scalars(v) if isinstance(v, Mapping)
          else v.item() if isinstance(v, np.ndarray) and v.ndim == 0 else v
          for k, v in tree.items()}


def read_reference(path: str) -> Tuple[Mapping, Dict[str, dict]]:
  """(the reference denoiser's nested state with NNX leaf names, the
  CheckPoint's configs by name) of the file at `path`."""
  from gencast_tpu_torch.training import deepmind_checkpoint as dm_ckpt
  from gencast_tpu_torch.training import npz_checkpoint

  if os.path.isdir(path):
    raise SystemExit(
        f'--ref {path} is a directory: a reference orbax checkpoint needs '
        'orbax, which imports jax, and the port runs without jax. Write its '
        'parameters as a typed npz tree (the reference\'s '
        'common/checkpoint.py dump, or '
        'gencast_tpu_torch.training.npz_checkpoint.dump) and pass that file')
  if not path.endswith('.npz'):
    raise SystemExit(f'--ref {path}: expected a .npz file')
  if dm_ckpt.is_checkpoint_npz(path):
    tree = dm_ckpt.load(path)
    denoiser = dm_ckpt.find_denoiser(dm_ckpt.normalize_params(tree['params']))
    configs = {name: _scalars(dm_ckpt.config_tree(tree, name))
               for name in _CONFIGS if name in tree}
    return denoiser, configs
  tree = npz_checkpoint.load(path)
  if 'params' in tree:
    tree = tree['params']
  return find_denoiser_subtree(tree), {}


def nest(flat: Mapping[str, np.ndarray]) -> dict:
  """{'a/b/c': leaf} -> nested dicts."""
  tree: dict = {}
  for key, value in flat.items():
    *path, leaf = key.split('/')
    node = tree
    for p in path:
      node = node.setdefault(p, {})
    node[leaf] = value
  return tree


def flatten(tree: Mapping, prefix: str = '') -> Dict[str, np.ndarray]:
  """The inverse of `nest`."""
  out = {}
  for k, v in tree.items():
    key = f'{prefix}/{k}' if prefix else str(k)
    if isinstance(v, Mapping):
      out.update(flatten(v, key))
    else:
      out[key] = v
  return out


def merged_params(model, denoiser_tree: Mapping
                  ) -> Tuple[Dict[str, np.ndarray], int]:
  """The model's parameters in the reference's flat layout with the
  translated denoiser merged in (translate.merge_into), and the number of
  leaves the translation named."""
  from gencast_tpu_torch import bridge
  from gencast_tpu_torch.training import translate
  translated = {'denoiser': translate.gencast_denoiser(denoiser_tree)}
  target = nest(bridge.export_reference_params(model))
  translate.merge_into(target, translated)
  return flatten(target), len(flatten(translated))


def preset_configs(model, spec) -> Dict[str, dict]:
  """The preset's values under the CheckPoint's config names."""
  return {
      'sampler_config': dataclasses.asdict(model.sampler_config),
      'noise_config': dataclasses.asdict(model.noise_config),
      'denoiser_architecture_config': {
          'mesh_size': spec.mesh_splits, 'latent_size': spec.d_model,
          'hidden_layers': spec.hidden_layers,
          'sparse_transformer_config': {
              'd_model': spec.d_model, 'num_layers': spec.num_layers,
              'num_heads': spec.num_heads, 'ffw_hidden': spec.ffw_hidden,
              'attention_k_hop': spec.attention_k_hop}},
  }


def main(argv=None) -> str:
  """Translates; returns the path of the checkpoint written."""
  args = parse_args(argv)
  from gencast_tpu_torch import bridge, configs
  from gencast_tpu_torch.data import layout
  from gencast_tpu_torch.training import checkpoint as ckpt_lib
  from gencast_tpu_torch.training import train

  t0 = time.perf_counter()
  denoiser_tree, file_configs = read_reference(args.ref)
  print(f'[translate] read {args.ref} '
        f'({os.path.getsize(args.ref) / 2**20:.1f} MiB) in '
        f'{time.perf_counter() - t0:.1f} s', flush=True)
  device = train.select_device(args.device)
  spec = train.build_spec(args)
  model, _ = configs.build_gencast(spec, seed=args.seed, device=device)
  preset = preset_configs(model, spec)
  for name, values in file_configs.items():
    print(f'[translate] {name}: file {values}; preset {spec.name} '
          f'{preset[name]}', flush=True)
  flat, named = merged_params(model, denoiser_tree)
  bridge.load_reference_params(model, flat)
  print(f'[translate] {named} of {len(flat)} parameter arrays translated, '
        f'{len(flat) - named} kept from the seeded model', flush=True)
  task = model.task
  stats = layout.Stats.unit(
      sorted(set(task.input_variables + task.target_variables
                 + task.forcing_variables)), task.pressure_levels)
  wrapped = train.build_wrapped(args, spec, model, stats, device, 'translate')
  manager = ckpt_lib.create_manager(args.out)
  ckpt_lib.save(manager, 0, wrapped)
  path = os.path.join(manager.directory, 'step_0.pt')
  print(f'[translate] translated checkpoint written to {path} in '
        f'{time.perf_counter() - t0:.1f} s', flush=True)
  return path


if __name__ == '__main__':
  main()
