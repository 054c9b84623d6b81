"""Checkpoint translation: reference param trees -> the denoiser's state.

Counterpart of `gencast_tpu.training.translate` (numpy only; its output is
the JAX package's nested state layout, which `bridge.load_reference_params`
carries into the port's modules once flattened with '/'). Maps the
reference implementation's NNX state structure (fgiral000/gencast-flax-nnx:
DeepTypedGraphNet / sparse Transformer / Denoiser module nesting) onto the
denoiser's modules, handling the structural differences:

* Sequential-with-activations layer indices (0, 2, ...) -> dense (0, 1, ...)
* EdgeWrapper/NodeWrapper/graph_network nesting -> flat edge_mlps/node_mlps
* norm_conditioning_layer.conditional_linear_layer -> film.linear
* per-block transformer modules -> stacked [num_layers, ...] params
* the reference's zero "dummy data" channels in the grid2mesh mesh-node
  embedder -> sliced away (they contribute nothing)
* node/edge set names: grid_nodes->grid, mesh_nodes->mesh, grid2mesh->g2m,
  mesh2grid->m2g

Nodes of the input tree may be keyed by int or str (a tree read from an
npz has str keys throughout).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

NODE_NAMES = {'grid_nodes': 'grid', 'mesh_nodes': 'mesh'}
EDGE_NAMES = {'grid2mesh': 'g2m', 'mesh2grid': 'm2g', 'mesh': 'mesh'}
# The mesh-node embedder's structural input rows the denoiser keeps (the
# rest of the reference's rows are its zero dummy data).
NUM_STRUCT_FEATURES = 3


def _seq_layers(ref_mlp_network: Mapping) -> Dict:
  """nnx.Sequential layer dict {0: lin, 2: lin, ...} -> {0: lin, 1: lin}."""
  layers = ref_mlp_network['layers']
  keys = sorted(int(k) for k in layers.keys())
  return {str(i): layers[str(k)] if str(k) in layers else layers[k]
          for i, k in enumerate(keys)}


def _get(d: Mapping, *names):
  for n in names:
    if n in d:
      return d[n]
    if isinstance(n, int) and str(n) in d:
      return d[str(n)]
  raise KeyError(f'none of {names} in {list(d.keys())}')


def _slice_kernel_rows(mlp_state: Dict, keep_rows: int) -> Dict:
  """Drops trailing input rows of the FIRST linear's kernel (the
  reference's always-zero dummy-data channels)."""
  out = dict(mlp_state)
  first = dict(out['layers']['0'])
  first['kernel'] = np.asarray(first['kernel'])[:keep_rows]
  layers = dict(out['layers'])
  layers['0'] = first
  out['layers'] = layers
  return out


def cond_mlp(ref: Mapping, keep_input_rows: Optional[int] = None) -> Dict:
  """Reference MLPWithNormConditioning -> my CondMLP pure-dict state."""
  out = {'network': {'layers': _seq_layers(ref['network']['network'])}}
  if 'norm_conditioning_layer' in ref:
    out['film'] = {
        'linear': ref['norm_conditioning_layer']['conditional_linear_layer']}
  if 'layer_norm' in ref and ref['layer_norm']:
    out['layer_norm'] = ref['layer_norm']
  if keep_input_rows is not None:
    out['network'] = _slice_kernel_rows(out['network'], keep_input_rows)
  return out


def plain_mlp(ref: Mapping) -> Dict:
  """Reference MLPWithNormConditioning (no LN) -> my plain MLP state."""
  return {'layers': _seq_layers(ref['network']['network'])}


def typed_graph_net(ref: Mapping, *, mesh_embedder_keep_rows=None) -> Dict:
  """Reference DeepTypedGraphNet -> my TypedGraphNet pure-dict state."""
  out: Dict = {}
  emb = ref.get('embedder_network', {})
  if emb.get('embed_node_fns'):
    out['node_embedders'] = {}
    for ref_name, fn in emb['embed_node_fns'].items():
      keep = (mesh_embedder_keep_rows if ref_name == 'mesh_nodes' else None)
      out['node_embedders'][NODE_NAMES[ref_name]] = cond_mlp(
          fn, keep_input_rows=keep)
  if emb.get('embed_edge_fns'):
    out['edge_embedders'] = {
        EDGE_NAMES[k]: cond_mlp(v) for k, v in emb['embed_edge_fns'].items()}

  out['processors'] = {}
  procs = ref['processor_networks']
  for i in sorted(procs.keys(), key=int) if isinstance(procs, dict) else \
      range(len(procs)):
    p = procs[i] if not isinstance(procs, dict) else procs[i]
    gn = p['graph_network']
    out['processors'][str(i)] = {
        'edge_mlps': {EDGE_NAMES[k]: cond_mlp(v['edge_fn'])
                      for k, v in gn['update_edge_fns'].items()},
        'node_mlps': {NODE_NAMES[k]: cond_mlp(v['node_fn'])
                      for k, v in gn['update_node_fns'].items()},
    }

  dec = ref.get('decoder_network', {})
  if dec.get('embed_node_fns'):
    out['node_decoders'] = {
        NODE_NAMES[k]: plain_mlp(v)
        for k, v in dec['embed_node_fns'].items()}
  return out


def _stack_trees(trees):
  """Stacks the leaves of identically structured dict trees on a new
  leading axis, visiting the keys of the first tree in order (what
  jax.tree.map(np.stack) gives on dicts, keys sorted or not)."""
  first = trees[0]
  if isinstance(first, Mapping):
    if any(t.keys() != first.keys() for t in trees[1:]):
      raise ValueError(f'blocks differ in structure: '
                       f'{[sorted(map(str, t)) for t in trees]}')
    return {k: _stack_trees([t[k] for t in trees]) for k in first}
  return np.stack([np.asarray(t) for t in trees])


def transformer(ref: Mapping) -> Dict:
  """Reference sparse Transformer -> my MeshTransformer state, per-block
  parameters stacked into [num_layers, ...]."""
  rblocks = ref['blocks']
  order = sorted(rblocks.keys(), key=int) if isinstance(rblocks, dict) \
      else range(len(rblocks))
  blocks = [rblocks[k] for k in order]

  def block_state(b):
    ffw_layers = _seq_layers(b['ffw_module']['mlp'])
    return {
        'attn': {'proj': {
            'q': _get(b['attn_module'], 'q_proj')['linear'],
            'k': _get(b['attn_module'], 'k_proj')['linear'],
            'v': _get(b['attn_module'], 'v_proj')['linear'],
            'out': _get(b['attn_module'], 'final_linear'),
        }},
        'ffw': {'lin1': ffw_layers['0'], 'lin2': ffw_layers['1']},
        'film1': {'linear':
                  b['norm_cond_attn']['conditional_linear_layer']},
        'film2': {'linear':
                  b['norm_cond_ffw']['conditional_linear_layer']},
    }

  return {
      'blocks': _stack_trees([block_state(b) for b in blocks]),
      'final_film': {'linear':
                     ref['final_norm_cond']['conditional_linear_layer']},
  }


def gencast_denoiser(ref: Mapping) -> Dict:
  """Reference Denoiser (noise encoder + DenoiserArchitecture) -> my
  Denoiser pure-dict state."""
  enc = ref['noise_level_encoder']
  lin_keys = sorted([k for k in enc if str(k).startswith('linear_')],
                    key=lambda k: int(str(k).split('_')[1]))
  if lin_keys:
    linears = {str(i): enc[k] for i, k in enumerate(lin_keys)}
  else:
    linears = enc['linears']
  arch = ref['predictor']
  return {
      'noise_encoder': {'linears': linears},
      'architecture': {
          'grid2mesh': typed_graph_net(
              arch['grid2mesh_gnn'],
              mesh_embedder_keep_rows=NUM_STRUCT_FEATURES),
          'processor': transformer(
              arch['mesh_gnn']['batch_first_transformer']),
          'mesh2grid': typed_graph_net(arch['mesh2grid_gnn']),
      },
  }


def merge_into(target: Dict, translated: Mapping, path=()) -> None:
  """Recursively writes translated leaves into a pure-dict state in place,
  asserting shape agreement; leaves missing from `translated` are kept."""
  for k, v in translated.items():
    k = str(k)
    if k not in target:
      if k.isdigit() and int(k) in target:
        k = int(k)
      else:
        raise KeyError(
            f'translated key not in target: {"/".join(path)}/{k} '
            f'(target keys: {list(target.keys())})')
    if isinstance(v, Mapping):
      merge_into(target[k], v, path + (str(k),))
    else:
      t = target[k]
      v = np.asarray(v)
      if hasattr(t, 'shape') and tuple(t.shape) != tuple(v.shape):
        raise ValueError(
            f'shape mismatch at {"/".join(path)+"/"+k}: '
            f'target {t.shape} vs translated {v.shape}')
      target[k] = v
