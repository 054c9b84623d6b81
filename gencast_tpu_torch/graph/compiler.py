"""The graph compiler: one-time host-side construction of all static arrays.

Counterpart of `gencast_tpu.graph.compiler`: the RCM-permuted icosahedral
mesh, the grid2mesh / mesh / mesh2grid edge sets (sorted by receiver) with
their spatial features, and the k-hop attention mask, as a tri-block
`BandedMask` (the tri-block backend) and/or a block-sparse `TilePlan` (the
block-sparse backend), and for GraphCast the multimesh: the edges of every
refinement level over the finest level's vertices. As in the reference, a
build can be cached on disk, keyed by what it is built from (`cache_dir`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
from typing import Optional

import numpy as np
from scipy import sparse

from gencast_tpu_torch.graph import connectivity, features, icosahedron
from gencast_tpu_torch.graph.plans import TilePlan, build_tile_plan


@dataclasses.dataclass(frozen=True)
class EdgeSet:
  """A static directed edge set with precomputed features, sorted by
  receiver (stable, preserving the construction order among ties)."""
  senders: np.ndarray    # [E] int32, into the sender node set
  receivers: np.ndarray  # [E] int32, into the receiver node set, ascending
  features: np.ndarray   # [E, 4] float32

  @property
  def num_edges(self) -> int:
    return self.senders.shape[0]


@dataclasses.dataclass(frozen=True)
class BandedMask:
  """Tri-block-diagonal attention mask for the RCM-banded mesh.

  blocks: [3, num_blocks, block, block] bool: the diagonal, super-diagonal
    and sub-diagonal blocks of the k-hop adjacency (nodes padded to a
    multiple of `block_size`).
  """
  blocks: np.ndarray
  block_size: int
  num_padding_nodes: int

  @property
  def num_blocks(self) -> int:
    return self.blocks.shape[1]


@dataclasses.dataclass(frozen=True)
class GraphStatics:
  """Everything static about the model's graphs. All numpy, host-resident."""
  # Mesh (RCM-permuted).
  mesh_vertices: np.ndarray      # [M, 3]
  mesh_faces: np.ndarray         # [F, 3]
  mesh_lat: np.ndarray           # [M] degrees
  mesh_lon: np.ndarray           # [M] degrees
  mesh_node_features: np.ndarray  # [M, 3]
  # Grid.
  grid_lat: np.ndarray           # [num_lat] degrees
  grid_lon: np.ndarray           # [num_lon] degrees
  grid_node_features: np.ndarray  # [G, 3], G = num_lat * num_lon
  # Edge sets.
  grid2mesh: EdgeSet             # senders: grid, receivers: mesh
  mesh_edges: EdgeSet            # senders/receivers: mesh (finest level)
  mesh2grid: EdgeSet             # senders: mesh, receivers: grid
  attention_k_hop: int
  # Tri-block attention mask; None unless built with build_triblock_mask.
  attention_mask: Optional[BandedMask] = None
  # Block-sparse attention tile plan; None unless attention_tile_size > 0.
  attention_tile_plan: Optional[TilePlan] = None
  # GraphCast's multimesh: the edges of every refinement level (vertices
  # of the finest mesh, RCM-permuted as it); None unless built with
  # build_multimesh.
  multimesh_edges: Optional[EdgeSet] = None

  @property
  def num_mesh_nodes(self) -> int:
    return self.mesh_vertices.shape[0]

  @property
  def num_grid_nodes(self) -> int:
    return self.grid_lat.shape[0] * self.grid_lon.shape[0]


def rcm_permute(mesh: icosahedron.TriMesh):
  """Reverse-Cuthill-McKee permutation of mesh vertices to banded adjacency.
  Returns (permuted_mesh, inverse_permutation)."""
  senders, receivers = icosahedron.faces_to_edges(mesh.faces)
  n = mesh.num_vertices
  adj = sparse.csr_matrix(
      (np.ones_like(senders, dtype=np.int8), (senders, receivers)),
      shape=(n, n))
  perm = sparse.csgraph.reverse_cuthill_mckee(adj, symmetric_mode=True)
  inverse = np.empty(n, dtype=np.int64)
  inverse[perm] = np.arange(n)
  permuted = icosahedron.TriMesh(vertices=mesh.vertices[perm],
                                 faces=inverse[mesh.faces].astype(np.int32))
  return permuted, inverse


def _sorted_edge_set(senders: np.ndarray, receivers: np.ndarray,
                     feats: np.ndarray) -> EdgeSet:
  order = np.argsort(receivers, kind='stable')
  return EdgeSet(senders=senders[order].astype(np.int32),
                 receivers=receivers[order].astype(np.int32),
                 features=feats[order])


def khop_mask_csr(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, k_hop: int) -> sparse.csr_matrix:
  """Boolean k-hop reachability (adjacency + self loops, k-th power)."""
  adj = sparse.csr_matrix(
      (np.ones_like(senders, dtype=bool), (senders, receivers)),
      shape=(num_nodes, num_nodes))
  adj = (adj + sparse.identity(num_nodes, dtype=bool, format='csr')
         ).astype(bool)
  # Self loops make adj^k monotone in k, so exponentiation by squaring
  # computes the k-hop closure in O(log k) boolean matmuls.
  power = adj
  result = None
  k = k_hop
  while k:
    if k & 1:
      result = power if result is None else (result @ power).astype(bool)
    k >>= 1
    if k:
      power = (power @ power).astype(bool)
  result.eliminate_zeros()
  return result.tocsr()


# The tri-block mask's block size is rounded up to a multiple of this: the
# reference's TPU tiling choice, kept so the arrays equal the reference's.
BLOCK_SIZE_MULTIPLE = 8


def banded_mask_from_csr(mask: sparse.csr_matrix) -> BandedMask:
  """Packs a banded boolean mask into tri-block-diagonal blocks.

  The block size is the bandwidth plus one, rounded up to a multiple of
  BLOCK_SIZE_MULTIPLE; every nonzero then lands in the diagonal, super- or
  sub-diagonal block. Blocks past the mesh (block 0's lower and the last
  block's upper neighbour, padding rows) stay all False.
  """
  num_nodes = mask.shape[0]
  coo = mask.tocoo()
  block_size = int(np.abs(coo.row - coo.col).max()) + 1
  block_size = -(-block_size // BLOCK_SIZE_MULTIPLE) * BLOCK_SIZE_MULTIPLE
  num_pad = (-num_nodes) % block_size
  num_blocks = (num_nodes + num_pad) // block_size

  csr = mask.tocsr()
  blocks = np.zeros((3, num_blocks, block_size, block_size), dtype=bool)
  # Column offset of each part relative to the query block: diagonal,
  # upper (next block), lower (previous block).
  for part, shift in ((0, 0), (1, block_size), (2, -block_size)):
    for b in range(num_blocks):
      r0, r1 = b * block_size, min((b + 1) * block_size, num_nodes)
      c0 = b * block_size + shift
      c0c, c1c = max(c0, 0), min(c0 + block_size, num_nodes)
      if r0 >= num_nodes or c0c >= c1c:
        continue
      window = csr[r0:r1, c0c:c1c].toarray()
      blocks[part, b, :r1 - r0, c0c - c0:c1c - c0] = window
  return BandedMask(blocks=blocks, block_size=block_size,
                    num_padding_nodes=num_pad)


# Bumped whenever the statics' content or layout changes for the same
# arguments, so that an older cache file is not read.
CACHE_VERSION = 1


def _cache_key(**kwargs) -> str:
  blob = pickle.dumps(sorted(kwargs.items()))
  return hashlib.sha256(blob).hexdigest()[:16]


def build_graph_statics(
    mesh_splits: int,
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    radius_query_fraction_edge_length: float = 0.6,
    attention_k_hop: int = 16,
    attention_tile_size: int = 0,
    build_triblock_mask: bool = False,
    build_multimesh: bool = False,
    cache_dir: Optional[str] = None,
) -> GraphStatics:
  """Compiles all static graph structure for a (mesh, grid) pair.

  Args:
    mesh_splits: icosahedron refinement level (5 -> 10242 mesh nodes).
    grid_lat: latitude values in degrees, ascending.
    grid_lon: longitude values in degrees.
    radius_query_fraction_edge_length: grid2mesh connectivity radius as a
      fraction of the longest mesh edge.
    attention_k_hop: neighborhood hops for the mesh attention mask.
    attention_tile_size: tile of the block-sparse attention plan; 0 skips
      the plan.
    build_triblock_mask: build the tri-block mask (`BandedMask`) that the
      'triblock_pallas' attention backend reads.
    build_multimesh: build GraphCast's multimesh (`multimesh_edges`).
    cache_dir: directory of the on-disk cache; None builds without it. A
      build is stored under a key of every argument above, written to a
      temporary file and renamed into place, so a reader never sees a
      partial file.
  """
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)

  cache_path = None
  if cache_dir is not None:
    key = _cache_key(splits=mesh_splits, lat=grid_lat.tobytes(),
                     lon=grid_lon.tobytes(),
                     frac=radius_query_fraction_edge_length,
                     k_hop=attention_k_hop, tile=attention_tile_size,
                     triblock=build_triblock_mask, multimesh=build_multimesh,
                     v=CACHE_VERSION)
    cache_path = os.path.join(cache_dir, f'graph_{key}.pkl')
    if os.path.exists(cache_path):
      with open(cache_path, 'rb') as f:
        return pickle.load(f)

  hierarchy = icosahedron.mesh_hierarchy(mesh_splits)
  # One permutation for the finest mesh and the multimesh's merged faces.
  mesh, inv_perm = rcm_permute(hierarchy[-1])
  mesh_phi, mesh_theta = features.xyz_to_spherical(mesh.vertices)
  mesh_lat, mesh_lon = features.spherical_to_lat_lon(mesh_phi, mesh_theta)
  mesh_lat = mesh_lat.astype(np.float32)
  mesh_lon = mesh_lon.astype(np.float32)

  grid_mesh_lon, grid_mesh_lat = np.meshgrid(grid_lon, grid_lat)
  grid_nodes_lat = grid_mesh_lat.reshape(-1).astype(np.float32)
  grid_nodes_lon = grid_mesh_lon.reshape(-1).astype(np.float32)

  senders_m, receivers_m = icosahedron.faces_to_edges(mesh.faces)
  max_edge_len = float(np.linalg.norm(
      mesh.vertices[senders_m] - mesh.vertices[receivers_m], axis=-1).max())
  radius = max_edge_len * radius_query_fraction_edge_length

  # --- grid2mesh ---
  g2m_grid, g2m_mesh = connectivity.radius_query(grid_lat, grid_lon, mesh,
                                                 radius)
  g2m_feats = features.edge_features(
      grid_nodes_lat, grid_nodes_lon, g2m_grid,
      mesh_lat, mesh_lon, g2m_mesh).features

  # --- mesh ---
  mesh_feats = features.edge_features(
      mesh_lat, mesh_lon, senders_m, mesh_lat, mesh_lon, receivers_m).features

  # --- mesh2grid ---
  m2g_grid, m2g_mesh = connectivity.containing_triangle_edges(
      grid_lat, grid_lon, mesh)
  m2g_feats = features.edge_features(
      mesh_lat, mesh_lon, m2g_mesh,
      grid_nodes_lat, grid_nodes_lon, m2g_grid).features

  mask = tile_plan = None
  if attention_tile_size or build_triblock_mask:
    csr = khop_mask_csr(senders_m, receivers_m, mesh.num_vertices,
                        attention_k_hop)
    if build_triblock_mask:
      mask = banded_mask_from_csr(csr)
    if attention_tile_size:
      tile_plan = build_tile_plan(csr, tile=attention_tile_size)

  multimesh = None
  if build_multimesh:
    merged = icosahedron.merge_hierarchy(hierarchy)
    mm_s, mm_r = icosahedron.faces_to_edges(
        inv_perm[merged.faces].astype(np.int32))
    mm_feats = features.edge_features(
        mesh_lat, mesh_lon, mm_s, mesh_lat, mesh_lon, mm_r).features
    multimesh = _sorted_edge_set(mm_s, mm_r, mm_feats)

  statics = GraphStatics(
      mesh_vertices=mesh.vertices.astype(np.float32),
      mesh_faces=mesh.faces,
      mesh_lat=mesh_lat,
      mesh_lon=mesh_lon,
      mesh_node_features=features.node_features(mesh_lat, mesh_lon),
      grid_lat=grid_lat,
      grid_lon=grid_lon,
      grid_node_features=features.node_features(grid_nodes_lat,
                                                grid_nodes_lon),
      grid2mesh=_sorted_edge_set(g2m_grid, g2m_mesh, g2m_feats),
      mesh_edges=_sorted_edge_set(senders_m, receivers_m, mesh_feats),
      mesh2grid=_sorted_edge_set(m2g_mesh, m2g_grid, m2g_feats),
      attention_k_hop=attention_k_hop,
      attention_mask=mask,
      attention_tile_plan=tile_plan,
      multimesh_edges=multimesh,
  )
  if cache_path is not None:
    os.makedirs(cache_dir, exist_ok=True)
    # One temporary name per process: builds of one key may race.
    tmp = f'{cache_path}.{os.getpid()}.tmp'
    with open(tmp, 'wb') as f:
      pickle.dump(statics, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, cache_path)
  return statics
