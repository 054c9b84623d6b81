"""The graph compiler: one-time host-side construction of all static arrays.

Counterpart of `gencast_tpu.graph.compiler` for the port's serving path:
the RCM-permuted icosahedral mesh, the grid2mesh / mesh / mesh2grid edge
sets (sorted by receiver) with their spatial features, and the k-hop
attention mask as a block-sparse `TilePlan`. The tri-block mask and the
GraphCast multimesh are not built here (the block-sparse attention backend
needs neither), and there is no on-disk cache.
"""

from __future__ import annotations

import dataclasses
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
  # Block-sparse attention tile plan; None unless attention_tile_size > 0.
  attention_tile_plan: Optional[TilePlan] = None

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


def build_graph_statics(
    mesh_splits: int,
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    radius_query_fraction_edge_length: float = 0.6,
    attention_k_hop: int = 16,
    attention_tile_size: int = 0,
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
      the mask and plan.
  """
  grid_lat = np.asarray(grid_lat, dtype=np.float32)
  grid_lon = np.asarray(grid_lon, dtype=np.float32)

  mesh, _ = rcm_permute(icosahedron.finest_mesh(mesh_splits))
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

  tile_plan = None
  if attention_tile_size:
    csr = khop_mask_csr(senders_m, receivers_m, mesh.num_vertices,
                        attention_k_hop)
    tile_plan = build_tile_plan(csr, tile=attention_tile_size)

  return GraphStatics(
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
      attention_tile_plan=tile_plan,
  )
