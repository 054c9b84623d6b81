"""Grid <-> mesh connectivity queries (host-side, one-time at model build).

Replaces the reference's scipy-cKDTree radius query and trimesh
containing-triangle query (reference common/grid_mesh_connectivity.py:40-133)
with self-contained implementations: trimesh is not a dependency here; the
containing-triangle search uses a KD-tree over face centroids plus exact
spherical-triangle containment tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import spatial

from gencast_tpu_torch.graph.icosahedron import TriMesh


def grid_lat_lon_to_xyz(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
  """Unit-sphere positions for a lat x lon grid, shape [num_lat, num_lon, 3].

  Row-major over (lat, lon): flattening gives grid node index
  `i_lat * num_lon + i_lon`, the node ordering used throughout.
  """
  phi, theta = np.meshgrid(np.deg2rad(lon_deg), np.deg2rad(90.0 - lat_deg))
  return np.stack([np.cos(phi) * np.sin(theta),
                   np.sin(phi) * np.sin(theta),
                   np.cos(theta)], axis=-1)


def radius_query(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriMesh,
    radius: float,
) -> Tuple[np.ndarray, np.ndarray]:
  """grid2mesh edges: all (grid, mesh-vertex) pairs within `radius` in R^3.

  Returns (grid_indices, mesh_indices), each [num_edges], grid indices into
  the flattened [num_lat * num_lon] grid. Edge order: ascending grid index,
  and for each grid node the KD-tree's neighbor order — matching the
  reference's edge enumeration (grid_mesh_connectivity.py:74-86).
  """
  grid_xyz = grid_lat_lon_to_xyz(grid_lat, grid_lon).reshape(-1, 3)
  tree = spatial.cKDTree(mesh.vertices)
  neighbors = tree.query_ball_point(x=grid_xyz, r=radius)
  grid_idx = np.concatenate([
      np.full(len(nbrs), g, dtype=np.int64) for g, nbrs in enumerate(neighbors)
  ])
  mesh_idx = np.concatenate([
      np.asarray(nbrs, dtype=np.int64) for nbrs in neighbors
  ])
  return grid_idx, mesh_idx


def containing_triangle(
    points: np.ndarray,
    mesh: TriMesh,
    num_candidates: int = 16,
    use_native: bool = True,
) -> np.ndarray:
  """Index of the spherical triangle of `mesh` containing each unit point.

  For each query point, checks the faces whose centroids are nearest
  (KD-tree over centroids), using the signed-volume test
  det([v_i, v_j, p]) >= 0 for all directed edges of a CCW face. Points
  exactly on shared edges/vertices resolve to whichever candidate passes
  first with the largest margin. Falls back to doubling the candidate count
  for any point not strictly inside a candidate.

  Returns [num_points] int64 face indices.
  """
  if use_native:
    # C++ spatial-hash implementation (graph/_native); ~20x faster at the
    # 0.25-degree scale. Falls through to numpy when unavailable.
    from gencast_tpu_torch.graph import native
    result = native.containing_triangle(points, mesh.vertices, mesh.faces)
    if result is not None:
      return result

  verts = mesh.vertices.astype(np.float64)
  faces = mesh.faces
  v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
  centroids = (v0 + v1 + v2) / 3.0
  centroids /= np.linalg.norm(centroids, axis=-1, keepdims=True)
  tree = spatial.cKDTree(centroids)

  pts = points.astype(np.float64)
  n = pts.shape[0]
  result = np.full(n, -1, dtype=np.int64)
  remaining = np.arange(n)
  k = min(num_candidates, faces.shape[0])

  # Precompute edge normals n_e = v_i x v_j; p inside iff dot(n_e, p) >= 0
  # for all three directed edges of a CCW (outward-oriented) face.
  n01 = np.cross(v0, v1)
  n12 = np.cross(v1, v2)
  n20 = np.cross(v2, v0)

  while remaining.size:
    p = pts[remaining]
    _, cand = tree.query(p, k=k)
    if k == 1:
      cand = cand[:, None]
    # margins [points, k]: min over the three half-space tests.
    m = np.minimum(
        np.einsum('pkd,pd->pk', n01[cand], p),
        np.minimum(np.einsum('pkd,pd->pk', n12[cand], p),
                   np.einsum('pkd,pd->pk', n20[cand], p)))
    best = np.argmax(m, axis=1)
    best_margin = m[np.arange(m.shape[0]), best]
    ok = best_margin >= -1e-12
    result[remaining[ok]] = cand[np.arange(cand.shape[0]), best][ok]
    remaining = remaining[~ok]
    if remaining.size:
      if k >= faces.shape[0]:
        # Numerical corner case: accept the best candidate anyway.
        result[remaining] = cand[np.arange(cand.shape[0]), best][~ok]
        break
      k = min(k * 4, faces.shape[0])
  return result


def containing_triangle_edges(
    grid_lat: np.ndarray,
    grid_lon: np.ndarray,
    mesh: TriMesh,
) -> Tuple[np.ndarray, np.ndarray]:
  """mesh2grid edges: each grid node connects to the 3 vertices of its
  containing face. Returns (grid_indices, mesh_indices), each
  [num_grid_nodes * 3], ordered by grid node then face-vertex order —
  the reference's enumeration (grid_mesh_connectivity.py:89-133).
  """
  grid_xyz = grid_lat_lon_to_xyz(grid_lat, grid_lon).reshape(-1, 3)
  face_idx = containing_triangle(grid_xyz, mesh)
  mesh_idx = mesh.faces[face_idx].astype(np.int64).reshape(-1)
  grid_idx = np.repeat(np.arange(grid_xyz.shape[0], dtype=np.int64), 3)
  return grid_idx, mesh_idx
