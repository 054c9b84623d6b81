"""Graph statics of the plain reference: a frozen copy of the graph code.

The icosahedral mesh (subdivided `splits` times, reverse-Cuthill-McKee
ordered), the grid2mesh radius edges, the mesh2grid containing-triangle
edges, their spatial features, the node features and the k-hop attention
mask, built in numpy and scipy from the configuration alone. It follows the
published GenCast graph (Price et al. 2024; DeepMind's graphcast package:
icosahedral_mesh.py, grid_mesh_connectivity.py, model_utils.py) and keeps
the edge order and features of the program's graph compiler, so that the
edges that meet at a node are summed in the same order. No tile plan, no
aggregation plan and no stream chunk: the reference reads the mask and the
edge lists as they are.

The containing-triangle query runs a frozen copy of the graph compiler's
C++ helper (`_native/containing_triangle.cpp`), compiled with g++ with the
same flags into the checkout's build directory: on a face boundary the face it
picks depends on how its sums round, and a grid node wired to other mesh
nodes would change the whole forecast. Where the helper cannot be built or
fails, the graph is not built at all. Built statics are cached as npz
files in the checkout (`cache_dir`), keyed by what they are built from.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import json
import os
import subprocess
from typing import Tuple

import numpy as np
from scipy import sparse, spatial

_ICOSAHEDRON_FACES = (
    (0, 1, 2), (0, 6, 1), (8, 0, 2), (8, 4, 0), (3, 8, 2),
    (3, 2, 7), (7, 2, 1), (0, 4, 6), (4, 11, 6), (6, 11, 5),
    (1, 5, 7), (4, 10, 11), (4, 8, 10), (10, 8, 3), (10, 3, 9),
    (11, 10, 9), (11, 9, 5), (5, 9, 7), (9, 3, 7), (1, 6, 5),
)


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
  """The regular icosahedron (vertices [12, 3], faces [20, 3]), one vertex
  at each pole after a rotation about y."""
  phi = (1.0 + np.sqrt(5.0)) / 2.0
  verts = []
  for c1 in (1.0, -1.0):
    for c2 in (phi, -phi):
      verts.append((c1, c2, 0.0))
      verts.append((0.0, c1, c2))
      verts.append((c2, 0.0, c1))
  verts = np.array(verts, dtype=np.float32)
  verts /= np.linalg.norm([1.0, phi])
  angle_between_faces = 2.0 * np.arcsin(phi / np.sqrt(3.0))
  rot = (np.pi - angle_between_faces) / 2.0
  c, s = np.cos(rot), np.sin(rot)
  rot_mat = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
  verts = verts @ rot_mat
  return (verts.astype(np.float32),
          np.array(_ICOSAHEDRON_FACES, dtype=np.int32))


def subdivide(vertices: np.ndarray, faces: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
  """Each face split in 4; midpoints projected to the sphere, shared by
  the faces that meet at an edge, appended in order of first use."""
  verts = list(vertices)
  index = {}

  def midpoint(a: int, b: int) -> int:
    key = (a, b) if a < b else (b, a)
    i = index.get(key)
    if i is None:
      p = (vertices[a] + vertices[b]) / 2.0
      p = p / np.linalg.norm(p)
      i = len(verts)
      verts.append(p)
      index[key] = i
    return i

  out = []
  for i1, i2, i3 in faces:
    m12, m23, m31 = midpoint(i1, i2), midpoint(i2, i3), midpoint(i3, i1)
    out.extend([(i1, m12, m31), (m12, i2, m23), (m31, m23, i3),
                (m12, m23, m31)])
  return np.array(verts), np.array(out, dtype=np.int32)


def faces_to_edges(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Directed edges a->b, b->c, c->a of every face, all first edges, then
  all second, then all third."""
  senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
  receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
  return senders, receivers


def rcm_permute(vertices: np.ndarray, faces: np.ndarray):
  """Reverse-Cuthill-McKee order of the mesh's vertices."""
  s, r = faces_to_edges(faces)
  n = vertices.shape[0]
  adj = sparse.csr_matrix((np.ones_like(s, dtype=np.int8), (s, r)),
                          shape=(n, n))
  perm = sparse.csgraph.reverse_cuthill_mckee(adj, symmetric_mode=True)
  inverse = np.empty(n, dtype=np.int64)
  inverse[perm] = np.arange(n)
  return vertices[perm], inverse[faces].astype(np.int32)


def lat_lon_to_spherical(lat, lon):
  return np.deg2rad(lon), np.deg2rad(90.0 - lat)


def spherical_to_xyz(phi, theta):
  return np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta),
                   np.cos(theta)], axis=-1)


def _rot_z(a):
  c, s = np.cos(a), np.sin(a)
  z, o = np.zeros_like(a), np.ones_like(a)
  return np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                   np.stack([z, z, o], -1)], -2)


def _rot_y(a):
  c, s = np.cos(a), np.sin(a)
  z, o = np.zeros_like(a), np.ones_like(a)
  return np.stack([np.stack([c, z, s], -1), np.stack([z, o, z], -1),
                   np.stack([-s, z, c], -1)], -2)


def node_features(lat, lon) -> np.ndarray:
  """(sin lat, cos lon, sin lon) per node."""
  phi, theta = lat_lon_to_spherical(lat, lon)
  return np.stack([np.cos(theta), np.cos(phi), np.sin(phi)],
                  axis=-1).astype(np.float32)


def edge_features(s_lat, s_lon, senders, r_lat, r_lon, receivers
                  ) -> np.ndarray:
  """(|d|, d) / max |d|, with d the sender minus the receiver in a frame
  rotated so that the receiver lies at latitude 0, longitude 0."""
  s_phi, s_theta = lat_lon_to_spherical(s_lat, s_lon)
  r_phi, r_theta = lat_lon_to_spherical(r_lat, r_lon)
  s_pos = spherical_to_xyz(s_phi, s_theta)
  r_pos = spherical_to_xyz(r_phi, r_theta)
  rot = (_rot_y(np.pi / 2.0 - r_theta) @ _rot_z(-r_phi))[receivers]
  rel = (np.einsum('eij,ej->ei', rot, s_pos[senders])
         - np.einsum('eij,ej->ei', rot, r_pos[receivers]))
  length = np.linalg.norm(rel, axis=-1, keepdims=True)
  feats = np.concatenate([length, rel], axis=-1) / float(length.max())
  return feats.astype(np.float32)


def grid_xyz(lat, lon) -> np.ndarray:
  """[lat * lon, 3] unit vectors, row-major over (lat, lon)."""
  phi, theta = np.meshgrid(np.deg2rad(lon), np.deg2rad(90.0 - lat))
  return np.stack([np.cos(phi) * np.sin(theta), np.sin(phi) * np.sin(theta),
                   np.cos(theta)], axis=-1).reshape(-1, 3)


_NATIVE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              '_native', 'containing_triangle.cpp')
# The helper's flags, tried in order (not every toolchain has OpenMP).
_NATIVE_FLAGS = (('-O3', '-march=native', '-fPIC', '-fopenmp'),
                 ('-O3', '-fPIC'))


def _native_library(build_dir: str):
  """The compiled helper, built on first use."""
  with open(_NATIVE_SOURCE, 'rb') as f:
    digest = hashlib.sha256(f.read()).hexdigest()[:16]
  errors = []
  for flags in _NATIVE_FLAGS:
    out = os.path.join(build_dir, f'containing_triangle_{digest}_'
                       f'{len(flags)}.so')
    if not os.path.exists(out):
      os.makedirs(build_dir, exist_ok=True)
      obj, tmp = f'{out}.{os.getpid()}.o', f'{out}.{os.getpid()}.tmp'
      try:
        subprocess.run(['g++', *flags, '-c', _NATIVE_SOURCE, '-o', obj],
                       check=True, capture_output=True)
        subprocess.run(['g++', '-shared', *flags, '-o', tmp, obj],
                       check=True, capture_output=True)
      except (subprocess.CalledProcessError, FileNotFoundError) as e:
        errors.append(f'{" ".join(flags)}: {e}')
        continue
      finally:
        if os.path.exists(obj):
          os.remove(obj)
      os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    lib.gt_containing_triangle.restype = ctypes.c_int
    lib.gt_containing_triangle.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int64)]
    return lib
  raise RuntimeError('the containing-triangle helper did not build: '
                     + '; '.join(errors))


def containing_triangle(points, vertices, faces, build_dir: str
                        ) -> np.ndarray:
  """The face of each unit point, by the frozen C++ helper."""
  lib = _native_library(build_dir)
  pts = np.ascontiguousarray(points, dtype=np.float64)
  verts = np.ascontiguousarray(vertices, dtype=np.float64)
  fcs = np.ascontiguousarray(faces, dtype=np.int32)
  out = np.empty(pts.shape[0], dtype=np.int64)
  v = verts[fcs]
  cell = max(float(np.max(v.max(axis=1) - v.min(axis=1))) * 1.1, 1e-3)
  ptr = ctypes.POINTER
  rc = lib.gt_containing_triangle(
      pts.ctypes.data_as(ptr(ctypes.c_double)), pts.shape[0],
      verts.ctypes.data_as(ptr(ctypes.c_double)), verts.shape[0],
      fcs.ctypes.data_as(ptr(ctypes.c_int32)), fcs.shape[0], cell,
      out.ctypes.data_as(ptr(ctypes.c_int64)))
  if rc != 0 or (out < 0).any():
    raise RuntimeError(f'the containing-triangle helper failed (rc {rc}, '
                       f'{int((out < 0).sum())} points without a face)')
  return out


@dataclasses.dataclass(frozen=True)
class Edges:
  senders: np.ndarray    # [E] int64
  receivers: np.ndarray  # [E] int64, ascending
  features: np.ndarray   # [E, 4] float32


@dataclasses.dataclass(frozen=True)
class Graph:
  grid_lat: np.ndarray
  grid_lon: np.ndarray
  grid_features: np.ndarray   # [G, 3]
  mesh_features: np.ndarray   # [M, 3]
  grid2mesh: Edges
  mesh2grid: Edges
  mask_indptr: np.ndarray     # k-hop mask of the mesh, CSR
  mask_indices: np.ndarray

  @property
  def num_grid(self) -> int:
    return self.grid_features.shape[0]

  @property
  def num_mesh(self) -> int:
    return self.mesh_features.shape[0]

  @property
  def attention_pairs(self) -> int:
    """Allowed (query, key) entries of the k-hop mask."""
    return int(self.mask_indices.shape[0])


def _sorted(senders, receivers, feats) -> Edges:
  order = np.argsort(receivers, kind='stable')
  return Edges(senders[order].astype(np.int64),
               receivers[order].astype(np.int64), feats[order])


def khop_mask(senders, receivers, n: int, k: int) -> sparse.csr_matrix:
  """Nodes within k hops (self included), by squaring the adjacency."""
  adj = sparse.csr_matrix((np.ones_like(senders, dtype=bool),
                           (senders, receivers)), shape=(n, n))
  adj = (adj + sparse.identity(n, dtype=bool, format='csr')).astype(bool)
  power, result = adj, None
  while k:
    if k & 1:
      result = power if result is None else (result @ power).astype(bool)
    k >>= 1
    if k:
      power = (power @ power).astype(bool)
  result.eliminate_zeros()
  result = result.tocsr()
  result.sort_indices()
  return result


def grid_for_resolution(deg: float) -> Tuple[np.ndarray, np.ndarray]:
  """Equiangular grid with poles: latitudes ascending from -90 to 90,
  longitudes from 0."""
  lat = np.arange(-90.0, 90.0 + deg / 2, deg, dtype=np.float32)
  lon = np.arange(0.0, 360.0, deg, dtype=np.float32)
  return lat, lon


def build(resolution_deg: float, mesh_splits: int, k_hop: int,
          radius_fraction: float, build_dir: str) -> Graph:
  lat, lon = grid_for_resolution(resolution_deg)
  verts, faces = icosahedron()
  for _ in range(mesh_splits):
    verts, faces = subdivide(verts, faces)
  verts, faces = rcm_permute(verts, faces)
  m_phi = np.arctan2(verts[:, 1], verts[:, 0])
  m_theta = np.arccos(np.clip(verts[:, 2], -1.0, 1.0))
  mesh_lat = (90.0 - np.rad2deg(m_theta)).astype(np.float32)
  mesh_lon = np.mod(np.rad2deg(m_phi), 360.0).astype(np.float32)
  g_lon, g_lat = np.meshgrid(lon, lat)
  g_lat = g_lat.reshape(-1).astype(np.float32)
  g_lon = g_lon.reshape(-1).astype(np.float32)

  s_m, r_m = faces_to_edges(faces)
  radius = float(np.linalg.norm(verts[s_m] - verts[r_m], axis=-1).max()
                 ) * radius_fraction
  points = grid_xyz(lat, lon)
  nbrs = spatial.cKDTree(verts).query_ball_point(x=points, r=radius)
  g2m_grid = np.repeat(np.arange(len(nbrs)), [len(n) for n in nbrs])
  g2m_mesh = np.concatenate([np.asarray(n, dtype=np.int64) for n in nbrs])
  g2m = _sorted(g2m_grid, g2m_mesh, edge_features(
      g_lat, g_lon, g2m_grid, mesh_lat, mesh_lon, g2m_mesh))
  face = containing_triangle(points, verts, faces, build_dir)
  m2g_mesh = faces[face].astype(np.int64).reshape(-1)
  m2g_grid = np.repeat(np.arange(points.shape[0]), 3)
  m2g = _sorted(m2g_mesh, m2g_grid, edge_features(
      mesh_lat, mesh_lon, m2g_mesh, g_lat, g_lon, m2g_grid))
  mask = khop_mask(s_m, r_m, verts.shape[0], k_hop)
  return Graph(grid_lat=lat, grid_lon=lon,
               grid_features=node_features(g_lat, g_lon),
               mesh_features=node_features(mesh_lat, mesh_lon),
               grid2mesh=g2m, mesh2grid=m2g,
               mask_indptr=mask.indptr.astype(np.int64),
               mask_indices=mask.indices.astype(np.int64))


def cached(config: dict, cache_dir: str) -> Graph:
  """`build` for the configuration's graph, through an npz cache in
  `cache_dir` (the helper is built there too)."""
  args = dict(resolution_deg=float(config['resolution_deg']),
              mesh_splits=int(config['mesh_splits']),
              k_hop=int(config['attention_k_hop']),
              radius_fraction=float(
                  config['radius_query_fraction_edge_length']))
  key = hashlib.sha256(json.dumps(args, sort_keys=True).encode()
                       ).hexdigest()[:16]
  path = os.path.join(cache_dir, f'graph_{key}.npz')
  if os.path.exists(path):
    with np.load(path) as z:
      return Graph(grid_lat=z['grid_lat'], grid_lon=z['grid_lon'],
                   grid_features=z['grid_features'],
                   mesh_features=z['mesh_features'],
                   grid2mesh=Edges(z['g2m_s'], z['g2m_r'], z['g2m_f']),
                   mesh2grid=Edges(z['m2g_s'], z['m2g_r'], z['m2g_f']),
                   mask_indptr=z['mask_indptr'],
                   mask_indices=z['mask_indices'])
  g = build(**args, build_dir=cache_dir)
  os.makedirs(cache_dir, exist_ok=True)
  tmp = f'{path}.{os.getpid()}.tmp.npz'
  np.savez(tmp, grid_lat=g.grid_lat, grid_lon=g.grid_lon,
           grid_features=g.grid_features, mesh_features=g.mesh_features,
           g2m_s=g.grid2mesh.senders, g2m_r=g.grid2mesh.receivers,
           g2m_f=g.grid2mesh.features, m2g_s=g.mesh2grid.senders,
           m2g_r=g.mesh2grid.receivers, m2g_f=g.mesh2grid.features,
           mask_indptr=g.mask_indptr, mask_indices=g.mask_indices)
  os.replace(tmp, path)
  return g
