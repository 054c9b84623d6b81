"""Icosahedral sphere meshes.

Builds the refinement hierarchy of triangular meshes on the unit sphere used
by GenCast/GraphCast: a regular icosahedron subdivided `splits` times, with
new vertices projected back to the sphere.

Behavioral parity with the reference implementation
(reference common/icosahedral_mesh.py:59-286): identical vertex
ordering and face orientation, so that checkpoints and golden values
transfer. The construction itself is standard Loop-style 4-way subdivision.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TriMesh:
  """A triangular mesh on the unit sphere.

  vertices: [num_vertices, 3] float, unit norm.
  faces: [num_faces, 3] int32 indices into vertices, counter-clockwise
    orientation viewed from outside the sphere.
  """

  vertices: np.ndarray
  faces: np.ndarray

  @property
  def num_vertices(self) -> int:
    return self.vertices.shape[0]

  @property
  def num_faces(self) -> int:
    return self.faces.shape[0]


# Face table of the regular icosahedron for the vertex construction order
# below, counter-clockwise as seen from outside (reference
# common/icosahedral_mesh.py:122-142 uses the same table; it is geometric
# data, not code).
_ICOSAHEDRON_FACES = (
    (0, 1, 2), (0, 6, 1), (8, 0, 2), (8, 4, 0), (3, 8, 2),
    (3, 2, 7), (7, 2, 1), (0, 4, 6), (4, 11, 6), (6, 11, 5),
    (1, 5, 7), (4, 10, 11), (4, 8, 10), (10, 8, 3), (10, 3, 9),
    (11, 10, 9), (11, 9, 5), (5, 9, 7), (9, 3, 7), (1, 6, 5),
)


def icosahedron() -> TriMesh:
  """Regular icosahedron with circumscribed unit sphere.

  Vertices are the cyclic-permutation family (±1, ±phi, 0), normalized, then
  rotated about the y-axis so a vertex (rather than an edge) is at the pole
  axis orientation the reference uses.
  """
  phi = (1.0 + np.sqrt(5.0)) / 2.0
  verts = []
  for c1 in (1.0, -1.0):
    for c2 in (phi, -phi):
      verts.append((c1, c2, 0.0))
      verts.append((0.0, c1, c2))
      verts.append((c2, 0.0, c1))
  verts = np.array(verts, dtype=np.float32)
  verts /= np.linalg.norm([1.0, phi])

  # Rotate about y by half the supplement of the inter-face dihedral angle.
  angle_between_faces = 2.0 * np.arcsin(phi / np.sqrt(3.0))
  rot = (np.pi - angle_between_faces) / 2.0
  c, s = np.cos(rot), np.sin(rot)
  # Active rotation matrix about y; applied as row-vector @ matrix to match
  # the reference's `np.dot(vertices, R)` convention.
  rot_mat = np.array([[c, 0.0, s],
                      [0.0, 1.0, 0.0],
                      [-s, 0.0, c]])
  verts = verts @ rot_mat
  return TriMesh(vertices=verts.astype(np.float32),
                 faces=np.array(_ICOSAHEDRON_FACES, dtype=np.int32))


def _subdivide(mesh: TriMesh) -> TriMesh:
  """Splits each face into 4, reprojecting edge midpoints onto the sphere.

  New midpoint vertices are deduplicated across adjacent faces and appended
  in order of first use (face-scan order), matching the reference's
  child-vertex ordering.
  """
  verts = list(mesh.vertices)
  midpoint_index: dict[Tuple[int, int], int] = {}

  def midpoint(a: int, b: int) -> int:
    key = (a, b) if a < b else (b, a)
    idx = midpoint_index.get(key)
    if idx is None:
      p = (mesh.vertices[a] + mesh.vertices[b]) / 2.0
      p = p / np.linalg.norm(p)
      idx = len(verts)
      verts.append(p)
      midpoint_index[key] = idx
    return idx

  new_faces = []
  for i1, i2, i3 in mesh.faces:
    m12 = midpoint(i1, i2)
    m23 = midpoint(i2, i3)
    m31 = midpoint(i3, i1)
    # Orientation-preserving 4-way split.
    new_faces.extend([(i1, m12, m31), (m12, i2, m23),
                      (m31, m23, i3), (m12, m23, m31)])
  return TriMesh(vertices=np.array(verts),
                 faces=np.array(new_faces, dtype=np.int32))


def mesh_hierarchy(splits: int) -> List[TriMesh]:
  """All refinement levels from the icosahedron up to `splits` subdivisions.

  Level s has 10*4^s + 2 vertices and 20*4^s faces. Vertices of level s are
  a prefix of the vertices of level s+1.
  """
  meshes = [icosahedron()]
  for _ in range(splits):
    meshes.append(_subdivide(meshes[-1]))
  return meshes


def finest_mesh(splits: int) -> TriMesh:
  return mesh_hierarchy(splits)[-1]


def faces_to_edges(faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """Directed edges from oriented faces: [a,b,c] -> a->b, b->c, c->a.

  Column-major concatenation (all first edges, then all second, then all
  third) — the same edge ordering the reference relies on
  (common/icosahedral_mesh.py:259-281).
  """
  assert faces.ndim == 2 and faces.shape[1] == 3
  senders = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
  receivers = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
  return senders, receivers
