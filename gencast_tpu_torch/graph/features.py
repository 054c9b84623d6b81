"""Static spatial features for graph nodes and edges (host-side numpy).

Node features: (sin(lat), cos(lon), sin(lon)).
Edge features: (|d| / L, d / L) where d is the sender-minus-receiver
displacement expressed in a local frame rotated so the receiver sits at
lat=0, lon=0, and L is the max edge length (or an explicit normalization).

Semantics match the reference (common/model_utils.py:24-591); implemented
with explicit rotation matrices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def lat_lon_to_spherical(lat_deg: np.ndarray,
                         lon_deg: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  """(phi, theta) = (azimuth, colatitude) in radians."""
  return np.deg2rad(lon_deg), np.deg2rad(90.0 - lat_deg)


def spherical_to_lat_lon(phi: np.ndarray,
                         theta: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  return 90.0 - np.rad2deg(theta), np.mod(np.rad2deg(phi), 360.0)


def spherical_to_xyz(phi: np.ndarray, theta: np.ndarray) -> np.ndarray:
  """Unit vectors, shape [..., 3]."""
  return np.stack([np.cos(phi) * np.sin(theta),
                   np.sin(phi) * np.sin(theta),
                   np.cos(theta)], axis=-1)


def xyz_to_spherical(xyz: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
  phi = np.arctan2(xyz[..., 1], xyz[..., 0])
  theta = np.arccos(np.clip(xyz[..., 2], -1.0, 1.0))
  return phi, theta


def _rot_z(a: np.ndarray) -> np.ndarray:
  c, s = np.cos(a), np.sin(a)
  z, o = np.zeros_like(a), np.ones_like(a)
  return np.stack([
      np.stack([c, -s, z], -1),
      np.stack([s, c, z], -1),
      np.stack([z, z, o], -1),
  ], -2)


def _rot_y(a: np.ndarray) -> np.ndarray:
  c, s = np.cos(a), np.sin(a)
  z, o = np.zeros_like(a), np.ones_like(a)
  return np.stack([
      np.stack([c, z, s], -1),
      np.stack([z, o, z], -1),
      np.stack([-s, z, c], -1),
  ], -2)


def receiver_local_rotations(phi: np.ndarray, theta: np.ndarray) -> np.ndarray:
  """Rotation matrices taking each reference point to (lat=0, lon=0).

  Extrinsic z-then-y composition: first rotate about z by -phi (to zero
  longitude), then about y by (pi/2 - theta) (to zero latitude). A vector
  pointing to the pole at the reference point keeps pointing "up" in the
  local frame. Shape [..., 3, 3].
  """
  return _rot_y(np.pi / 2.0 - theta) @ _rot_z(-phi)


def node_features(lat_deg: np.ndarray, lon_deg: np.ndarray) -> np.ndarray:
  """[num_nodes, 3]: (sin(lat), cos(lon), sin(lon))."""
  phi, theta = lat_lon_to_spherical(lat_deg, lon_deg)
  return np.stack([np.cos(theta), np.cos(phi), np.sin(phi)],
                  axis=-1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class EdgeFeatureResult:
  features: np.ndarray  # [num_edges, 4]
  normalization_factor: float


def edge_features(
    sender_lat: np.ndarray, sender_lon: np.ndarray, senders: np.ndarray,
    receiver_lat: np.ndarray, receiver_lon: np.ndarray, receivers: np.ndarray,
    normalization_factor: Optional[float] = None,
) -> EdgeFeatureResult:
  """Relative displacement features in receiver-local coordinates.

  Works for both bipartite (grid2mesh / mesh2grid) and homogeneous (mesh)
  edge sets; pass the same lat/lon arrays for both endpoints in the
  homogeneous case.
  """
  s_phi, s_theta = lat_lon_to_spherical(sender_lat, sender_lon)
  r_phi, r_theta = lat_lon_to_spherical(receiver_lat, receiver_lon)
  s_pos = spherical_to_xyz(s_phi, s_theta)
  r_pos = spherical_to_xyz(r_phi, r_theta)

  rot = receiver_local_rotations(r_phi, r_theta)[receivers]  # [E, 3, 3]
  s_local = np.einsum('eij,ej->ei', rot, s_pos[senders])
  r_local = np.einsum('eij,ej->ei', rot, r_pos[receivers])
  rel = s_local - r_local  # [E, 3]

  length = np.linalg.norm(rel, axis=-1, keepdims=True)
  if normalization_factor is None:
    normalization_factor = float(length.max())
  feats = np.concatenate([length, rel], axis=-1) / normalization_factor
  return EdgeFeatureResult(features=feats.astype(np.float32),
                           normalization_factor=normalization_factor)
