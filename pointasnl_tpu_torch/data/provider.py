"""Point-cloud augmentations (numpy), the port's copy of
``pointasnl_tpu/data/provider.py``.

Behavioral parity with utils/provider.py, but vectorized over the batch (the
reference loops per cloud) and driven by an explicit
``np.random.RandomState`` (``random_state``), as the JAX package's: the same
state gives the same arrays, to the bit. The h5 helpers are kept for API
parity; ``h5py`` is imported inside ``load_h5`` only.

Key semantic notes preserved from the reference:
- shuffle_points uses ONE permutation for the whole batch (provider.py:39-49);
  this is the only randomness in FPS (which always seeds at index 0), so it is
  load-bearing for vote-based evaluation (test.py:140-142).
- random_point_dropout collapses dropped points onto the FIRST point
  (provider.py:246-253) — the noise-robustness training signal for AS.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rng(random_state: Optional[np.random.RandomState]) -> np.random.RandomState:
    return random_state if random_state is not None else np.random


def normalize_data(batch_data: np.ndarray) -> np.ndarray:
    """Center each cloud at the origin and scale to the unit sphere."""
    centroid = np.mean(batch_data, axis=1, keepdims=True)
    pc = batch_data - centroid
    m = np.max(np.sqrt(np.sum(pc**2, axis=2)), axis=1, keepdims=True)[..., None]
    return pc / m


def shuffle_data(data, labels, random_state=None):
    idx = np.arange(len(labels))
    _rng(random_state).shuffle(idx)
    return data[idx, ...], labels[idx], idx


def shuffle_points(batch_data, random_state=None):
    """One shared permutation of the point axis for the whole batch."""
    idx = np.arange(batch_data.shape[1])
    _rng(random_state).shuffle(idx)
    return batch_data[:, idx, :]


def _rot_y(angle: np.ndarray) -> np.ndarray:
    """(B,) angles -> (B, 3, 3) rotations about the up (y) axis, reference layout."""
    c, s = np.cos(angle), np.sin(angle)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    return np.stack(
        [np.stack([c, z, s], -1), np.stack([z, o, z], -1), np.stack([-s, z, c], -1)], -2
    )


def _rot_z(angle: np.ndarray) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    return np.stack(
        [np.stack([c, s, z], -1), np.stack([-s, c, z], -1), np.stack([z, z, o], -1)], -2
    )


def rotate_point_cloud(batch_data, random_state=None):
    """Per-cloud random rotation about the up axis (provider.py:51-69)."""
    rs = _rng(random_state)
    angles = rs.uniform(size=batch_data.shape[0]) * 2 * np.pi
    R = _rot_y(angles)
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)


def rotate_point_cloud_z(batch_data, random_state=None):
    rs = _rng(random_state)
    angles = rs.uniform(size=batch_data.shape[0]) * 2 * np.pi
    R = _rot_z(angles)
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)


def rotate_point_cloud_with_normal(batch_xyz_normal, random_state=None):
    rs = _rng(random_state)
    angles = rs.uniform(size=batch_xyz_normal.shape[0]) * 2 * np.pi
    R = _rot_y(angles)
    out = batch_xyz_normal.copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_xyz_normal[:, :, 0:3], R)
    out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_xyz_normal[:, :, 3:6], R)
    return out


def rotate_point_cloud_by_angle(batch_data, rotation_angle):
    angles = np.full(batch_data.shape[0], rotation_angle)
    R = _rot_y(angles)
    out = batch_data.copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    return out.astype(np.float32)


def rotate_point_cloud_by_angle_with_normal(batch_data, rotation_angle):
    angles = np.full(batch_data.shape[0], rotation_angle)
    R = _rot_y(angles)
    out = batch_data.copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out.astype(np.float32)


def _small_rotations(B, angle_sigma, angle_clip, rs) -> np.ndarray:
    angles = np.clip(angle_sigma * rs.randn(B, 3), -angle_clip, angle_clip)
    cx, sx = np.cos(angles[:, 0]), np.sin(angles[:, 0])
    cy, sy = np.cos(angles[:, 1]), np.sin(angles[:, 1])
    cz, sz = np.cos(angles[:, 2]), np.sin(angles[:, 2])
    z = np.zeros(B)
    o = np.ones(B)
    Rx = np.stack(
        [np.stack([o, z, z], -1), np.stack([z, cx, -sx], -1), np.stack([z, sx, cx], -1)], -2
    )
    Ry = np.stack(
        [np.stack([cy, z, sy], -1), np.stack([z, o, z], -1), np.stack([-sy, z, cy], -1)], -2
    )
    Rz = np.stack(
        [np.stack([cz, -sz, z], -1), np.stack([sz, cz, z], -1), np.stack([z, z, o], -1)], -2
    )
    return np.einsum("bij,bjk,bkl->bil", Rz, Ry, Rx)


def rotate_perturbation_point_cloud(batch_data, angle_sigma=0.06, angle_clip=0.18, random_state=None):
    rs = _rng(random_state)
    R = _small_rotations(batch_data.shape[0], angle_sigma, angle_clip, rs)
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)


def rotate_perturbation_point_cloud_with_normal(
    batch_data, angle_sigma=0.06, angle_clip=0.18, random_state=None
):
    rs = _rng(random_state)
    R = _small_rotations(batch_data.shape[0], angle_sigma, angle_clip, rs)
    out = batch_data.copy()
    out[:, :, 0:3] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 0:3], R)
    out[:, :, 3:6] = np.einsum("bnc,bcd->bnd", batch_data[:, :, 3:6], R)
    return out.astype(np.float32)


def jitter_point_cloud(batch_data, sigma=0.01, clip=0.05, random_state=None):
    rs = _rng(random_state)
    assert clip > 0
    noise = np.clip(sigma * rs.randn(*batch_data.shape), -clip, clip)
    return (batch_data + noise).astype(np.float32)


def shift_point_cloud(batch_data, shift_range=0.1, random_state=None):
    rs = _rng(random_state)
    B = batch_data.shape[0]
    shifts = rs.uniform(-shift_range, shift_range, (B, 1, 3))
    return (batch_data + shifts).astype(np.float32)


def random_scale_point_cloud(batch_data, scale_low=0.8, scale_high=1.25, random_state=None):
    rs = _rng(random_state)
    B = batch_data.shape[0]
    scales = rs.uniform(scale_low, scale_high, (B, 1, 1))
    return (batch_data * scales).astype(np.float32)


def random_point_dropout(batch_pc, max_dropout_ratio=0.875, random_state=None):
    """Collapse a random fraction of points onto the first point (per cloud)."""
    rs = _rng(random_state)
    out = batch_pc.copy()
    for b in range(out.shape[0]):
        dropout_ratio = rs.random_sample() * max_dropout_ratio
        drop_idx = np.where(rs.random_sample(out.shape[1]) <= dropout_ratio)[0]
        if len(drop_idx) > 0:
            out[b, drop_idx, :] = out[b, 0, :]
    return out


def getDataFiles(list_filename):
    return [line.rstrip() for line in open(list_filename)]


def load_h5(h5_filename):
    import h5py

    f = h5py.File(h5_filename, "r")
    return f["data"][:], f["label"][:]


def loadDataFile(filename):
    return load_h5(filename)
