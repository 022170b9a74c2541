"""Point-cloud augmentations (numpy), the port's copy of the part of
``pointasnl_tpu/data/provider.py`` that the ScanNet CLIs call.

Vectorised over the batch and driven by an explicit
``np.random.RandomState`` (``random_state``), as the JAX package's: the same
state gives the same arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _rng(random_state: Optional[np.random.RandomState]) -> np.random.RandomState:
    return random_state if random_state is not None else np.random


def normalize_data(batch_data: np.ndarray) -> np.ndarray:
    """Centre each cloud at the origin and scale it to the unit sphere."""
    centroid = np.mean(batch_data, axis=1, keepdims=True)
    pc = batch_data - centroid
    m = np.max(np.sqrt(np.sum(pc**2, axis=2)), axis=1, keepdims=True)[..., None]
    return pc / m


def _rot_z(angle: np.ndarray) -> np.ndarray:
    """(B,) angles -> (B, 3, 3) rotations about the z axis, reference layout."""
    c, s = np.cos(angle), np.sin(angle)
    z = np.zeros_like(c)
    o = np.ones_like(c)
    return np.stack(
        [np.stack([c, s, z], -1), np.stack([-s, c, z], -1), np.stack([z, z, o], -1)], -2
    )


def rotate_point_cloud_z(batch_data, random_state=None):
    """Per-cloud random rotation about the z axis (provider.py:51-69)."""
    rs = _rng(random_state)
    angles = rs.uniform(size=batch_data.shape[0]) * 2 * np.pi
    R = _rot_z(angles)
    return np.einsum("bnc,bcd->bnd", batch_data, R).astype(np.float32)
