"""Synthetic scenes with realistic geometry, made with numpy from a seed.

The port's own copy of ``pointasnl_tpu/data/synthetic.py:surface_scene``,
which gives the same array for the same generator state. The spatially-pruned
kNN's cost depends on the geometry it prunes, so whole-scene checks need
points on surfaces, as in an indoor scan, and not a Gaussian blob.
"""

from __future__ import annotations

import numpy as np


def surface_scene(rng: np.random.RandomState, batch: int, n: int, extent: float = 1.5,
                  noise: float = 0.008) -> np.ndarray:
    """(B, N, 3) float32 clouds sampled on indoor-scan-like surfaces.

    Each scene: a floor plane, two walls and 2-4 axis-aligned boxes (two
    faces each), with Gaussian sensor noise. Each surface gets points in
    proportion to its area, as in a range scan.
    """
    out = np.empty((batch, n, 3), np.float32)
    for b in range(batch):
        planes = [  # (origin, u-axis, v-axis)
            (np.array([0, 0, 0.0]), np.array([extent, 0, 0.0]), np.array([0, extent, 0.0])),
            (np.array([0, 0, 0.0]), np.array([extent, 0, 0.0]), np.array([0, 0, extent])),
            (np.array([0, 0, 0.0]), np.array([0, extent, 0.0]), np.array([0, 0, extent])),
        ]
        for _ in range(rng.randint(2, 5)):  # furniture boxes
            c = rng.rand(3) * extent * 0.7
            size = 0.1 + rng.rand(3) * 0.3
            planes.append((c, np.array([size[0], 0, 0]), np.array([0, size[1], 0])))
            planes.append((c, np.array([size[0], 0, 0]), np.array([0, 0, size[2]])))
        areas = np.array([np.linalg.norm(np.cross(u, v)) for _, u, v in planes])
        # Cumulative rounding: the counts sum to n and none is negative.
        edges = np.round(np.cumsum(areas) / areas.sum() * n).astype(int)
        counts = np.diff(edges, prepend=0)
        pts = []
        for (o, u, v), c in zip(planes, counts):
            uv = rng.rand(c, 2)
            pts.append(o + uv[:, :1] * u + uv[:, 1:] * v)
        cloud = np.concatenate(pts)[:n]
        cloud = cloud + rng.randn(*cloud.shape) * noise
        rng.shuffle(cloud)
        out[b] = cloud.astype(np.float32)
    return out
