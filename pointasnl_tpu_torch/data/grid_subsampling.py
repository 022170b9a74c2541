"""Voxel-grid subsampling: barycenter of points/features, majority-vote labels,
the port's numpy copy of ``pointasnl_tpu/data/grid_subsampling.py``.

Behavioral parity with utils/cpp_wrappers/cpp_subsampling (grid_subsampling.cpp:5-106):
  - voxel origin = floor(min_corner / sampleDl) * sampleDl;
  - each voxel emits the barycenter of its points and features;
  - labels take the per-voxel majority (per label column; ties -> the
    smaller label).
Voxels come out in sorted voxel-id order (the reference's come in
unordered_map order). The output equals, to the bit and in the same order,
the JAX package's numpy path (``_numpy_grid_subsampling``); the JAX
package's optional C++ extension is not copied (host preprocessing, off the
card). `compute()` keeps the reference wrapper's keyword surface
(wrapper.cpp kwlist: points, features, classes, sampleDl, method, verbose).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _grid_subsampling(points, features, classes, sampleDl):
    points = np.ascontiguousarray(points, dtype=np.float32)
    origin = np.floor(points.min(axis=0) / sampleDl) * sampleDl
    coords = np.floor((points - origin) / sampleDl).astype(np.int64)
    dims = coords.max(axis=0) + 1
    keys = coords[:, 0] + dims[0] * coords[:, 1] + dims[0] * dims[1] * coords[:, 2]

    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    V = len(uniq)

    sub_points = np.zeros((V, 3), np.float64)
    for d in range(3):
        sub_points[:, d] = np.bincount(inverse, weights=points[:, d], minlength=V)
    sub_points /= counts[:, None]
    sub_points = sub_points.astype(np.float32)

    sub_features = None
    if features is not None:
        features = np.ascontiguousarray(features, dtype=np.float32)
        F = features.shape[1]
        sub_features = np.zeros((V, F), np.float64)
        for d in range(F):
            sub_features[:, d] = np.bincount(inverse, weights=features[:, d], minlength=V)
        sub_features = (sub_features / counts[:, None]).astype(np.float32)

    sub_classes = None
    if classes is not None:
        classes = np.asarray(classes)
        squeeze = classes.ndim == 1
        if squeeze:
            classes = classes[:, None]
        L = classes.shape[1]
        sub_classes = np.zeros((V, L), np.int32)
        for d in range(L):
            col = classes[:, d].astype(np.int64)
            # Majority vote per voxel: count (voxel, label) pairs, then take
            # the label with the max count per voxel (ties -> smaller label,
            # deterministic; the reference's unordered_map tie-break is not).
            # The pairs that occur are counted, sorted: a dense (voxels x
            # labels) table, as the JAX package's numpy path counts them,
            # would take 272 GB for a vert_ind column of 250000 values over
            # 136000 voxels.
            labs, lab_inv = np.unique(col, return_inverse=True)
            pairs, counts_ = np.unique(inverse * len(labs) + lab_inv, return_counts=True)
            vox, lab = np.divmod(pairs, len(labs))
            # Pairs come sorted by (voxel, label); a stable sort by (voxel,
            # count descending) puts each voxel's vote first, the smaller
            # label first among equal counts.
            order = np.lexsort((-counts_, vox))
            first = np.flatnonzero(np.r_[True, np.diff(vox[order]) != 0])
            sub_classes[:, d] = labs[lab[order][first]]
        if squeeze:
            sub_classes = sub_classes[:, 0]
    return sub_points, sub_features, sub_classes


def compute(
    points: np.ndarray,
    features: Optional[np.ndarray] = None,
    classes: Optional[np.ndarray] = None,
    sampleDl: float = 0.1,
    method: str = "barycenters",
    verbose: int = 0,
):
    """Grid-subsample a cloud. Returns the same tuple shape as the reference
    wrapper: points, (features,) (classes,) depending on the inputs given."""
    if method != "barycenters":
        raise ValueError(f"unsupported method {method!r} (reference supports barycenters)")
    sub_points, sub_features, sub_classes = _grid_subsampling(points, features, classes, sampleDl)
    out = [sub_points]
    if features is not None:
        out.append(sub_features)
    if classes is not None:
        out.append(sub_classes)
    return out[0] if len(out) == 1 else tuple(out)
