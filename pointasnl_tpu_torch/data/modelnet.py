"""ModelNet40/10 dataset (modelnet40_normal_resampled layout), the port's
numpy copy of ``pointasnl_tpu/data/modelnet.py``: for the same files and the
same ``random_state`` it gives the same batches, to the bit.

Behavioral parity with modelnet_dataset.py: per-item CSV loadtxt of 10k
points, take the first `npoints` (or numpy FPS with a random seed point when
uniform=True), unit-sphere normalization, RAM cache, and the
reset/has_next_batch/next_batch batch-iterator surface the trainer uses
(train.py:224-237).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center at the centroid and scale to the unit sphere (modelnet_dataset.py:9-14)."""
    centroid = np.mean(pc, axis=0)
    pc = pc - centroid
    m = np.max(np.sqrt(np.sum(pc**2, axis=1)))
    return pc / m


def farthest_point_sample_np(point: np.ndarray, npoint: int, random_state=None) -> np.ndarray:
    """Numpy FPS over one cloud with a RANDOM seed point (modelnet_dataset.py:16-37).

    (The FPS of the models seeds at index 0, as the CUDA kernel does; this
    host sampler is the dataset's randomized variant, for --uniform.)
    """
    rs = random_state if random_state is not None else np.random
    N = point.shape[0]
    xyz = point[:, :3]
    centroids = np.zeros((npoint,), dtype=np.int64)
    distance = np.full((N,), 1e10)
    farthest = rs.randint(0, N)
    for i in range(npoint):
        centroids[i] = farthest
        dist = np.sum((xyz - xyz[farthest]) ** 2, axis=-1)
        mask = dist < distance
        distance[mask] = dist[mask]
        farthest = int(np.argmax(distance))
    return point[centroids]


class ModelNetDataset:
    """Batch iterator over the modelnet*_normal_resampled CSV dump."""

    def __init__(
        self,
        root: str,
        batch_size: int = 32,
        npoints: int = 1024,
        split: str = "train",
        normalize: bool = True,
        normal_channel: bool = False,
        modelnet10: bool = False,
        cache_size: int = 15000,
        shuffle: Optional[bool] = None,
        uniform: bool = False,
        random_state: Optional[np.random.RandomState] = None,
    ):
        assert split in ("train", "test")
        self.root = root
        self.batch_size = batch_size
        self.npoints = npoints
        self.normalize = normalize
        self.uniform = uniform
        self.normal_channel = normal_channel
        self.rs = random_state if random_state is not None else np.random.RandomState()

        prefix = "modelnet10" if modelnet10 else "modelnet40"
        catfile = os.path.join(root, f"{prefix}_shape_names.txt")
        self.cat = [line.rstrip() for line in open(catfile)]
        self.classes = dict(zip(self.cat, range(len(self.cat))))

        ids = [line.rstrip() for line in open(os.path.join(root, f"{prefix}_{split}.txt"))]
        shape_names = ["_".join(x.split("_")[0:-1]) for x in ids]
        self.datapath = [
            (shape_names[i], os.path.join(root, shape_names[i], ids[i]) + ".txt")
            for i in range(len(ids))
        ]

        self.cache_size = cache_size
        self.cache = {}

        self.shuffle = (split == "train") if shuffle is None else shuffle
        self.reset()

    def _get_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        if index in self.cache:
            return self.cache[index]
        shape_name, path = self.datapath[index]
        cls = np.array([self.classes[shape_name]], dtype=np.int32)
        point_set = np.loadtxt(path, delimiter=",").astype(np.float32)
        if self.uniform:
            point_set = farthest_point_sample_np(point_set, self.npoints, self.rs)
        else:
            point_set = point_set[0 : self.npoints, :]
        if self.normalize:
            point_set[:, 0:3] = pc_normalize(point_set[:, 0:3])
        if not self.normal_channel:
            point_set = point_set[:, 0:3]
        if len(self.cache) < self.cache_size:
            self.cache[index] = (point_set, cls)
        return point_set, cls

    def __getitem__(self, index: int):
        return self._get_item(index)

    def __len__(self):
        return len(self.datapath)

    def num_channel(self) -> int:
        return 6 if self.normal_channel else 3

    def reset(self):
        self.idxs = np.arange(0, len(self.datapath))
        if self.shuffle:
            self.rs.shuffle(self.idxs)
        self.num_batches = (len(self.datapath) + self.batch_size - 1) // self.batch_size
        self.batch_idx = 0

    def has_next_batch(self) -> bool:
        return self.batch_idx < self.num_batches

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """May return a short batch at the epoch tail (like the reference)."""
        start = self.batch_idx * self.batch_size
        end = min((self.batch_idx + 1) * self.batch_size, len(self.datapath))
        bsize = end - start
        batch_data = np.zeros((bsize, self.npoints, self.num_channel()), np.float32)
        batch_label = np.zeros((bsize,), np.int32)
        for i in range(bsize):
            ps, cls = self._get_item(self.idxs[i + start])
            batch_data[i] = ps
            batch_label[i] = cls[0]
        self.batch_idx += 1
        return batch_data, batch_label
