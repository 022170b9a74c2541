"""SemanticKITTI grid-sampled dataset (the ~52-mIoU recipe), the port's numpy
and scipy copy of ``pointasnl_tpu/data/semantic_kitti_grid.py``.

Behavioral parity with SemanticKITTI/semantic_kitti_dataset_grid.py:
- prepare (:137-190): per scan, remap labels through learning_map, grid
  subsample at `grid_size` (default 0.06), cache sub_points/sub_labels as
  .npy; validation (seq 08) and test sequences also cache projection
  indices from the raw scan into the subsampled cloud.
- generator (:212-241): training/validation crop `num_point` KNN around a
  random center per scan; test uses possibility-driven center picking with
  distance-falloff updates (the vote scheduler).
- per-crop augmentation (vertical rotation, anisotropic scale, noise) comes
  from grid_pipeline.augment_points (tf_augment_input equivalent :304-354).
- class weights from the published per-class counts ^(-1/3), weight[0]=0
  (:74-80).

A scan's KD-tree is scipy's ``cKDTree``, built from its subsampled ``.npy``
when the scan is read: the port writes no tree cache and never reads or
writes the JAX package's sklearn pickles (``<seq>/KDTree/*.pkl``). The
``.npy`` files and the projection pickles are plain numpy and shared, so the
port reads a directory the JAX package prepared. A ball query's indices are
put in ascending order before the crop's permutation (sklearn's order
follows its tree); kNN crops keep the order by distance.
"""

from __future__ import annotations

import os
import pickle
from os.path import join
from typing import Iterator, List, Optional

import numpy as np
from scipy.spatial import cKDTree

from pointasnl_tpu_torch.data.grid_pipeline import (
    GridConfig,
    augment_points,
    ball_indices,
    knn_indices,
    nearest_indices,
    parallel_map,
)
from pointasnl_tpu_torch.data.grid_subsampling import compute as _gs_compute
from pointasnl_tpu_torch.data.semantic_kitti_config import KITTI_LABEL_TO_CAT, LEARNING_MAP

# Published per-training-class point counts (semantic_kitti_dataset_grid.py:74-76)
NUM_PER_CLASS = np.array(
    [0, 55437630, 320797, 541736, 2578735, 3274484, 552662, 184064, 78858,
     240942562, 17294618, 170599734, 6369672, 230413074, 101130274, 476491114,
     9833174, 129609852, 4506626, 1168181],
    dtype=np.float64,
)

TRAIN_SEQS = ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"]
VAL_SEQ = "08"


def _build_remap_lut() -> np.ndarray:
    maxkey = max(LEARNING_MAP.keys())
    lut = np.zeros((maxkey + 100), dtype=np.int32)
    lut[list(LEARNING_MAP.keys())] = list(LEARNING_MAP.values())
    return lut


class SemanticKittiGridDataset:
    """SemanticKITTI with grid-subsampled scans and possibility-driven test crops."""

    LABEL_TO_NAMES = KITTI_LABEL_TO_CAT

    def __init__(
        self,
        data_path: str,
        num_point: int = 10240,
        grid_size: float = 0.06,
        num_buffer: int = 1024,
        in_radius: float = 0.0,
        test_id: int = 14,
        prepare_data: bool = False,
        random_state: Optional[np.random.RandomState] = None,
    ):
        self.num_point = num_point
        self.grid_size = grid_size
        self.num_buffer = num_buffer
        self.in_radius = in_radius
        self.rs = random_state if random_state is not None else np.random.RandomState()

        self.raw_path = data_path
        self.dataset_path = data_path.rstrip("/") + "_" + str(grid_size)

        self.label_to_names = dict(self.LABEL_TO_NAMES)
        self.num_classes = len(self.label_to_names)
        self.label_values = np.sort(list(self.label_to_names.keys()))
        self.label_to_idx = {l: i for i, l in enumerate(self.label_values)}
        self.ignored_labels = np.sort([0])
        self.remap_lut = _build_remap_lut()

        if prepare_data:
            self.prepare_pointcloud(self.raw_path, self.dataset_path)

        self.test_scan_number = str(test_id)
        self.train_list, self.val_list, self.test_list = self.get_file_list(
            self.dataset_path, f"{test_id:02d}" if isinstance(test_id, int) else str(test_id)
        )
        self.train_list = self.shuffle_list(self.train_list)
        self.val_list = self.shuffle_list(self.val_list)

        labelweights = NUM_PER_CLASS / np.sum(NUM_PER_CLASS)
        self.labelweights = np.power(
            np.amax(labelweights[1:]) / np.maximum(labelweights, 1e-12), 1 / 3.0
        ).astype(np.float32)
        self.labelweights[0] = 0
        self.possibility: List[np.ndarray] = []
        self.min_possibility: List[float] = []

    # ------------------------------------------------------------- prepare

    @staticmethod
    def load_pc_kitti(pc_path: str) -> np.ndarray:
        scan = np.fromfile(pc_path, dtype=np.float32).reshape((-1, 4))
        return scan[:, 0:3]

    def load_label_kitti(self, label_path: str) -> np.ndarray:
        label = np.fromfile(label_path, dtype=np.uint32).reshape((-1))
        sem_label = label & 0xFFFF
        inst_label = label >> 16
        assert ((sem_label + (inst_label << 16)) == label).all()
        return self.remap_lut[sem_label].astype(np.int32)

    def shuffle_list(self, data_list):
        data_list = np.asarray(data_list)
        indices = self.rs.permutation(len(data_list))
        return data_list[indices]

    def get_file_list(self, dataset_path: str, test_scan_num: str):
        seq_list = np.sort(os.listdir(dataset_path))
        train_files, val_files, test_files = [], [], []
        for seq_id in seq_list:
            pc_path = join(dataset_path, seq_id, "velodyne")
            if not os.path.isdir(pc_path):
                continue
            files = [join(pc_path, f) for f in np.sort(os.listdir(pc_path))]
            if seq_id == VAL_SEQ:
                val_files.extend(files)
                if seq_id == test_scan_num:
                    test_files.extend(files)
            elif seq_id.isdigit() and int(seq_id) >= 11 and seq_id == test_scan_num:
                test_files.extend(files)
            elif seq_id in TRAIN_SEQS:
                train_files.extend(files)
        return (
            np.asarray(train_files),
            np.asarray(val_files),
            np.asarray(test_files),
        )

    def prepare_pointcloud(self, dataset_path: str, output_path: str):
        """Grid-subsample every scan, and cache the projections (:137-190)."""
        for seq_id in np.sort(os.listdir(dataset_path)):
            seq_path = join(dataset_path, seq_id)
            pc_path = join(seq_path, "velodyne")
            if not os.path.isdir(pc_path):
                continue
            seq_path_out = join(output_path, seq_id)
            pc_path_out = join(seq_path_out, "velodyne")
            os.makedirs(pc_path_out, exist_ok=True)

            has_labels = seq_id.isdigit() and int(seq_id) < 11
            if has_labels:
                label_path = join(seq_path, "labels")
                label_path_out = join(seq_path_out, "labels")
                os.makedirs(label_path_out, exist_ok=True)

            for scan_id in np.sort(os.listdir(pc_path)):
                stem = scan_id[:-4]
                points = self.load_pc_kitti(join(pc_path, scan_id))
                if has_labels:
                    labels = self.load_label_kitti(join(label_path, stem + ".label"))
                    sub_points, sub_labels = _gs_compute(
                        points, classes=labels, sampleDl=self.grid_size
                    )
                    np.save(join(label_path_out, stem), sub_labels)
                else:
                    sub_points = _gs_compute(points, sampleDl=self.grid_size)
                np.save(join(pc_path_out, stem), sub_points)

                # proj indices for validation (seq 08) and test sequences
                if seq_id == VAL_SEQ or (seq_id.isdigit() and int(seq_id) >= 11):
                    proj_path = join(seq_path_out, "proj")
                    os.makedirs(proj_path, exist_ok=True)
                    proj_inds = nearest_indices(cKDTree(sub_points), points)
                    with open(join(proj_path, stem + "_proj.pkl"), "wb") as f:
                        pickle.dump([proj_inds], f)

    # ------------------------------------------------------------ access

    def get_data(self, file_path: str):
        seq_id = file_path.split(os.sep)[-3]
        frame_id = file_path.split(os.sep)[-1][:-4]
        sub_points = np.load(join(self.dataset_path, seq_id, "velodyne", frame_id + ".npy"))
        search_tree = cKDTree(sub_points)
        points = np.asarray(search_tree.data)
        if seq_id.isdigit() and int(seq_id) >= 11:
            labels = np.zeros(np.shape(points)[0], dtype=np.uint8)
        else:
            labels = np.squeeze(
                np.load(join(self.dataset_path, seq_id, "labels", frame_id + ".npy"))
            )
        return points, search_tree, labels

    def get_proj_inds(self, file_path: str) -> np.ndarray:
        seq_id = file_path.split(os.sep)[-3]
        frame_id = file_path.split(os.sep)[-1][:-4]
        with open(join(self.dataset_path, seq_id, "proj", frame_id + "_proj.pkl"), "rb") as f:
            return pickle.load(f)[0]

    def crop_pc(self, points, labels, search_tree, pick_idx):
        """kNN (or radius) crop of num_point around the picked center (:265-286)."""
        center_point = points[pick_idx, :].reshape(1, -1)
        if self.in_radius > 0:
            select_idx = ball_indices(search_tree, center_point, self.in_radius)
        else:
            buffer = self.num_buffer + self.rs.randint(0, self.num_buffer // 4)
            k = min(len(points), self.num_point + buffer)
            select_idx = knn_indices(search_tree, center_point, k)

        select_idx = select_idx[self.rs.permutation(len(select_idx))][: self.num_point]
        if len(select_idx) < self.num_point:
            num_in = len(select_idx)
            dup = self.rs.choice(num_in, self.num_point - num_in)
            select_idx = select_idx[list(range(num_in)) + list(dup)]
        return points[select_idx], labels[select_idx], select_idx

    def reset_possibility(self):
        self.possibility = []
        self.min_possibility = []
        for test_file_name in self.test_list:
            pts, _, _ = self.get_data(test_file_name)
            self.possibility += [self.rs.rand(pts.shape[0]) * 1e-3]
            self.min_possibility += [float(np.min(self.possibility[-1]))]

    def spatially_regular_gen(self, split: str, config: GridConfig) -> Iterator[dict]:
        if split == "training":
            path_list = self.train_list
            num_per_epoch = (len(path_list) // config.batch_size) * config.batch_size
        elif split == "validation":
            path_list = self.val_list
            num_per_epoch = (len(path_list) // config.batch_size) * config.batch_size
        elif split == "test":
            path_list = self.test_list
            num_per_epoch = (len(path_list) // config.batch_size) * config.batch_size * 4
            if not self.possibility:
                self.reset_possibility()
        else:
            raise ValueError(f"bad split {split!r}")

        for i in range(num_per_epoch):
            if split != "test":
                cloud_ind = i
                pc, tree, labels = self.get_data(path_list[cloud_ind])
                pick_idx = self.rs.choice(len(pc), 1)
                selected_pc, selected_labels, selected_idx = self.crop_pc(
                    pc, labels, tree, pick_idx
                )
                label_weights = self.labelweights[selected_labels]
            else:
                cloud_ind = int(np.argmin(self.min_possibility))
                pick_idx = np.argmin(self.possibility[cloud_ind])
                pc, tree, labels = self.get_data(path_list[cloud_ind])
                selected_pc, selected_labels, selected_idx = self.crop_pc(
                    pc, labels, tree, pick_idx
                )
                dists = np.sum(
                    np.square((selected_pc - pc[pick_idx]).astype(np.float32)), axis=1
                )
                delta = np.square(1 - dists / np.max(dists))
                self.possibility[cloud_ind][selected_idx] += delta
                self.min_possibility[cloud_ind] = float(np.min(self.possibility[cloud_ind]))
                label_weights = np.zeros(selected_pc.shape[0], np.float32)

            yield {
                "points": selected_pc.astype(np.float32),
                "labels": selected_labels.astype(np.int32),
                "label_weights": label_weights.astype(np.float32),
                "point_inds": selected_idx.astype(np.int32),
                "cloud_ind": np.int32(cloud_ind),
            }

    def batches(self, split: str, config: GridConfig, augment: bool = True) -> Iterator[dict]:
        """Fixed-shape batches; the augment stage runs on
        `config.input_threads` workers (tf.data num_parallel_calls analog,
        train_semantic_kitti_grid.py pipeline). Per-item seeds are drawn
        serially, so output is identical for any thread count."""
        symmetries = [True, False, False] if split == "training" else [False, False, False]
        cfg = GridConfig(**{**config.__dict__, "augment_symmetries": symmetries})

        def seeded():
            for item in self.spatially_regular_gen(split, cfg):
                yield item, self.rs.randint(0, 2**31 - 1)

        def map_fn(arg):
            item, seed = arg
            if not augment:
                return item
            pts, _, _ = augment_points(
                item["points"], cfg, np.random.RandomState(seed)
            )
            return dict(item, points=pts)

        buf = []
        with parallel_map(seeded(), map_fn, cfg.input_threads) as mapped:
            for item in mapped:
                buf.append(item)
                if len(buf) == cfg.batch_size:
                    yield {k: np.stack([b[k] for b in buf]) for k in buf[0]}
                    buf = []
