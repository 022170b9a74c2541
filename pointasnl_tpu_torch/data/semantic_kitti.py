"""SemanticKITTI segmentation datasets (block-crop variants), the port's numpy
copy of ``pointasnl_tpu/data/semantic_kitti.py``: for the same scans and the
same ``random_state`` it gives the same arrays, to the bit.

Behavioral parity with SemanticKITTI/semantic_kitti_dataset.py:
- SemanticKittiDataset: 10m-block random crops with >=70% labeled retry (x10),
  `sample_points` sampled with replacement, class weights from the hardcoded
  per-training-class content ^(-1/3) (:54-58), optional remission channel.
- SemanticKittiDatasetWhole: block tiling over a scan (:115-214).
- SemanticKittiDatasetSlidingWindow: strided blocks with small-block merge and
  exact-`sample_points` split, returning original indices for vote pooling and
  the raw scan for `.label` submission dumps (:217-358).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from pointasnl_tpu_torch.data import laserscan
from pointasnl_tpu_torch.data.semantic_kitti_config import MAPPED_CONTENT, load_config

SPLITS = ["train", "valid", "test"]
SHUFFLE_SEED = 100  # the reference's fixed random_sample seed (:15)


def _build_remap_lut(remapdict) -> np.ndarray:
    maxkey = max(remapdict.keys())
    lut = np.zeros((maxkey + 100), dtype=np.int32)  # +100: unknown-label slack
    lut[list(remapdict.keys())] = list(remapdict.values())
    return lut


def _label_weights_lut() -> np.ndarray:
    keys = sorted(MAPPED_CONTENT.keys())
    lut = np.zeros((len(keys),), dtype=np.float32)
    lut[keys] = [MAPPED_CONTENT[k] for k in keys]
    return np.power(np.amax(lut[1:]) / lut, 1 / 3.0)


def _list_sequence_files(root, sequences, need_labels=True):
    points_name, label_name = [], []
    for sequence in sequences:
        sequence = "{0:02d}".format(int(sequence))
        points_path = os.path.join(root, "sequences", sequence, "velodyne")
        seq_points = sorted(
            os.path.join(points_path, pn) for pn in os.listdir(points_path) if pn.endswith(".bin")
        )
        points_name.extend(seq_points)
        if need_labels:
            label_path = os.path.join(root, "sequences", sequence, "labels")
            seq_labels = sorted(
                os.path.join(label_path, ln) for ln in os.listdir(label_path) if ln.endswith(".label")
            )
            assert len(seq_points) == len(seq_labels)
            label_name.extend(seq_labels)
    return points_name, label_name


class SemanticKittiDataset:
    """Random 10m-block crop training dataset (semantic_kitti_dataset.py:17-112)."""

    def __init__(
        self,
        root,
        sample_points=8192,
        block_size=10,
        num_classes=20,
        split="train",
        with_remission=False,
        config_file: Optional[str] = None,
        should_map=True,
        padding=0.01,
        random_sample=False,
        random_rate=0.1,
        random_state: Optional[np.random.RandomState] = None,
    ):
        assert split in SPLITS
        self.root = root
        self.split = split
        self.padding = padding
        self.block_size = block_size
        self.sample_points = sample_points
        self.random_sample = random_sample
        self.with_remission = with_remission
        self.should_map = should_map
        self.rs = random_state if random_state is not None else np.random.RandomState()
        self.config = load_config(config_file)
        self.scan = laserscan.SemLaserScan(
            nclasses=num_classes, sem_color_dict=self.config["color_map"]
        )
        self.points_name, self.label_name = _list_sequence_files(
            root, self.config["split"][split]
        )

        if self.random_sample:
            random.Random(SHUFFLE_SEED).shuffle(self.points_name)
            random.Random(SHUFFLE_SEED).shuffle(self.label_name)
            total = len(self.points_name)
            self.points_name = self.points_name[: int(total * random_rate)]
            self.label_name = self.label_name[: int(total * random_rate)]

        self.label_weights_lut = _label_weights_lut()
        if should_map:
            self.remap_lut = _build_remap_lut(self.config["learning_map"])

    def __getitem__(self, index):
        self.scan.open_scan(self.points_name[index])
        self.scan.open_label(self.label_name[index])
        points = self.scan.points
        label = self.scan.sem_label
        if self.should_map:
            label = self.remap_lut[label]
        label_weights = self.label_weights_lut[label]
        coordmax = np.max(points[:, 0:3], axis=0)
        coordmin = np.min(points[:, 0:3], axis=0)

        cur_point_full = points
        cur_semantic_seg = label
        mask = np.ones(len(label), bool)
        cur_choice_idx = np.ones(len(label), bool)
        for _ in range(10):
            curcenter = points[self.rs.choice(len(label), 1)[0], 0:3]
            curmin = curcenter - [self.block_size / 2, self.block_size / 2, 14]
            curmax = curcenter + [self.block_size / 2, self.block_size / 2, 14]
            curmin[2] = coordmin[2]
            curmax[2] = coordmax[2]
            curchoice = (
                np.sum(
                    (points[:, 0:3] >= (curmin - 0.2)) * (points[:, 0:3] <= (curmax + 0.2)), axis=1
                )
                == 3
            )
            cur_point_set = points[curchoice, 0:3]
            cur_point_full = points[curchoice, :]
            cur_semantic_seg = label[curchoice]
            cur_choice_idx = curchoice
            if len(cur_semantic_seg) == 0:
                continue
            mask = (
                np.sum(
                    (cur_point_set >= (curmin - self.padding))
                    * (cur_point_set <= (curmax + self.padding)),
                    axis=1,
                )
                == 3
            )
            if np.sum(cur_semantic_seg > 0) / len(cur_semantic_seg) >= 0.7:
                break

        choice = self.rs.choice(len(cur_semantic_seg), self.sample_points, replace=True)
        point_set = cur_point_full[choice, :]
        semantic_seg = cur_semantic_seg[choice]
        mask = mask[choice]
        # Reference bug not replicated: semantic_kitti_dataset.py:104 indexes
        # the per-POINT weight array by class ids (`label_weights[semantic_seg]`)
        # instead of the class-weight LUT; the intended per-class weights are
        # lut[semantic_seg], used here.
        sample_weight = self.label_weights_lut[semantic_seg]
        sample_weight *= mask
        if self.with_remission:
            # Reference bug not replicated: :107 indexes the FULL scan's
            # remissions with crop-local `choice`; the remission of the
            # cropped subset is what belongs with point_set.
            remissions = self.scan.remissions[cur_choice_idx][choice]
            point_set = np.concatenate((point_set, remissions[:, None]), axis=1)
        return point_set, semantic_seg, sample_weight

    def __len__(self):
        return len(self.points_name)


class SemanticKittiDatasetWhole:
    """Tile a whole scan into blocks (semantic_kitti_dataset.py:115-214)."""

    def __init__(
        self,
        root,
        sample_points=8192,
        block_size=10,
        num_classes=20,
        split="train",
        with_remission=False,
        config_file: Optional[str] = None,
        should_map=True,
        padding=0.01,
        random_sample=False,
        random_rate=0.1,
        random_state: Optional[np.random.RandomState] = None,
    ):
        assert split in SPLITS
        self.root = root
        self.split = split
        self.padding = padding
        self.block_size = block_size
        self.sample_points = sample_points
        self.with_remission = with_remission
        self.should_map = should_map
        self.rs = random_state if random_state is not None else np.random.RandomState()
        self.config = load_config(config_file)
        self.scan = laserscan.SemLaserScan(
            nclasses=num_classes, sem_color_dict=self.config["color_map"]
        )
        self.points_name, self.label_name = _list_sequence_files(
            root, self.config["split"][split]
        )
        if random_sample:
            random.Random(SHUFFLE_SEED).shuffle(self.points_name)
            random.Random(SHUFFLE_SEED).shuffle(self.label_name)
            total = len(self.points_name)
            self.points_name = self.points_name[: int(total * random_rate)]
            self.label_name = self.label_name[: int(total * random_rate)]
        self.label_weights_lut = _label_weights_lut()
        if should_map:
            self.remap_lut = _build_remap_lut(self.config["learning_map"])

    def __getitem__(self, index):
        self.scan.open_scan(self.points_name[index])
        self.scan.open_label(self.label_name[index])
        points = self.scan.points
        label = self.scan.sem_label
        if self.should_map:
            label = self.remap_lut[label]
        coordmax = np.max(points[:, 0:3], axis=0)
        coordmin = np.min(points[:, 0:3], axis=0)
        nsub_x = int(np.ceil((coordmax[0] - coordmin[0]) / self.block_size))
        nsub_y = int(np.ceil((coordmax[1] - coordmin[1]) / self.block_size))
        point_sets, semantic_segs, sample_weights = [], [], []
        for i in range(nsub_x):
            for j in range(nsub_y):
                curmin = coordmin + [i * self.block_size, j * self.block_size, 0]
                curmax = coordmin + [
                    (i + 1) * self.block_size,
                    (j + 1) * self.block_size,
                    coordmax[2] - coordmin[2],
                ]
                curchoice = (
                    np.sum(
                        (points[:, 0:3] >= (curmin - 0.2)) * (points[:, 0:3] <= (curmax + 0.2)),
                        axis=1,
                    )
                    == 3
                )
                cur_point_set = points[curchoice, 0:3]
                cur_point_full = points[curchoice, :]
                cur_semantic_seg = label[curchoice]
                if len(cur_semantic_seg) == 0:
                    continue
                mask = (
                    np.sum(
                        (cur_point_set >= (curmin - self.padding))
                        * (cur_point_set <= (curmax + self.padding)),
                        axis=1,
                    )
                    == 3
                )
                choice = self.rs.choice(len(cur_semantic_seg), self.sample_points, replace=True)
                point_set = cur_point_full[choice, :]
                if self.with_remission:
                    remissions = self.scan.remissions[curchoice][choice]
                    point_set = np.concatenate((point_set, remissions[:, None]), axis=1)
                semantic_seg = cur_semantic_seg[choice]
                mask = mask[choice]
                sample_weight = self.label_weights_lut[semantic_seg]
                sample_weight *= mask
                point_sets.append(point_set[None])
                semantic_segs.append(semantic_seg[None])
                sample_weights.append(sample_weight[None])
        return (
            np.concatenate(point_sets, axis=0),
            np.concatenate(semantic_segs, axis=0),
            np.concatenate(sample_weights, axis=0),
        )

    def __len__(self):
        return len(self.points_name)


class SemanticKittiDatasetSlidingWindow:
    """Strided sliding-window inference dataset (semantic_kitti_dataset.py:217-358)."""

    def __init__(
        self,
        root,
        sample_points=8192,
        block_size=10,
        stride=3.3,
        num_classes=20,
        split="test",
        with_remission=False,
        config_file: Optional[str] = None,
        should_map=True,
        random_state: Optional[np.random.RandomState] = None,
    ):
        assert split in SPLITS
        self.root = root
        self.split = split
        self.stride = stride
        self.block_size = block_size
        self.block_points = sample_points
        self.should_map = should_map
        self.with_remission = with_remission
        self.rs = random_state if random_state is not None else np.random.RandomState()
        self.config = load_config(config_file)
        self.scan = laserscan.SemLaserScan(
            nclasses=num_classes, sem_color_dict=self.config["color_map"]
        )
        self.color_map = np.array(
            [self.config["color_map"][v] for v in self.config["learning_map_inv"].values()]
        )
        self.points_name, self.label_name = _list_sequence_files(
            root, self.config["split"][split], need_labels=(split != "test")
        )
        if should_map:
            self.remap_lut = _build_remap_lut(self.config["learning_map"])

    @staticmethod
    def chunks(l, n):
        for i in range(0, len(l), n):
            yield l[i : i + n]

    @staticmethod
    def split_data(data, idx):
        return [np.expand_dims(data[idx[i]], axis=0) for i in range(len(idx))]

    @staticmethod
    def nearest_dist(block_center, block_center_list):
        dist = [np.linalg.norm(c - block_center, ord=2) for c in block_center_list]
        return int(np.argsort(dist)[0])

    def whole_scan(self, index):
        """The entire scan as ONE sample (single-pass inference path).

        No chopping, no merging: the whole-scene path feeds all points
        through the model at once (the reference chops every scan into
        strided blocks, semantic_kitti_dataset.py:217-358). Coordinates stay at raw world
        scale, matching the block paths (neither train nor sliding-window
        blocks recenter).

        Returns (points (N, 3+f) float32, labels (N,) or None).
        """
        self.scan.open_scan(self.points_name[index])
        pts = self.scan.points
        if self.with_remission:
            pts = np.concatenate([pts, self.scan.remissions[:, None]], axis=1)
        label = None
        if self.split != "test":
            self.scan.open_label(self.label_name[index])
            label = self.scan.sem_label
            if self.should_map:
                label = self.remap_lut[label]
        return pts.astype(np.float32), label

    def __getitem__(self, index):
        self.scan.open_scan(self.points_name[index])
        point_set_ini = self.scan.points
        label = None
        if self.split != "test":
            self.scan.open_label(self.label_name[index])
            label = self.scan.sem_label
            if self.should_map:
                label = self.remap_lut[label]

        coordmax = np.max(point_set_ini[:, 0:3], axis=0)
        coordmin = np.min(point_set_ini[:, 0:3], axis=0)
        nsub_x = int(np.ceil((coordmax[0] - coordmin[0]) / self.stride))
        nsub_y = int(np.ceil((coordmax[1] - coordmin[1]) / self.stride))
        point_sets, point_idxs, block_center = [], [], []
        for i in range(nsub_x):
            for j in range(nsub_y):
                curmin = coordmin + [i * self.stride, j * self.stride, 0]
                curmax = curmin + [self.block_size, self.block_size, coordmax[2] - coordmin[2]]
                curchoice = (
                    np.sum(
                        (point_set_ini[:, 0:3] >= (curmin - 0.2))
                        * (point_set_ini[:, 0:3] <= (curmax + 0.2)),
                        axis=1,
                    )
                    == 3
                )
                curchoice_idx = np.where(curchoice)[0]
                cur_point_set = point_set_ini[curchoice, :]
                if self.with_remission:
                    cur_point_set = np.concatenate(
                        (cur_point_set, self.scan.remissions[curchoice][:, None]), axis=1
                    )
                point_sets.append(cur_point_set)
                point_idxs.append(curchoice_idx)
                block_center.append((curmin[0:2] + curmax[0:2]) / 2.0)

        # merge small blocks
        num_blocks = len(point_sets)
        block_idx = 0
        while block_idx < num_blocks:
            if point_sets[block_idx].shape[0] > 4096:
                block_idx += 1
                continue
            small_block_data = point_sets[block_idx].copy()
            small_block_idxs = point_idxs[block_idx].copy()
            small_block_center = block_center[block_idx].copy()
            point_sets.pop(block_idx)
            point_idxs.pop(block_idx)
            block_center.pop(block_idx)
            nearest = self.nearest_dist(small_block_center, block_center)
            point_sets[nearest] = np.concatenate((point_sets[nearest], small_block_data), axis=0)
            point_idxs[nearest] = np.concatenate((point_idxs[nearest], small_block_idxs), axis=0)
            num_blocks = len(point_sets)

        # divide large blocks
        num_blocks = len(point_sets)
        div_blocks, div_blocks_idxs = [], []
        for block_idx in range(num_blocks):
            cur_num_pts = point_sets[block_idx].shape[0]
            point_idx_block = np.arange(cur_num_pts)
            if point_idx_block.shape[0] % self.block_points != 0:
                makeup_num = self.block_points - point_idx_block.shape[0] % self.block_points
                self.rs.shuffle(point_idx_block)
                point_idx_block = np.concatenate(
                    (point_idx_block, point_idx_block[0:makeup_num].copy())
                )
            self.rs.shuffle(point_idx_block)
            sub_blocks = list(self.chunks(point_idx_block, self.block_points))
            div_blocks += self.split_data(point_sets[block_idx], sub_blocks)
            div_blocks_idxs += self.split_data(point_idxs[block_idx], sub_blocks)
        div_blocks = np.concatenate(div_blocks, axis=0)
        div_blocks_idxs = np.concatenate(div_blocks_idxs, axis=0)
        if self.split != "test":
            return div_blocks, div_blocks_idxs, point_set_ini, label
        return div_blocks, div_blocks_idxs, point_set_ini

    def __len__(self):
        return len(self.points_name)
