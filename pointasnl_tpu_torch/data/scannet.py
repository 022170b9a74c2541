"""ScanNet v2 segmentation datasets (random-crop pickle pipeline), the port's
numpy copy of ``pointasnl_tpu/data/scannet.py``: for the same pickles and
the same ``random_state`` it gives the same arrays, to the bit.

Behavioral parity with ScanNet/scannet_dataset.py over the
`scannet_{split}_rgb21c_pointid.pickle` dumps (four pickled lists: the
scenes' points with RGB, their labels, point ids and point counts):
- ScannetDataset: random 1.5m x 1.5m column crops with the >=70% annotated +
  voxel-occupancy validity retry (x10), 8192 points sampled with replacement,
  per-point weight = class-freq^(-1/3) * in-box mask (:19-64).
- ScannetDatasetWholeScene: non-overlapping 1.5m tiles (:69-129).
- ScannetDatasetWholeSceneSlidingWindow: strided blocks with 20% injected
  noise points, small-block merge + large-block split into exact block_points
  chunks, returning original point ids for vote pooling (:135-300).
"""

from __future__ import annotations

import math
import os
import pickle
from typing import List, Optional

import numpy as np

NUM_CLASSES = 21


def _load_pickle(path):
    with open(path, "rb") as fp:
        scene_points_list = pickle.load(fp)
        semantic_labels_list = pickle.load(fp)
        scene_points_id = pickle.load(fp)
        scene_points_num = pickle.load(fp)
    return scene_points_list, semantic_labels_list, scene_points_id, scene_points_num


def _class_weights_pow13(semantic_labels_list, num_class=NUM_CLASSES):
    """class-frequency^(-1/3) weights (scannet_dataset.py:19-26)."""
    labelweights = np.zeros(num_class)
    for seg in semantic_labels_list:
        tmp, _ = np.histogram(seg, range(num_class + 1))
        labelweights += tmp
    labelweights = labelweights.astype(np.float32)
    labelweights = labelweights / np.sum(labelweights)
    return np.power(np.amax(labelweights[1:]) / labelweights, 1 / 3.0)


class ScannetDataset:
    """Random-crop training dataset (scannet_dataset.py:6-67)."""

    def __init__(
        self,
        root,
        block_points=8192,
        split="train",
        with_rgb=False,
        random_state: Optional[np.random.RandomState] = None,
    ):
        self.npoints = block_points
        self.root = root
        self.with_rgb = with_rgb
        self.split = split
        self.rs = random_state if random_state is not None else np.random.RandomState()
        path = os.path.join(root, f"scannet_{split}_rgb21c_pointid.pickle")
        (
            self.scene_points_list,
            self.semantic_labels_list,
            self.scene_points_id,
            self.scene_points_num,
        ) = _load_pickle(path)

        if split == "train":
            self.labelweights = _class_weights_pow13(self.semantic_labels_list)
        elif split == "val":
            self.labelweights = np.ones(NUM_CLASSES)

    def __getitem__(self, index):
        """Draw one valid 1.5m x 1.5m column crop, 8192-sampled.

        The crop protocol's constants ARE the behavioral contract
        (scannet_dataset.py:27-66): a random seed point centers a
        1.5x1.5xfull-height column; candidate membership uses a 0.2m
        ring margin while the weight mask uses a 0.01m epsilon box; crop
        validity = >=70% annotated points AND >=2% occupancy of a
        31x31x62 voxelization; up to 10 redraws before accepting whatever
        the last draw produced.
        """
        if self.with_rgb:
            points = self.scene_points_list[index]
        else:
            points = self.scene_points_list[index][:, 0:3]
        labels = self.semantic_labels_list[index].astype(np.int32)
        scene_max = np.max(points[:, 0:3], axis=0)
        scene_min = np.min(points[:, 0:3], axis=0)
        crop_xyz = points[:, 0:3]
        crop_points = points
        crop_labels = labels
        in_box = np.ones(len(labels), bool)
        for _ in range(10):
            center = points[self.rs.choice(len(labels), 1)[0], 0:3]
            box_min = center - [0.75, 0.75, 1.5]
            box_max = center + [0.75, 0.75, 1.5]
            box_min[2] = scene_min[2]  # full scene height
            box_max[2] = scene_max[2]
            candidate = (
                np.sum(
                    (points[:, 0:3] >= (box_min - 0.2)) * (points[:, 0:3] <= (box_max + 0.2)),
                    axis=1,
                )
                == 3
            )
            crop_xyz = points[candidate, 0:3]
            crop_points = points[candidate, :]
            crop_labels = labels[candidate]
            if len(crop_labels) == 0:
                continue
            in_box = (
                np.sum(
                    (crop_xyz >= (box_min - 0.01)) * (crop_xyz <= (box_max + 0.01)), axis=1
                )
                == 3
            )
            voxels = np.ceil((crop_xyz[in_box, :] - box_min) / (box_max - box_min) * [31.0, 31.0, 62.0])
            voxels = np.unique(voxels[:, 0] * 31.0 * 62.0 + voxels[:, 1] * 62.0 + voxels[:, 2])
            valid = (
                np.sum(crop_labels > 0) / len(crop_labels) >= 0.7
                and len(voxels) / 31.0 / 31.0 / 62.0 >= 0.02
            )
            if valid:
                break
        choice = self.rs.choice(len(crop_labels), self.npoints, replace=True)
        points = crop_points[choice, :]
        labels = crop_labels[choice]
        in_box = in_box[choice]
        sample_weight = self.labelweights[labels]
        sample_weight *= in_box  # ring-margin points vote 0 in the loss
        return points, labels, sample_weight

    def __len__(self):
        return len(self.scene_points_list)


class ScannetDatasetWholeScene:
    """Non-overlapping 1.5m tiling for whole-scene eval (scannet_dataset.py:69-132)."""

    def __init__(
        self,
        root,
        block_points=8192,
        split="val",
        with_rgb=False,
        random_state: Optional[np.random.RandomState] = None,
    ):
        self.npoints = block_points
        self.root = root
        self.with_rgb = with_rgb
        self.split = split
        self.rs = random_state if random_state is not None else np.random.RandomState()
        path = os.path.join(root, f"scannet_{split}_rgb21c_pointid.pickle")
        (
            self.scene_points_list,
            self.semantic_labels_list,
            self.scene_points_id,
            self.scene_points_num,
        ) = _load_pickle(path)
        if split == "train":
            labelweights = np.zeros(NUM_CLASSES)
            for seg in self.semantic_labels_list:
                tmp, _ = np.histogram(seg, range(NUM_CLASSES + 1))
                labelweights += tmp
            labelweights = labelweights.astype(np.float32)
            labelweights = labelweights / np.sum(labelweights)
            self.labelweights = 1 / np.log(1.2 + labelweights)
        elif split == "val":
            self.labelweights = np.ones(NUM_CLASSES)

    def __getitem__(self, index):
        if self.with_rgb:
            point_set_ini = self.scene_points_list[index]
        else:
            point_set_ini = self.scene_points_list[index][:, 0:3]
        semantic_seg_ini = self.semantic_labels_list[index].astype(np.int32)
        coordmax = np.max(point_set_ini[:, 0:3], axis=0)
        coordmin = np.min(point_set_ini[:, 0:3], axis=0)
        nsub_x = int(np.ceil((coordmax[0] - coordmin[0]) / 1.5))
        nsub_y = int(np.ceil((coordmax[1] - coordmin[1]) / 1.5))
        point_sets, semantic_segs, sample_weights = [], [], []
        for i in range(nsub_x):
            for j in range(nsub_y):
                curmin = coordmin + [i * 1.5, j * 1.5, 0]
                curmax = coordmin + [(i + 1) * 1.5, (j + 1) * 1.5, coordmax[2] - coordmin[2]]
                curchoice = (
                    np.sum(
                        (point_set_ini[:, 0:3] >= (curmin - 0.2))
                        * (point_set_ini[:, 0:3] <= (curmax + 0.2)),
                        axis=1,
                    )
                    == 3
                )
                cur_point_set = point_set_ini[curchoice, 0:3]
                cur_point_full = point_set_ini[curchoice, :]
                cur_semantic_seg = semantic_seg_ini[curchoice]
                if len(cur_semantic_seg) == 0:
                    continue
                mask = (
                    np.sum(
                        (cur_point_set >= (curmin - 0.001)) * (cur_point_set <= (curmax + 0.001)),
                        axis=1,
                    )
                    == 3
                )
                choice = self.rs.choice(len(cur_semantic_seg), self.npoints, replace=True)
                point_set = cur_point_full[choice, :]
                semantic_seg = cur_semantic_seg[choice]
                mask = mask[choice]
                sample_weight = self.labelweights[semantic_seg]
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
        return len(self.scene_points_list)


class ScannetDatasetWholeSceneSlidingWindow:
    """Strided sliding-window eval dataset with vote-pooling indices
    (scannet_dataset.py:135-300)."""

    def __init__(
        self,
        root,
        split="test",
        num_class=NUM_CLASSES,
        block_points=8192,
        with_rgb=True,
        stride=0.5,
        random_state: Optional[np.random.RandomState] = None,
    ):
        self.root = root
        self.split = split
        self.stride = stride
        self.with_rgb = with_rgb
        self.block_points = block_points
        self.point_num: List[int] = []
        self.rs = random_state if random_state is not None else np.random.RandomState()
        path = os.path.join(root, f"scannet_{split}_rgb21c_pointid.pickle")
        (
            self.scene_points_list,
            self.semantic_labels_list,
            self.scene_points_id,
            self.scene_points_num,
        ) = _load_pickle(path)
        if split == "train":
            labelweights = np.zeros(num_class)
            for seg in self.semantic_labels_list:
                self.point_num.append(seg.shape[0])
                tmp, _ = np.histogram(seg, range(num_class + 1))
                labelweights += tmp
            labelweights = labelweights.astype(np.float32)
            labelweights = labelweights / np.sum(labelweights)
            self.labelweights = np.power(np.amax(labelweights) / labelweights, 1 / 3.0)
        else:
            self.labelweights = np.ones(num_class)
            for seg in self.semantic_labels_list:
                self.point_num.append(seg.shape[0])

    def whole_scene(self, index):
        """The entire scene as ONE sample (single-pass inference path).

        Applies the same 20%-noise robustness protocol as __getitem__
        (scannet_dataset.py:192-212) but skips the block chopping: the
        single-pass path feeds all points through the model at once, with
        blockwise non-local attention and the spatially-pruned kNN.

        Returns (points (N, 3+f), labels (N,), smpw (N,), point_idx (N,)).
        """
        if self.with_rgb:
            point_set = self.scene_points_list[index].copy()
        else:
            point_set = self.scene_points_list[index][:, 0:3].copy()
        semantic_seg = self.semantic_labels_list[index].astype(np.int32).copy()

        noise_ratio = 0.2
        raw_xyz = point_set[:, 0:3]
        num_raw_points = raw_xyz.shape[0]
        centroid = np.mean(raw_xyz, axis=0, keepdims=True)
        normalized_xyz = raw_xyz - centroid
        max_length = max(abs(np.max(normalized_xyz)), abs(np.min(normalized_xyz)))
        normalized_xyz = normalized_xyz / max_length
        num_noise = math.ceil(num_raw_points * noise_ratio)
        choices = self.rs.choice(num_raw_points, num_noise)
        new_noise_xyz = normalized_xyz[choices]
        shift = (self.rs.randn(num_noise, 3) - 0.5) / 0.5 * 0.002
        point_set[choices, 0:3] = (new_noise_xyz + shift) * max_length + centroid
        semantic_seg[choices] = 0

        smpw = self.labelweights[semantic_seg]
        point_idx = np.arange(num_raw_points)
        return point_set, semantic_seg, smpw, point_idx

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

    def __getitem__(self, index):
        delta = self.stride
        if self.with_rgb:
            point_set_ini = self.scene_points_list[index]
        else:
            point_set_ini = self.scene_points_list[index][:, 0:3]
        semantic_seg_ini = self.semantic_labels_list[index].astype(np.int32)

        # Inject 20% noise points (the robustness protocol, :192-212).
        noise_ratio = 0.2
        raw_xyz = point_set_ini[:, 0:3]
        num_raw_points = raw_xyz.shape[0]
        centroid = np.mean(raw_xyz, axis=0, keepdims=True)
        normalized_xyz = raw_xyz - centroid
        max_length = max(abs(np.max(normalized_xyz)), abs(np.min(normalized_xyz)))
        normalized_xyz = normalized_xyz / max_length
        num_noise = math.ceil(num_raw_points * noise_ratio)
        choices = self.rs.choice(num_raw_points, num_noise)
        new_noise_xyz = normalized_xyz[choices]
        shift = (self.rs.randn(num_noise, 3) - 0.5) / 0.5 * 0.002
        new_noise_xyz = new_noise_xyz + shift
        point_set_ini = point_set_ini.copy()
        semantic_seg_ini = semantic_seg_ini.copy()
        point_set_ini[choices, 0:3] = new_noise_xyz * max_length + centroid
        semantic_seg_ini[choices] = 0

        coordmax = np.max(point_set_ini[:, 0:3], axis=0)
        coordmin = np.min(point_set_ini[:, 0:3], axis=0)
        nsub_x = int(np.ceil((coordmax[0] - coordmin[0]) / delta))
        nsub_y = int(np.ceil((coordmax[1] - coordmin[1]) / delta))
        point_sets, semantic_segs, sample_weights, point_idxs, block_center = [], [], [], [], []
        for i in range(nsub_x):
            for j in range(nsub_y):
                curmin = coordmin + [i * delta, j * delta, 0]
                curmax = curmin + [1.5, 1.5, coordmax[2] - coordmin[2]]
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
                cur_semantic_seg = semantic_seg_ini[curchoice]
                if len(cur_semantic_seg) == 0:
                    continue
                mask = (
                    np.sum(
                        (cur_point_set[:, 0:3] >= (curmin - 0.001))
                        * (cur_point_set[:, 0:3] <= (curmax + 0.001)),
                        axis=1,
                    )
                    == 3
                )
                sample_weight = self.labelweights[cur_semantic_seg]
                sample_weight *= mask
                point_sets.append(cur_point_set)
                semantic_segs.append(cur_semantic_seg)
                sample_weights.append(sample_weight)
                point_idxs.append(curchoice_idx)
                block_center.append((curmin[0:2] + curmax[0:2]) / 2.0)

        # Merge small blocks (<= 4096 pts) into their nearest neighbor block.
        num_blocks = len(point_sets)
        block_idx = 0
        while block_idx < num_blocks:
            if point_sets[block_idx].shape[0] > 4096:
                block_idx += 1
                continue
            small_block_data = point_sets[block_idx].copy()
            small_block_seg = semantic_segs[block_idx].copy()
            small_block_smpw = sample_weights[block_idx].copy()
            small_block_idxs = point_idxs[block_idx].copy()
            small_block_center = block_center[block_idx].copy()
            point_sets.pop(block_idx)
            semantic_segs.pop(block_idx)
            sample_weights.pop(block_idx)
            point_idxs.pop(block_idx)
            block_center.pop(block_idx)
            nearest = self.nearest_dist(small_block_center, block_center)
            point_sets[nearest] = np.concatenate((point_sets[nearest], small_block_data), axis=0)
            semantic_segs[nearest] = np.concatenate((semantic_segs[nearest], small_block_seg), axis=0)
            sample_weights[nearest] = np.concatenate(
                (sample_weights[nearest], small_block_smpw), axis=0
            )
            point_idxs[nearest] = np.concatenate((point_idxs[nearest], small_block_idxs), axis=0)
            num_blocks = len(point_sets)

        # Divide large blocks into exact block_points chunks (dup-pad + shuffle).
        num_blocks = len(point_sets)
        div_blocks, div_blocks_seg, div_blocks_smpw, div_blocks_idxs = [], [], [], []
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
            div_blocks_seg += self.split_data(semantic_segs[block_idx], sub_blocks)
            div_blocks_smpw += self.split_data(sample_weights[block_idx], sub_blocks)
            div_blocks_idxs += self.split_data(point_idxs[block_idx], sub_blocks)
        return (
            np.concatenate(div_blocks, axis=0),
            np.concatenate(div_blocks_seg, axis=0),
            np.concatenate(div_blocks_smpw, axis=0),
            np.concatenate(div_blocks_idxs, axis=0),
        )

    def __len__(self):
        return len(self.scene_points_list)
