"""ScanNet v2 preprocessing: raw *_vh_clean_2.ply scans -> per-split pickles,
the port's copy of ``pointasnl_tpu/data/prepare_scannet.py`` (numpy, through
the port's ``data/ply.py``): the same scans give the same pickles.

Behavioral parity with ScanNet/prepare_scannet.py: reads the rgb mesh +
labels ply per scene, drops unannotated vertices (label 0 or >=41), remaps
NYU40 ids to the 21-class benchmark set (:13-23), and pickles four lists
(points_rgb, labels21, original point ids, original point counts) in the
`scannet_{split}_rgb21c_pointid.pickle` layout the datasets consume.

    python -m pointasnl_tpu_torch.data.prepare_scannet --root <ScanNet> --out_dir <dir>
"""

from __future__ import annotations

import os
import pickle
from typing import List

import numpy as np

from pointasnl_tpu_torch.data.ply import read_ply

# The 20 benchmark NYU40 class ids (+0 for unannotated) — the ScanNet v2
# evaluation subset (prepare_scannet.py:13).
TEST_CLASS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]


def gen_label_map() -> np.ndarray:
    """NYU40 id -> 21-class training id (unlisted ids -> 0)."""
    label_map = np.zeros(41)
    for i in range(41):
        if i in TEST_CLASS:
            label_map[i] = TEST_CLASS.index(i)
    return label_map


def remove_unannotated(scene_data, scene_label, scene_data_id):
    keep_idx = np.where((scene_label > 0) & (scene_label < 41))
    return scene_data[keep_idx], scene_label[keep_idx], scene_data_id[keep_idx]


def gen_pickle(split: str = "val", root: str = "ScanNet", out_dir: str = "."):
    scans_dir = os.path.join(root, "scans_test" if split == "test" else "scans")
    file_list = os.path.join(root, f"scannetv2_{split}.txt")
    with open(file_list) as fl:
        scene_ids = fl.read().splitlines()

    scene_data: List[np.ndarray] = []
    scene_data_labels: List[np.ndarray] = []
    scene_data_id: List[np.ndarray] = []
    scene_data_num: List[int] = []
    label_map = gen_label_map()
    for i, sid in enumerate(scene_ids):
        rgb_ply = os.path.join(scans_dir, sid, f"{sid}_vh_clean_2.ply")
        vertex = read_ply(rgb_ply)
        pts = np.stack(
            (
                vertex["x"],
                vertex["y"],
                vertex["z"],
                vertex["red"],
                vertex["green"],
                vertex["blue"],
            ),
            axis=-1,
        ).astype(np.float32)
        num = pts.shape[0]
        point_id = np.arange(num)
        if split != "test":
            labels_ply = os.path.join(scans_dir, sid, f"{sid}_vh_clean_2.labels.ply")
            lab_vertex = read_ply(labels_ply)
            labels = np.asarray(lab_vertex["label"])
            pts, labels, point_id = remove_unannotated(pts, labels, point_id)
        else:
            labels = np.zeros((num,), np.int32)
        labels = label_map[labels.astype(np.int64)]
        scene_data.append(pts)
        scene_data_labels.append(labels)
        scene_data_id.append(point_id)
        scene_data_num.append(num)

    out_path = os.path.join(out_dir, f"scannet_{split}_rgb21c_pointid.pickle")
    with open(out_path, "wb") as f:
        pickle.dump(scene_data, f, protocol=0)
        pickle.dump(scene_data_labels, f, protocol=0)
        pickle.dump(scene_data_id, f, protocol=0)
        pickle.dump(scene_data_num, f, protocol=0)
    return out_path


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default="data/ScanNet", help="ScanNet v2 dataset root")
    ap.add_argument("--out_dir", default=".", help="output directory for pickles")
    ap.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    args = ap.parse_args()
    for split in args.splits:
        print(f"preparing {split}...")
        gen_pickle(split=split, root=args.root, out_dir=args.out_dir)
    print("Done")
