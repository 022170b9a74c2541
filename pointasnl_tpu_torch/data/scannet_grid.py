"""ScanNet grid-sampled dataset (KPConv-style, the 66.6-mIoU recipe), the
port's numpy and scipy copy of ``pointasnl_tpu/data/scannet_grid.py``.

Behavioral parity with ScanNet/scannet_dataset_grid.py:
- prepare_pointcloud_ply (:110-222): per scene, axis-align vertices, transfer
  aggregation-json labels to NYU40 ids, rasterize the mesh at 3mm, grid
  subsample at 1cm, cache as ply (training_points/test_points + *_meshes).
- load_subsampled_clouds(dl) (:224-433): per-voxel-size grid subsample
  (cached as ply) and a KD-tree a cloud, plus validation/test reprojection
  indices from mesh vertices into the subsampled cloud.
- spatially_regular_gen (:482-540): potential-driven center picking (min
  potential cloud/point + sigma=0.35 jitter), kNN crop of npoint+buffer (or
  in_radius ball), shuffle/truncate/dup-pad to fixed npoint, distance-falloff
  potential update.
- per-cloud augmentation + color drop are applied by the batch iterator
  (grid_pipeline.augment_points — the tf_map equivalent).

The KD-trees are scipy's ``cKDTree`` (the JAX package uses sklearn's
``KDTree``), built at load from the subsampled ply: the port writes no tree
cache, and never reads or writes the JAX package's
``input_<dl>/<cloud>_KDTree.pkl``. The subsampled plys and the projection
pickles hold plain numpy arrays and are shared, so a data directory either
package prepared serves both. A ball query's indices are put in ascending
order before the crop's permutation (the JAX package keeps sklearn's order,
which depends on the tree's layout); kNN crops keep the order by distance.
Given a sorted ball, the batches equal the JAX package's to the bit.
"""

from __future__ import annotations

import json
import pickle
import time
from os import listdir, makedirs
from os.path import exists, isfile, join
from typing import Dict, Iterator, List, Optional

import numpy as np
from scipy.spatial import cKDTree

from pointasnl_tpu_torch.data.grid_pipeline import (
    GridConfig,
    augment_points,
    ball_indices,
    knn_indices,
    maybe_drop_colors,
    nearest_indices,
    parallel_map,
)
from pointasnl_tpu_torch.data.grid_subsampling import compute as _gs_compute
from pointasnl_tpu_torch.data.mesh import rasterize_mesh
from pointasnl_tpu_torch.data.ply import read_ply, write_ply


def grid_subsampling(points, features=None, labels=None, sampleDl=0.1, verbose=0):
    """Keyword-juggling wrapper matching the reference helper (:20-38)."""
    if features is None and labels is None:
        return _gs_compute(points, sampleDl=sampleDl, verbose=verbose)
    if labels is None:
        return _gs_compute(points, features=features, sampleDl=sampleDl, verbose=verbose)
    if features is None:
        return _gs_compute(points, classes=labels, sampleDl=sampleDl, verbose=verbose)
    return _gs_compute(points, features=features, classes=labels, sampleDl=sampleDl, verbose=verbose)


class ScannetGridDataset:
    """ScanNet for segmentation with grid-sampled inputs."""

    # NYU40 ids of the 20 benchmark classes + 0 (scannet_dataset_grid.py:49-69)
    LABEL_TO_NAMES = {
        0: "unclassified", 1: "wall", 2: "floor", 3: "cabinet", 4: "bed",
        5: "chair", 6: "sofa", 7: "table", 8: "door", 9: "window",
        10: "bookshelf", 11: "picture", 12: "counter", 14: "desk",
        16: "curtain", 24: "refridgerator", 28: "shower curtain",
        33: "toilet", 34: "sink", 36: "bathtub", 39: "otherfurniture",
    }

    # Published per-class weights of the recipe (scannet_dataset_grid.py:80-82)
    LABEL_WEIGHTS = np.array(
        [1.1808748, 1.0, 1.0941308, 1.9492522, 2.2317414, 1.6149306, 2.3081288,
         2.040714, 1.8799158, 1.9753349, 2.3331642, 3.950435, 3.9714756,
         2.5003498, 2.4034925, 3.8694403, 4.572348, 4.5791054, 4.88347,
         4.448638, 2.0478268]
    )

    def __init__(
        self,
        path: str,
        npoint: int,
        load_test: bool = False,
        buffer: int = 1024,
        debug: bool = False,
        trainval: bool = False,
        random_state: Optional[np.random.RandomState] = None,
        prepare: bool = True,
    ):
        self.debug = debug
        self.npoint = npoint
        self.buffer = buffer
        self.path = path
        self.trainval = trainval
        self.load_test = load_test
        self.rs = random_state if random_state is not None else np.random.RandomState()

        self.label_to_names = dict(self.LABEL_TO_NAMES)
        self.num_classes = len(self.label_to_names)
        self.label_values = np.sort(list(self.label_to_names.keys()))
        self.label_names = [self.label_to_names[k] for k in self.label_values]
        self.label_to_idx = {l: i for i, l in enumerate(self.label_values)}
        self.name_to_label = {v: k for k, v in self.label_to_names.items()}
        self.ignored_labels = np.sort([0])
        self.label_weights = self.LABEL_WEIGHTS.copy()

        self.train_path = join(path, "training_points")
        self.test_path = join(path, "test_points")
        if trainval:
            self.validation_clouds = []
        else:
            self.validation_clouds = np.loadtxt(join(path, "scannet_v2_val.txt"), dtype=str)
        self.all_splits: List[int] = []

        if prepare:
            self.prepare_pointcloud_ply()

    # ------------------------------------------------------------ prepare

    def prepare_pointcloud_ply(self):
        """Raw scans -> rasterized, 1cm-subsampled point plys (+label meshes)."""
        t0 = time.time()
        paths = [join(self.path, "scans"), join(self.path, "scans_test")]
        new_paths = [self.train_path, self.test_path]
        mesh_paths = [join(self.path, "training_meshes"), join(self.path, "test_meshes")]

        annot_to_nyuID = {}
        if not self.trainval:
            label_files = join(self.path, "scannetv2-labels.combined.tsv")
            if exists(label_files):
                with open(label_files, "r") as f:
                    lines = f.readlines()
                names1 = [line.split("\t")[1] for line in lines[1:]]
                IDs = [int(line.split("\t")[4]) for line in lines[1:]]
                annot_to_nyuID = {n: i for n, i in zip(names1, IDs)}

        for scan_path, new_path, mesh_path in zip(paths, new_paths, mesh_paths):
            if not exists(new_path):
                makedirs(new_path)
            if not exists(mesh_path):
                makedirs(mesh_path)
            if not exists(scan_path):
                continue
            scenes = np.sort([f for f in listdir(scan_path)])
            for scene in scenes:
                if exists(join(new_path, scene + ".ply")):
                    continue
                vertex_data, faces = read_ply(
                    join(scan_path, scene, scene + "_vh_clean_2.ply"), triangular_mesh=True
                )
                vertices = np.vstack((vertex_data["x"], vertex_data["y"], vertex_data["z"])).T
                vertices_colors = np.vstack(
                    (vertex_data["red"], vertex_data["green"], vertex_data["blue"])
                ).T
                vertices_labels = np.zeros(vertices.shape[0], dtype=np.int32)

                if new_path == self.train_path:
                    # axis alignment from the scene meta txt
                    align_mat = None
                    with open(join(scan_path, scene, scene + ".txt"), "r") as txtfile:
                        for line in txtfile.readlines():
                            line = line.split()
                            if line and line[0] == "axisAlignment":
                                align_mat = (
                                    np.array([float(x) for x in line[2:]])
                                    .reshape([4, 4])
                                    .astype(np.float32)
                                )
                    if align_mat is not None:
                        R = align_mat[:3, :3]
                        T = align_mat[:3, 3]
                        vertices = vertices.dot(R.T) + T

                    with open(
                        join(scan_path, scene, scene + "_vh_clean_2.0.010000.segs.json"), "r"
                    ) as f:
                        segIndices = np.array(json.load(f)["segIndices"])
                    with open(
                        join(scan_path, scene, scene + "_vh_clean.aggregation.json"), "r"
                    ) as f:
                        aggregation = json.load(f)
                    for segGroup in aggregation["segGroups"]:
                        c_name = segGroup["label"]
                        if c_name in annot_to_nyuID:
                            nyuID = annot_to_nyuID[c_name]
                            if nyuID in self.label_values:
                                for segment in segGroup["segments"]:
                                    vertices_labels[segIndices == segment] = nyuID

                    write_ply(
                        join(mesh_path, scene + "_mesh.ply"),
                        [vertices.astype(np.float32), vertices_colors, vertices_labels],
                        ["x", "y", "z", "red", "green", "blue", "class"],
                        triangular_faces=faces,
                    )
                else:
                    write_ply(
                        join(mesh_path, scene + "_mesh.ply"),
                        [vertices.astype(np.float32), vertices_colors],
                        ["x", "y", "z", "red", "green", "blue"],
                        triangular_faces=faces,
                    )

                points, associated_vert_inds = rasterize_mesh(vertices, faces, 0.003)
                sub_points, sub_vert_inds = grid_subsampling(
                    points, labels=associated_vert_inds, sampleDl=0.01
                )
                sub_colors = vertices_colors[sub_vert_inds.ravel(), :]
                if new_path == self.train_path:
                    sub_labels = vertices_labels[sub_vert_inds.ravel()]
                    write_ply(
                        join(new_path, scene + ".ply"),
                        [sub_points, sub_colors, sub_labels, sub_vert_inds],
                        ["x", "y", "z", "red", "green", "blue", "class", "vert_ind"],
                    )
                else:
                    write_ply(
                        join(new_path, scene + ".ply"),
                        [sub_points, sub_colors, sub_vert_inds],
                        ["x", "y", "z", "red", "green", "blue", "vert_ind"],
                    )
        if exists(paths[0]) or exists(paths[1]):
            print(f"ply preparation done in {time.time() - t0:.1f}s")

    # --------------------------------------------------------------- load

    def load_subsampled_clouds(self, subsampling_parameter: float):
        """Per-voxel-size subsampled clouds (cached as ply), a cKDTree a
        cloud (built here from the subsampled points), and the projections."""
        if 0 < subsampling_parameter <= 0.01:
            raise ValueError("subsampling_parameter too low (should be over 1 cm)")

        tree_path = join(self.path, "input_{:.3f}".format(subsampling_parameter))
        if not exists(tree_path):
            makedirs(tree_path)

        self.train_files = np.sort(
            [join(self.train_path, f) for f in listdir(self.train_path) if f[-4:] == ".ply"]
        )
        self.test_files = np.sort(
            [join(self.test_path, f) for f in listdir(self.test_path) if f[-4:] == ".ply"]
        ) if exists(self.test_path) else np.array([], dtype=str)

        if self.debug:
            self.train_files = self.train_files[-101:]
            self.test_files = self.test_files[:10]

        files = np.hstack((self.train_files, self.test_files))
        self.input_trees: Dict[str, list] = {"training": [], "validation": [], "test": []}
        self.input_colors: Dict[str, list] = {"training": [], "validation": [], "test": []}
        self.input_vert_inds: Dict[str, list] = {"training": [], "validation": [], "test": []}
        self.input_labels: Dict[str, list] = {"training": [], "validation": []}

        for file_path in files:
            cloud_name = file_path.split("/")[-1][:-4]
            cloud_folder = file_path.split("/")[-2]
            if "train" in cloud_folder:
                if cloud_name in self.validation_clouds:
                    self.all_splits += [1]
                    cloud_split = "validation"
                else:
                    self.all_splits += [0]
                    cloud_split = "training"
            else:
                cloud_split = "test"

            if (cloud_split != "test" and self.load_test) or (
                cloud_split == "test" and not self.load_test
            ):
                continue

            sub_ply_file = join(tree_path, f"{cloud_name}.ply")

            if isfile(sub_ply_file):
                data = read_ply(sub_ply_file)
                sub_points = np.vstack((data["x"], data["y"], data["z"])).T
                sub_colors = np.vstack((data["red"], data["green"], data["blue"])).T
                sub_vert_inds = data["vert_ind"]
                sub_labels = None if cloud_split == "test" else data["class"]
            else:
                data = read_ply(file_path)
                points = np.vstack((data["x"], data["y"], data["z"])).T
                colors = np.vstack((data["red"], data["green"], data["blue"])).T.astype(
                    np.float32
                )
                if cloud_split == "test":
                    int_features = np.asarray(data["vert_ind"], np.int32)
                else:
                    int_features = np.vstack((data["vert_ind"], data["class"])).T.astype(np.int32)
                sub_points, sub_colors, sub_int_features = grid_subsampling(
                    points, features=colors, labels=int_features, sampleDl=subsampling_parameter
                )
                sub_colors = sub_colors / 255
                if cloud_split == "test":
                    sub_vert_inds = np.squeeze(sub_int_features)
                    sub_labels = None
                else:
                    sub_vert_inds = sub_int_features[:, 0]
                    sub_labels = sub_int_features[:, 1]
                if cloud_split == "test":
                    write_ply(
                        sub_ply_file,
                        [sub_points, sub_colors, sub_vert_inds],
                        ["x", "y", "z", "red", "green", "blue", "vert_ind"],
                    )
                else:
                    write_ply(
                        sub_ply_file,
                        [sub_points, sub_colors, sub_labels, sub_vert_inds],
                        ["x", "y", "z", "red", "green", "blue", "class", "vert_ind"],
                    )
            search_tree = cKDTree(sub_points)
            self.input_trees[cloud_split] += [search_tree]
            self.input_colors[cloud_split] += [sub_colors]
            self.input_vert_inds[cloud_split] += [sub_vert_inds]
            if cloud_split in ("training", "validation"):
                self.input_labels[cloud_split] += [sub_labels]

        self.num_training = len(self.input_trees["training"])
        self.num_validation = len(self.input_trees["validation"])
        self.num_test = len(self.input_trees["test"])

        # Reprojection indices (mesh vertices -> subsampled cloud).
        self.validation_proj, self.validation_labels = [], []
        self.test_proj, self.test_labels = [], []
        i_val = i_test = 0
        for file_path in files:
            cloud_name = file_path.split("/")[-1][:-4]
            cloud_folder = file_path.split("/")[-2]

            if (not self.load_test) and "train" in cloud_folder and cloud_name in self.validation_clouds:
                proj_file = join(tree_path, f"{cloud_name}_proj.pkl")
                if isfile(proj_file):
                    with open(proj_file, "rb") as f:
                        proj_inds, labels = pickle.load(f)
                else:
                    mesh_path = file_path.split("/")
                    mesh_path[-2] = "training_meshes"
                    mesh_path = "/".join(mesh_path)
                    vertex_data, _ = read_ply(mesh_path[:-4] + "_mesh.ply", triangular_mesh=True)
                    vertices = np.vstack(
                        (vertex_data["x"], vertex_data["y"], vertex_data["z"])
                    ).T
                    labels = vertex_data["class"]
                    proj_inds = nearest_indices(self.input_trees["validation"][i_val], vertices)
                    with open(proj_file, "wb") as f:
                        pickle.dump([proj_inds, labels], f)
                self.validation_proj += [proj_inds]
                self.validation_labels += [labels]
                i_val += 1

            if self.load_test and "test" in cloud_folder:
                proj_file = join(tree_path, f"{cloud_name}_proj.pkl")
                if isfile(proj_file):
                    with open(proj_file, "rb") as f:
                        proj_inds, labels = pickle.load(f)
                else:
                    mesh_path = file_path.split("/")
                    mesh_path[-2] = "test_meshes"
                    mesh_path = "/".join(mesh_path)
                    vertex_data, _ = read_ply(mesh_path[:-4] + "_mesh.ply", triangular_mesh=True)
                    vertices = np.vstack(
                        (vertex_data["x"], vertex_data["y"], vertex_data["z"])
                    ).T
                    labels = np.zeros(vertices.shape[0], dtype=np.int32)
                    proj_inds = nearest_indices(self.input_trees["test"][i_test], vertices)
                    with open(proj_file, "wb") as f:
                        pickle.dump([proj_inds, labels], f)
                self.test_proj += [proj_inds]
                self.test_labels += [labels]
                i_test += 1

    # ----------------------------------------------------------- generator

    def reset_potentials(self, split: str):
        if not hasattr(self, "potentials"):
            self.potentials = {}
            self.min_potentials = {}
        self.potentials[split] = []
        self.min_potentials[split] = []
        for tree in self.input_trees[split]:
            self.potentials[split] += [self.rs.rand(tree.data.shape[0]) * 1e-3]
            self.min_potentials[split] += [float(np.min(self.potentials[split][-1]))]

    def data_rep(self, xyz, color, labels, idx, weights, num_out):
        """Duplicate-pad a short crop to the fixed npoint (:692-703)."""
        num_in = len(xyz)
        dup = self.rs.choice(num_in, num_out - num_in)
        idx_dup = list(range(num_in)) + list(dup)
        return xyz[idx_dup], color[idx_dup], idx[idx_dup], weights[idx_dup], labels[idx_dup]

    def spatially_regular_gen(self, split: str, config: GridConfig) -> Iterator:
        """Potential-driven fixed-size crop generator (:482-540).

        Yields dicts with points (npoint,3, centered), colors (npoint,6 —
        rgb + absolute xyz), labels, point_inds, cloud_ind, label_weights.
        """
        if split == "training":
            epoch_n = config.epoch_steps * config.batch_size
        elif split in ("validation", "test"):
            epoch_n = config.validation_size * config.batch_size
        else:
            raise ValueError(f"bad split {split!r}")

        if not hasattr(self, "potentials") or split not in getattr(self, "potentials", {}):
            self.reset_potentials(split)

        for _ in range(epoch_n):
            cloud_ind = int(np.argmin(self.min_potentials[split]))
            point_ind = np.argmin(self.potentials[split][cloud_ind])
            tree = self.input_trees[split][cloud_ind]
            points = np.asarray(tree.data)
            center_point = points[point_ind, :].reshape(1, -1)
            noise = self.rs.normal(scale=0.35, size=center_point.shape)
            pick_point = center_point + noise.astype(center_point.dtype)

            if config.in_radius > 0:
                input_inds = ball_indices(tree, pick_point, config.in_radius)
            else:
                buffer = self.buffer + self.rs.randint(0, self.buffer // 4)
                k = min(len(points), self.npoint + buffer)
                input_inds = knn_indices(tree, pick_point, k)

            perm = self.rs.permutation(len(input_inds))
            input_inds = input_inds[perm][: self.npoint]
            n = input_inds.shape[0]
            if n == 0:
                self.reset_potentials(split)
                return

            dists = np.sum(
                np.square((points[input_inds] - pick_point).astype(np.float32)), axis=1
            )
            delta = np.square(1 - dists / np.max(dists))
            self.potentials[split][cloud_ind][input_inds] += delta
            self.min_potentials[split][cloud_ind] = float(
                np.min(self.potentials[split][cloud_ind])
            )

            input_points = (points[input_inds] - pick_point).astype(np.float32)
            input_colors = self.input_colors[split][cloud_ind][input_inds]
            if split == "test":
                input_labels = np.zeros(input_points.shape[0], np.int32)
            else:
                input_labels = self.input_labels[split][cloud_ind][input_inds]
                input_labels = np.array([self.label_to_idx[l] for l in input_labels])
            if split in ("test", "validation"):
                label_weights = np.zeros(input_points.shape[0], np.float32)
            else:
                label_weights = self.label_weights[input_labels].astype(np.float32)

            if len(input_inds) < self.npoint:
                input_points, input_colors, input_inds, label_weights, input_labels = self.data_rep(
                    input_points, input_colors, input_labels, input_inds, label_weights, self.npoint
                )

            yield {
                "points": input_points,
                "colors": np.hstack((input_colors, input_points + pick_point)).astype(np.float32),
                "labels": input_labels.astype(np.int32),
                "point_inds": input_inds.astype(np.int32),
                "cloud_ind": np.int32(cloud_ind),
                "label_weights": label_weights,
            }

    def batches(self, split: str, config: GridConfig, augment: bool = True) -> Iterator[dict]:
        """Fixed-shape batches with per-cloud augmentation + color drop.

        The augment/map stage runs on `config.input_threads` workers
        (reference: tf.data map(num_parallel_calls=8),
        train_scannet_grid.py:145-147) — the generator stays serial (its
        potential state is sequential, as in the reference). Each item gets
        a seed drawn serially from self.rs, so the output stream is
        identical for any thread count.
        """
        symmetries = [True, False, False] if split == "training" else [False, False, False]
        cfg = GridConfig(**{**config.__dict__, "augment_symmetries": symmetries})

        def seeded():
            for item in self.spatially_regular_gen(split, cfg):
                yield item, self.rs.randint(0, 2**31 - 1)

        def map_fn(arg):
            # tf_map equivalent (:554-571): keep only the rgb half of the
            # color tensor, augment xyz, then randomly drop the cloud's colors.
            item, seed = arg
            rgb = item["colors"][:, :3]
            if not augment:
                return dict(item, colors=rgb)
            rs = np.random.RandomState(seed)
            pts, _, _ = augment_points(item["points"], cfg, rs)
            return dict(item, points=pts, colors=maybe_drop_colors(rgb, cfg, rs))

        buf = []
        with parallel_map(seeded(), map_fn, cfg.input_threads) as mapped:
            for item in mapped:
                buf.append(item)
                if len(buf) == cfg.batch_size:
                    yield {
                        k: np.stack([b[k] for b in buf]) for k in buf[0]
                    }
                    buf = []

    def load_evaluation_points(self, file_path: str) -> np.ndarray:
        """Mesh vertices the metrics are evaluated on (:575-584)."""
        mesh_path = file_path.split("/")
        mesh_path[-2] = mesh_path[-2][:-6] + "meshes"
        mesh_path = "/".join(mesh_path)
        vertex_data, _ = read_ply(mesh_path[:-4] + "_mesh.ply", triangular_mesh=True)
        return np.vstack((vertex_data["x"], vertex_data["y"], vertex_data["z"])).T
