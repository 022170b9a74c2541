"""The port's grid-pipeline data modules against the JAX package's, on the CPU.

- ``data/ply.py``: the port writes the bytes the JAX package writes, and
  either reader reads either file (binary with faces, ascii) to the same
  arrays.
- ``data/mesh.py:rasterize_mesh`` and ``data/grid_subsampling.py`` to the
  bit (the latter against JAX's ``_numpy_grid_subsampling``, called
  directly, so the result does not depend on JAX's optional C++ extension).
- ``data/grid_pipeline.py``: ``augment_points`` and ``maybe_drop_colors``
  equal for one seed.
- ``data/scannet_grid.py`` and ``data/semantic_kitti_grid.py``: the batches
  equal JAX's to the bit, kNN crops (``in_radius`` 0) and ball crops
  (``in_radius`` > 0, JAX's sklearn tree wrapped so that each ball comes in
  ascending order, the port's rule), for 1 and 4 input threads; the
  projections, the subsampled clouds and the potentials equal too, each
  package preparing its own copy of the raw data; and the port reads a
  directory that the JAX package prepared.
"""

import os
import pickle
import shutil

import numpy as np
import pytest
from test_cli_grid import make_scene_cloud, synthetic_kitti_raw  # noqa: F401 (a fixture)

from pointasnl_tpu.data import grid_pipeline as jgp
from pointasnl_tpu.data import mesh as jmesh
from pointasnl_tpu.data import ply as jply
from pointasnl_tpu.data import scannet_grid as jsg
from pointasnl_tpu.data import semantic_kitti_grid as jkg
from pointasnl_tpu.data.grid_subsampling import _numpy_grid_subsampling
from pointasnl_tpu_torch.data import grid_pipeline as tgp
from pointasnl_tpu_torch.data import grid_subsampling as tgs
from pointasnl_tpu_torch.data import mesh as tmesh
from pointasnl_tpu_torch.data import ply as tply
from pointasnl_tpu_torch.data import scannet_grid as tsg
from pointasnl_tpu_torch.data import semantic_kitti_grid as tkg


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_batches(port, jax):
    assert len(port) == len(jax) > 0
    for p, j in zip(port, jax):
        assert sorted(p) == sorted(j)
        for k in p:
            _same(p[k], j[k])


class SortedBalls:
    """JAX's sklearn KDTree with each ball query's result in ascending
    order (the port's rule); its other queries as they are."""

    def __init__(self, tree):
        self.tree = tree
        self.data = tree.data

    def query(self, *args, **kwargs):
        return self.tree.query(*args, **kwargs)

    def query_radius(self, X, r):
        out = self.tree.query_radius(X, r=r)
        return np.array([np.sort(a) for a in out] + [None], dtype=object)[:-1]


# ------------------------------------------------------------------ ply

def test_ply_round_trips_against_jax(tmp_path):
    rng = np.random.RandomState(0)
    n = 300
    cols = [rng.randn(n, 3).astype(np.float32), (rng.rand(n, 3) * 255).astype(np.uint8),
            rng.randint(0, 40, n).astype(np.int32), rng.randn(n).astype(np.float64),
            rng.randint(0, 9, n).astype(np.int64)]
    names = ["x", "y", "z", "red", "green", "blue", "class", "w", "vert_ind"]
    faces = rng.randint(0, n, (50, 3)).astype(np.int32)
    port_file, jax_file = str(tmp_path / "port.ply"), str(tmp_path / "jax.ply")
    assert tply.write_ply(port_file, cols, names, triangular_faces=faces)
    assert jply.write_ply(jax_file, cols, names, triangular_faces=faces)
    with open(port_file, "rb") as a, open(jax_file, "rb") as b:
        assert a.read() == b.read()
    flat = [col for c in cols for col in (c.T if c.ndim == 2 else [c])]
    for read in (tply.read_ply, jply.read_ply):
        v, f = read(port_file, triangular_mesh=True)
        _same(f, faces)
        assert v.dtype.names == tuple(names)
        for name, col in zip(names, flat):
            np.testing.assert_array_equal(v[name], col)
    port_v, jax_v = tply.read_ply(jax_file), jply.read_ply(port_file)
    assert port_v.dtype == jax_v.dtype
    np.testing.assert_array_equal(port_v, jax_v)

    ascii_file = tmp_path / "ascii.ply"
    ascii_file.write_text("ply\nformat ascii 1.0\ncomment made by hand\nelement vertex 3\n"
                          "property float x\nproperty float y\nproperty uchar red\n"
                          "element face 1\nproperty list uchar int vertex_indices\nend_header\n"
                          "0.5 1 7\n-2 3.25 255\n4 5 0\n3 0 1 2\n")
    (pv, pf), (jv, jf) = (r(str(ascii_file), triangular_mesh=True)
                          for r in (tply.read_ply, jply.read_ply))
    assert pv.dtype == jv.dtype
    np.testing.assert_array_equal(pv, jv)
    _same(pf, jf)
    with pytest.raises(ValueError, match="field names"):
        tply.write_ply(port_file, cols, names[:-1])


# --------------------------------------------------- mesh and subsampling

def test_rasterize_mesh_equals_jax_to_the_bit():
    rng = np.random.RandomState(1)
    verts, faces = jmesh.cylinder_mesh(np.array([0.1, -0.2, 0.3, 1.2, 0.4]), precision=12)
    # faces larger and smaller than dl, a degenerate one, and a sliver
    tri = np.array([[0, 0, 0], [0.3, 0, 0], [0, 0.2, 0], [0.004, 0.003, 0.0],
                    [0.3, 1e-12, 0]], np.float64)
    extra = np.array([[0, 1, 2], [0, 3, 1], [0, 0, 1], [1, 4, 2]], np.int32) + len(verts)
    verts = np.concatenate([verts, tri.astype(np.float32),
                            rng.rand(30, 3).astype(np.float32)], 0)
    faces = np.concatenate([faces, extra, rng.randint(len(verts) - 30, len(verts), (20, 3))])
    for dl in (0.003 * 10, 0.05):
        port, jax = tmesh.rasterize_mesh(verts, faces, dl), jmesh.rasterize_mesh(verts, faces, dl)
        _same(port[0], jax[0])
        _same(port[1], jax[1])


@pytest.mark.parametrize("with_features,class_cols", [(False, 0), (True, 1), (True, 2),
                                                      (True, "vert_ind")])
def test_grid_subsampling_equals_jax_numpy_path(with_features, class_cols):
    rng = np.random.RandomState(2)
    pts = (rng.randn(5000, 3) * 2).astype(np.float32)
    feats = rng.rand(5000, 3).astype(np.float32) * 255 if with_features else None
    cls = None
    if class_cols == 1:
        cls = rng.randint(0, 5, 5000).astype(np.int32)
    elif class_cols == 2:
        cls = rng.randint(0, 7, (5000, 2)).astype(np.int32)
    elif class_cols == "vert_ind":  # a column of many values beside a label column
        cls = np.stack([np.arange(5000) // 3, rng.randint(-2, 30, 5000)], 1).astype(np.int32)
    want = _numpy_grid_subsampling(pts, feats, cls, 0.3)
    got = tgs.compute(pts, features=feats, classes=cls, sampleDl=0.3)
    got = got if isinstance(got, tuple) else (got,)
    want = [w for w in want if w is not None]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_augment_and_color_drop_equal_jax_for_one_seed():
    x = np.random.RandomState(3).randn(700, 3).astype(np.float32)
    for kwargs in ({}, {"augment_scale_anisotropic": False, "augment_symmetries": [True] * 3},
                   {"augment_rotation": "none", "augment_color": 0.5}):
        pc, jc = tgp.GridConfig(**kwargs), jgp.GridConfig(**kwargs)
        for seed in (4, 5):
            got = tgp.augment_points(x, pc, np.random.RandomState(seed))
            want = jgp.augment_points(x, jc, np.random.RandomState(seed))
            for g, w in zip(got, want):
                _same(g, w)
            rgb = x[:, :3] + 1
            for s in range(6):
                _same(tgp.maybe_drop_colors(rgb, pc, np.random.RandomState(seed * 10 + s)),
                      jgp.maybe_drop_colors(rgb, jc, np.random.RandomState(seed * 10 + s)))


@pytest.mark.parametrize("drop", [True, False])
def test_batch_iterator_equals_jax(drop):
    def gen():
        return iter(range(11))

    assert (list(tgp.batch_iterator(gen, 4, drop_remainder=drop))
            == list(jgp.batch_iterator(gen, 4, drop_remainder=drop)))


@pytest.mark.parametrize("threads", [0, 3])
def test_prefetcher_and_parallel_map_keep_order_and_raise_in_place(threads):
    def gen():
        yield from range(6)
        raise RuntimeError("boom")

    got = []
    with pytest.raises(RuntimeError, match="boom"):
        with tgp.Prefetcher(tgp.parallel_map(gen(), lambda x: x * x, threads), capacity=2) as pf:
            for item in pf:
                got.append(item)
    assert got == [x * x for x in range(6)]
    pf = tgp.Prefetcher(iter(range(10 ** 6)), capacity=2)
    assert next(pf) == 0
    pf.close()  # a consumer that stops early leaves no thread behind
    assert not pf.thread.is_alive()


# ------------------------------------------------------------ ScanNet grid

def _write_scannet_grid(root, seed: int = 0):
    """tests/test_cli_grid.py's synthetic layout, with a test split."""
    rng = np.random.RandomState(seed)
    for sub in ("training_points", "training_meshes", "test_points", "test_meshes"):
        os.makedirs(os.path.join(root, sub))
    names = ["x", "y", "z", "red", "green", "blue"]
    for scene in ["scene0000_00", "scene0001_00", "scene0002_00", "scene0707_00"]:
        xyz, rgb, labels, vert_inds = make_scene_cloud(rng)
        faces = rng.randint(0, len(xyz), (50, 3)).astype(np.int32)
        split = "test" if scene == "scene0707_00" else "training"
        if split == "test":
            jply.write_ply(os.path.join(root, "test_points", scene + ".ply"),
                           [xyz, rgb, vert_inds], names + ["vert_ind"])
            jply.write_ply(os.path.join(root, "test_meshes", scene + "_mesh.ply"), [xyz, rgb],
                           names, triangular_faces=faces)
        else:
            jply.write_ply(os.path.join(root, "training_points", scene + ".ply"),
                           [xyz, rgb, labels, vert_inds], names + ["class", "vert_ind"])
            jply.write_ply(os.path.join(root, "training_meshes", scene + "_mesh.ply"),
                           [xyz, rgb, labels], names + ["class"], triangular_faces=faces)
    with open(os.path.join(root, "scannet_v2_val.txt"), "w") as f:
        f.write("scene0002_00\n")


@pytest.fixture(scope="module")
def scannet_grid_roots(tmp_path_factory):
    """Two copies of one raw layout: one for each package to prepare."""
    base = tmp_path_factory.mktemp("scannet_grid_data")
    port, jax = str(base / "port"), str(base / "jax")
    _write_scannet_grid(port)
    shutil.copytree(port, jax)
    return port, jax


def _scannet_pair(roots, load_test=False, seed=7, npoint=128, jax_root=None):
    kw = dict(npoint=npoint, buffer=32, load_test=load_test, prepare=False)
    port = tsg.ScannetGridDataset(roots[0], random_state=np.random.RandomState(seed), **kw)
    jax = jsg.ScannetGridDataset(jax_root or roots[1], random_state=np.random.RandomState(seed),
                                 **kw)
    port.load_subsampled_clouds(0.04)
    jax.load_subsampled_clouds(0.04)
    for split, trees in jax.input_trees.items():
        jax.input_trees[split] = [SortedBalls(t) for t in trees]
    return port, jax


def test_scannet_grid_clouds_and_projections_equal_jax(scannet_grid_roots):
    for load_test in (False, True):
        port, jax = _scannet_pair(scannet_grid_roots, load_test=load_test)
        assert port.all_splits == jax.all_splits
        assert (port.num_training, port.num_validation, port.num_test) == (
            jax.num_training, jax.num_validation, jax.num_test)
        for split in ("training", "validation", "test"):
            assert len(port.input_trees[split]) == len(jax.input_trees[split])
            for pt, jt in zip(port.input_trees[split], jax.input_trees[split]):
                _same(np.asarray(pt.data), np.asarray(jt.data))
            for what in ("input_colors", "input_vert_inds"):
                for a, b in zip(getattr(port, what)[split], getattr(jax, what)[split]):
                    _same(a, b)
        for split in ("training", "validation"):
            for a, b in zip(port.input_labels[split], jax.input_labels[split]):
                _same(a, b)
        for what in ("validation_proj", "validation_labels", "test_proj", "test_labels"):
            assert len(getattr(port, what)) == len(getattr(jax, what))
            for a, b in zip(getattr(port, what), getattr(jax, what)):
                _same(a, b)
    assert len(port.test_proj) == 1 and len(jax.validation_proj) == 0
    prepared = set(os.listdir(os.path.join(scannet_grid_roots[0], "input_0.040")))
    assert not any(f.endswith("_KDTree.pkl") for f in prepared)  # the port writes no tree


@pytest.mark.parametrize("in_radius,threads", [(0.0, 1), (0.0, 4), (0.6, 1), (0.6, 4)])
def test_scannet_grid_batches_equal_jax_to_the_bit(scannet_grid_roots, in_radius, threads):
    port, jax = _scannet_pair(scannet_grid_roots)
    cfg = dict(batch_size=2, epoch_steps=3, validation_size=2, in_radius=in_radius)
    pc = tgp.GridConfig(**cfg, input_threads=threads)
    jc = jgp.GridConfig(**cfg, input_threads=1)
    for split, augment in (("training", True), ("validation", False), ("training", True)):
        _same_batches(list(port.batches(split, pc, augment=augment)),
                      list(jax.batches(split, jc, augment=augment)))
        for a, b in zip(port.potentials[split], jax.potentials[split]):
            _same(a, b)
        assert port.min_potentials[split] == jax.min_potentials[split]
    _same(port.rs.randint(0, 2**31 - 1, 4), jax.rs.randint(0, 2**31 - 1, 4))


def test_scannet_grid_ball_crops_pad_and_truncate(scannet_grid_roots):
    """The ball case covers crops shorter than npoint (duplicate-padded) and
    longer ones (truncated), and the test split's batches equal JAX's."""
    port = tsg.ScannetGridDataset(scannet_grid_roots[0], npoint=128, buffer=32,
                                  random_state=np.random.RandomState(7), prepare=False)
    port.load_subsampled_clouds(0.04)
    cfg = tgp.GridConfig(batch_size=2, epoch_steps=6, in_radius=0.6, input_threads=0)
    unique = [len(np.unique(inds)) for b in port.batches("training", cfg) for inds in
              b["point_inds"]]
    assert min(unique) < 128 and max(unique) == 128
    port, jax = _scannet_pair(scannet_grid_roots, load_test=True)
    cfg = dict(batch_size=2, validation_size=3, in_radius=0.6)
    _same_batches(list(port.batches("test", tgp.GridConfig(**cfg), augment=False)),
                  list(jax.batches("test", jgp.GridConfig(**cfg), augment=False)))


def test_the_port_reads_a_directory_the_jax_package_prepared(scannet_grid_roots):
    jax_root = scannet_grid_roots[1]
    _scannet_pair(scannet_grid_roots)  # the JAX package has prepared its root
    port, jax = _scannet_pair((jax_root, jax_root))
    cfg = dict(batch_size=2, epoch_steps=2, in_radius=0.6)
    _same_batches(list(port.batches("training", tgp.GridConfig(**cfg, input_threads=2))),
                  list(jax.batches("training", jgp.GridConfig(**cfg, input_threads=1))))
    # The JAX package's tree caches are still there, and still its own.
    assert any(f.endswith("_KDTree.pkl") for f in os.listdir(os.path.join(jax_root,
                                                                        "input_0.040")))


# ------------------------------------------------------------ KITTI grid

class JaxKittiSorted(jkg.SemanticKittiGridDataset):
    """JAX's dataset with its unpickled trees' balls in ascending order."""

    def get_data(self, file_path):
        points, tree, labels = super().get_data(file_path)
        return points, SortedBalls(tree), labels


@pytest.fixture(scope="module")
def kitti_roots(synthetic_kitti_raw, tmp_path_factory):  # noqa: F811
    """Two copies of one raw layout (seq 00, seq 08 and a test seq 11), each
    prepared by one package at grid size 0.2."""
    base = tmp_path_factory.mktemp("kitti_grid_data")
    port, jax = str(base / "port"), str(base / "jax")
    shutil.copytree(synthetic_kitti_raw, port)
    rng = np.random.RandomState(11)
    vel = os.path.join(port, "11", "velodyne")
    os.makedirs(vel)
    for i in range(2):
        pts = np.zeros((2000, 4), np.float32)
        pts[:, :3] = (rng.rand(2000, 3) - 0.5) * 15
        pts.tofile(os.path.join(vel, f"{i:06d}.bin"))
    shutil.copytree(port, jax)
    kw = dict(num_point=256, grid_size=0.2, num_buffer=64, prepare_data=True)
    tkg.SemanticKittiGridDataset(port, random_state=np.random.RandomState(0), **kw)
    jkg.SemanticKittiGridDataset(jax, random_state=np.random.RandomState(0), **kw)
    return port, jax


def test_kitti_prepared_clouds_and_projections_equal_jax(kitti_roots):
    port, jax = (r + "_0.2" for r in kitti_roots)
    for seq in ("00", "08", "11"):
        for sub in ("velodyne", "labels", "proj"):
            d = os.path.join(port, seq, sub)
            if not os.path.isdir(d):
                assert not os.path.isdir(os.path.join(jax, seq, sub))
                continue
            files = sorted(os.listdir(d))
            assert files == sorted(os.listdir(os.path.join(jax, seq, sub))) and files
            for f in files:
                a, b = os.path.join(d, f), os.path.join(jax, seq, sub, f)
                if f.endswith(".npy"):
                    _same(np.load(a), np.load(b))
                else:
                    with open(a, "rb") as fa, open(b, "rb") as fb:
                        (pa,), (pb,) = pickle.load(fa), pickle.load(fb)
                    _same(pa, pb)
        assert not os.path.isdir(os.path.join(port, seq, "KDTree"))  # no tree cache


def _kitti_pair(kitti_roots, in_radius, test_id=8, seed=9):
    kw = dict(num_point=256, grid_size=0.2, num_buffer=64, in_radius=in_radius, test_id=test_id)
    return (tkg.SemanticKittiGridDataset(kitti_roots[0], random_state=np.random.RandomState(seed),
                                         **kw),
            JaxKittiSorted(kitti_roots[1], random_state=np.random.RandomState(seed), **kw))


@pytest.mark.parametrize("in_radius,threads", [(0.0, 1), (0.0, 4), (4.0, 1), (4.0, 4)])
def test_kitti_grid_batches_equal_jax_to_the_bit(kitti_roots, in_radius, threads):
    port, jax = _kitti_pair(kitti_roots, in_radius)
    assert [os.path.relpath(p, kitti_roots[0] + "_0.2") for p in port.train_list] == [
        os.path.relpath(p, kitti_roots[1] + "_0.2") for p in jax.train_list]
    pc = tgp.GridConfig(batch_size=2, in_radius=in_radius, input_threads=threads)
    jc = jgp.GridConfig(batch_size=2, in_radius=in_radius, input_threads=1)
    for split, augment in (("training", True), ("validation", False), ("test", False)):
        _same_batches(list(port.batches(split, pc, augment=augment)),
                      list(jax.batches(split, jc, augment=augment)))
    for a, b in zip(port.possibility, jax.possibility):
        _same(a, b)
    assert port.min_possibility == jax.min_possibility
    test_file = port.test_list[0]
    _same(port.get_proj_inds(test_file),
          jax.get_proj_inds(test_file.replace(kitti_roots[0], kitti_roots[1], 1)))


def test_kitti_test_sequence_past_10(kitti_roots):
    port, jax = _kitti_pair(kitti_roots, 0.0, test_id=11)
    assert len(port.test_list) == len(jax.test_list) == 2
    cfg = dict(batch_size=2, in_radius=0.0)
    _same_batches(list(port.batches("test", tgp.GridConfig(**cfg), augment=False)),
                  list(jax.batches("test", jgp.GridConfig(**cfg), augment=False)))
