"""The port's ModelNet data and host tools against the JAX package's, on the
CPU.

- ``data/provider.py``: every function, the same inputs and ``RandomState``
  seeds on both sides, equal to the bit; the h5 helpers on a file written
  here.
- ``data/modelnet.py``: ``ModelNetDataset`` batches (with normals, and with
  the ``--uniform`` host FPS) equal to the bit, and ``pc_normalize``.
- ``data/pc_util.py``: volumes, images, renders and the coloured ply equal
  to the bit (the global numpy state seeded alike where they draw).
- ``data/augment.py`` (torch, ``augment_jax``'s counterpart): its rotation
  matrices against ``augment_jax``'s on the same angles within 2e-7 (two
  libraries' float32 sin and cos); its invariants, as
  ``tests/test_augment_jax.py`` checks JAX's; the same generator state giving
  the same output. Its draws are not ``jax.random``'s.
- ``data/laserscan_vis.py``: ``render_range_image`` and ``render_scan``
  arrays equal to the bit.
- ``data/prepare_scannet.py``: the pickles of ``gen_pickle`` on the synthetic
  raw ScanNet of ``tests/test_scannet_prepare.py`` equal to JAX's.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_data import synthetic_modelnet  # noqa: F401 (the shapes, a fixture)
from test_scannet_prepare import synthetic_raw_scannet  # noqa: F401 (a raw scene, a fixture)

from pointasnl_tpu.data import augment_jax as jaug
from pointasnl_tpu.data import laserscan as jls
from pointasnl_tpu.data import laserscan_vis as jvis
from pointasnl_tpu.data import modelnet as jmn
from pointasnl_tpu.data import pc_util as jpc
from pointasnl_tpu.data import prepare_scannet as jprep
from pointasnl_tpu.data import provider as jprov
from pointasnl_tpu_torch.data import augment as taug
from pointasnl_tpu_torch.data import laserscan as tls
from pointasnl_tpu_torch.data import laserscan_vis as tvis
from pointasnl_tpu_torch.data import modelnet as tmn
from pointasnl_tpu_torch.data import pc_util as tpc
from pointasnl_tpu_torch.data import prepare_scannet as tprep
from pointasnl_tpu_torch.data import provider as tprov

torch.set_num_threads(1)


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _batch(seed, B=3, N=64, C=6):
    return np.random.RandomState(seed).randn(B, N, C).astype(np.float32)


# Each provider function with its arguments (beside the random state).
PROVIDER_CASES = {
    "normalize_data": lambda x: ((x[..., :3],), False),
    "shuffle_data": lambda x: ((x, np.arange(len(x))), True),
    "shuffle_points": lambda x: ((x,), True),
    "rotate_point_cloud": lambda x: ((x[..., :3],), True),
    "rotate_point_cloud_z": lambda x: ((x[..., :3],), True),
    "rotate_point_cloud_with_normal": lambda x: ((x,), True),
    "rotate_point_cloud_by_angle": lambda x: ((x, 0.7), False),
    "rotate_point_cloud_by_angle_with_normal": lambda x: ((x, -1.3), False),
    "rotate_perturbation_point_cloud": lambda x: ((x[..., :3],), True),
    "rotate_perturbation_point_cloud_with_normal": lambda x: ((x,), True),
    "jitter_point_cloud": lambda x: ((x[..., :3],), True),
    "shift_point_cloud": lambda x: ((x[..., :3],), True),
    "random_scale_point_cloud": lambda x: ((x[..., :3],), True),
    "random_point_dropout": lambda x: ((x,), True),
}


@pytest.mark.parametrize("name", sorted(PROVIDER_CASES))
def test_provider_equals_jax_to_the_bit(name):
    args, draws = PROVIDER_CASES[name](_batch(1))
    kw = lambda: {"random_state": np.random.RandomState(9)} if draws else {}  # noqa: E731
    got = getattr(tprov, name)(*args, **kw())
    _same(got, getattr(jprov, name)(*args, **kw()))
    if draws:  # the global state too, where no random state is given
        np.random.seed(3)
        got = getattr(tprov, name)(*args)
        np.random.seed(3)
        _same(got, getattr(jprov, name)(*args))


def test_provider_file_helpers_equal_jax(tmp_path):
    import h5py

    path = tmp_path / "ply_data_train0.h5"
    with h5py.File(path, "w") as f:
        f["data"] = _batch(2, 4, 16, 3)
        f["label"] = np.arange(4, dtype=np.uint8)[:, None]
    (tmp_path / "files.txt").write_text(f"{path}\n{path}  \n")
    assert tprov.getDataFiles(str(tmp_path / "files.txt")) == jprov.getDataFiles(
        str(tmp_path / "files.txt")) == [str(path)] * 2
    _same(tprov.loadDataFile(str(path)), jprov.loadDataFile(str(path)))
    _same(tprov.load_h5(str(path)), jprov.load_h5(str(path)))


@pytest.mark.parametrize("split,normal,uniform", [("train", True, False), ("test", True, True),
                                                  ("train", False, True)])
def test_modelnet_batches_equal_jax_to_the_bit(synthetic_modelnet, split, normal,  # noqa: F811
                                               uniform):
    kw = dict(batch_size=3, npoints=64, split=split, normal_channel=normal, uniform=uniform)
    port = tmn.ModelNetDataset(synthetic_modelnet, random_state=np.random.RandomState(5), **kw)
    jax = jmn.ModelNetDataset(synthetic_modelnet, random_state=np.random.RandomState(5), **kw)
    assert port.cat == jax.cat and port.datapath == jax.datapath
    for _ in range(2):  # two epochs: the second reads the cache
        while jax.has_next_batch():
            assert port.has_next_batch()
            got = port.next_batch()
            _same(got, jax.next_batch())
        assert not port.has_next_batch()
        port.reset()
        jax.reset()
    assert got[0].shape[2] == (6 if normal else 3)
    pc = _batch(4, 1, 50, 3)[0]
    _same(tmn.pc_normalize(pc), jmn.pc_normalize(pc))
    _same(tmn.farthest_point_sample_np(pc, 7, np.random.RandomState(1)),
          jmn.farthest_point_sample_np(pc, 7, np.random.RandomState(1)))


PC_UTIL_CASES = {
    "point_cloud_to_volume": lambda x: (x[0], 8),
    "point_cloud_to_volume_batch": lambda x: (x,),
    "point_cloud_to_volume_v2": lambda x: (x[0], 4, 1.0, 16),
    "point_cloud_to_volume_v2_batch": lambda x: (x, 3, 1.0, 8),
    "point_cloud_to_image": lambda x: (x[0], 6, 1.0, 8),
    "point_cloud_to_image_batch": lambda x: (x, 4, 1.0, 8),
    "euler2mat": lambda x: (0.3, -0.2, 1.1),
    "draw_point_cloud": lambda x: (x[0], 120, 60, 9),
    "point_cloud_three_views": lambda x: (x[1],),
}


@pytest.mark.parametrize("name", sorted(PC_UTIL_CASES))
def test_pc_util_equals_jax_to_the_bit(name):
    x = np.clip(_batch(7, 2, 200, 3) / 3, -0.99, 0.99)
    args = PC_UTIL_CASES[name](x)
    np.random.seed(11)  # the v2 volumes and images resample with the global state
    got = getattr(tpc, name)(*args)
    np.random.seed(11)
    _same(got, getattr(jpc, name)(*args))


def test_pc_util_volume_round_trip_and_ply_equal_jax(tmp_path):
    x = np.clip(_batch(8, 1, 100, 3)[0] / 3, -0.99, 0.99)
    _same(tpc.volume_to_point_cloud(tpc.point_cloud_to_volume(x, 6)),
          jpc.volume_to_point_cloud(jpc.point_cloud_to_volume(x, 6)))
    labels = np.arange(100) % 5
    tpc.write_ply_color(x, labels, str(tmp_path / "port.ply"))
    jpc.write_ply_color(x, labels, str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_text() == (tmp_path / "jax.ply").read_text()


def _angles():
    return np.random.RandomState(0).uniform(-7, 7, 64).astype(np.float32)


@pytest.mark.parametrize("name", ["_rot_y", "_rot_z"])
def test_augment_rotations_match_augment_jax(name):
    got = getattr(taug, name)(torch.from_numpy(_angles())).numpy()
    want = np.asarray(getattr(jaug, name)(jnp.asarray(_angles())))
    assert got.dtype == want.dtype == np.float32 and got.shape == (64, 3, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-7)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _x(C=3):
    return torch.from_numpy(_batch(2, 2, 50, C))


def test_augment_rotations_keep_norms_and_their_axis():
    x = _x()
    out = taug.rotate_point_cloud(_gen(), x)
    torch.testing.assert_close(out.norm(dim=-1), x.norm(dim=-1), rtol=1e-4, atol=0)
    torch.testing.assert_close(out[..., 1], x[..., 1], rtol=0, atol=1e-5)
    out = taug.rotate_point_cloud_z(_gen(1), x)
    torch.testing.assert_close(out[..., 2], x[..., 2], rtol=0, atol=1e-5)
    out = taug.rotate_perturbation_point_cloud(_gen(2), x)
    torch.testing.assert_close(out.norm(dim=-1), x.norm(dim=-1), rtol=1e-4, atol=0)
    xn = _x(6)
    out = taug.rotate_perturbation_with_normal(_gen(3), xn)
    # One rotation for xyz and normals: their dot products are kept.
    torch.testing.assert_close((out[..., :3] * out[..., 3:]).sum(-1),
                               (xn[..., :3] * xn[..., 3:]).sum(-1), rtol=1e-4, atol=1e-5)


def test_augment_jitter_scale_and_shift_stay_in_their_bounds():
    zeros = torch.zeros(2, 100, 3)
    jitter = taug.jitter_point_cloud(_gen(), zeros, sigma=0.5, clip=0.05)
    assert float(jitter.abs().max()) <= np.float32(0.05)  # the clip in float32
    shift = taug.shift_point_cloud(_gen(), zeros, shift_range=0.1)
    assert float(shift.abs().max()) <= np.float32(0.1) and torch.equal(shift, shift[:, :1].expand_as(shift))
    ones = torch.ones(2, 100, 3)
    scale = taug.random_scale_point_cloud(_gen(), ones)
    assert 0.8 <= float(scale.min()) and float(scale.max()) <= 1.25


def test_augment_dropout_collapses_to_the_first_point():
    x = _x()
    x = torch.cat([x, x, x], 1)  # 150 points: some are dropped at any ratio drawn
    out = taug.random_point_dropout(_gen(3), x)
    for b in range(2):
        changed = (out[b] != x[b]).any(-1)
        assert bool((out[b][changed] == out[b, 0]).all()) and torch.equal(out[b, 0], x[b, 0])
    assert int((out != x).any(-1).sum()) > 0


def test_augment_shuffle_is_one_permutation_a_batch():
    x = torch.arange(10.0)[None, :, None].repeat(3, 1, 3)
    out = taug.shuffle_points(_gen(), x)
    assert torch.equal(out[0], out[1]) and torch.equal(out[1], out[2])
    assert sorted(out[0, :, 0].tolist()) == list(range(10))


@pytest.mark.parametrize("rotation,with_normal", [(False, False), (True, False), (True, True)])
def test_augment_cls_batch_is_a_function_of_the_generator(rotation, with_normal):
    x = _x(6 if with_normal else 3)
    run = lambda seed: taug.augment_cls_batch(_gen(seed), x, rotation=rotation,  # noqa: E731
                                              with_normal=with_normal)
    out = run(4)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, run(4)) and not torch.equal(out, run(5))


def _scan(tmp_path, module):
    rng = np.random.RandomState(0)
    pts = rng.randn(300, 4).astype(np.float32) * 10
    pts.tofile(tmp_path / "000000.bin")
    (rng.randint(0, 20, 300).astype(np.uint32)).tofile(tmp_path / "000000.label")
    np.random.seed(1)
    s = module.SemLaserScan(20, sem_color_dict={k: [10 * k, 5, 0] for k in range(20)}, H=16,
                            W=64)
    s.open_scan(str(tmp_path / "000000.bin"))
    s.open_label(str(tmp_path / "000000.label"))
    return s


def test_laserscan_renders_equal_jax_to_the_bit(tmp_path):
    port, jax = _scan(tmp_path, tls), _scan(tmp_path, jls)
    _same(tvis.render_range_image(port), jvis.render_range_image(jax))
    for max_points in (1000, 120):  # all points, and a sample of them
        _same(tvis.render_scan(port, max_points=max_points, random_state=np.random.RandomState(2)),
              jvis.render_scan(jax, max_points=max_points, random_state=np.random.RandomState(2)))


def test_prepare_scannet_pickle_equals_jax(synthetic_raw_scannet, tmp_path):  # noqa: F811
    root, _ = synthetic_raw_scannet
    _same(tprep.gen_label_map(), jprep.gen_label_map())
    loaded = []
    for module, out in ((tprep, tmp_path / "port"), (jprep, tmp_path / "jax")):
        out.mkdir()
        path = module.gen_pickle(split="train", root=str(root), out_dir=str(out))
        with open(path, "rb") as f:
            loaded.append([pickle.load(f) for _ in range(4)])
        assert path.endswith("scannet_train_rgb21c_pointid.pickle")
    port, jax = loaded
    assert port[3] == jax[3] == [25]
    for a, b in zip(port[:3], jax[:3]):
        _same(a, b)
