"""The port's SemanticKITTI block data (``data/laserscan.py``,
``data/semantic_kitti.py``) against the JAX package's, on the CPU: the same
scans (the synthetic sequences of ``tests/test_cli_kitti.py``) and the same
``RandomState`` seeds give the same arrays, to the bit.

- ``SemLaserScan``: the scan, the 16-bit label split and every range and
  label projection image.
- ``SemanticKittiDataset``: crops, labels and weights, with and without the
  remission channel, and its ``random_sample`` subset.
- ``SemanticKittiDatasetSlidingWindow``: blocks, their original indices,
  the raw scan and its labels; ``whole_scan``; ``SemanticKittiDatasetWhole``.
"""

import numpy as np
import pytest
from test_cli_kitti import synthetic_kitti  # noqa: F401 (the sequences, a fixture)

from pointasnl_tpu.data import laserscan as jls
from pointasnl_tpu.data import semantic_kitti as jsk
from pointasnl_tpu_torch.data import laserscan as tls
from pointasnl_tpu_torch.data import semantic_kitti as tsk
from pointasnl_tpu_torch.data.semantic_kitti_config import COLOR_MAP_BGR


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None:
        assert b is None
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _scan_files(root, seq="08", i=0):
    base = f"{root}/sequences/{seq}"
    return f"{base}/velodyne/{i:06d}.bin", f"{base}/labels/{i:06d}.label"


PROJECTIONS = ("points", "remissions", "proj_range", "unproj_range", "proj_xyz",
               "proj_remission", "proj_idx", "proj_x", "proj_y", "proj_mask", "sem_label",
               "inst_label", "proj_sem_label", "proj_sem_color", "proj_inst_label",
               "proj_inst_color", "sem_label_color", "inst_label_color")


def test_sem_laser_scan_projections_equal_jax_to_the_bit(synthetic_kitti, tmp_path):  # noqa: F811
    scan_file, label_file = _scan_files(synthetic_kitti)
    # Instance ids in the upper 16 bits, so that the split has work to do.
    label = np.fromfile(label_file, dtype=np.uint32)
    label = label | (np.arange(label.size, dtype=np.uint32) % 7 << 16)
    label.tofile(tmp_path / "000000.label")
    scans = []
    for module in (tls, jls):
        np.random.seed(5)  # the instance colours are drawn from the global state
        s = module.SemLaserScan(20, sem_color_dict=COLOR_MAP_BGR, project=True, H=16, W=128)
        s.open_scan(scan_file)
        s.open_label(str(tmp_path / "000000.label"))
        s.colorize()
        scans.append(s)
    port, jax = scans
    assert port.size() == len(jax) == 4000 and (port.proj_idx >= 0).sum() > 100
    for name in PROJECTIONS:
        _same(getattr(port, name), getattr(jax, name))
    for bad in (lambda s: s.open_scan(label_file), lambda s: s.set_label(label[:10])):
        with pytest.raises((RuntimeError, ValueError)):
            bad(port)


@pytest.mark.parametrize("with_remission", [False, True], ids=["xyz", "remission"])
def test_block_crops_equal_jax_to_the_bit(synthetic_kitti, with_remission):  # noqa: F811
    kw = dict(sample_points=512, split="train", with_remission=with_remission)
    port = tsk.SemanticKittiDataset(synthetic_kitti, random_state=np.random.RandomState(4), **kw)
    jax = jsk.SemanticKittiDataset(synthetic_kitti, random_state=np.random.RandomState(4), **kw)
    assert port.points_name == jax.points_name and port.label_name == jax.label_name
    np.testing.assert_array_equal(port.label_weights_lut, jax.label_weights_lut)
    np.testing.assert_array_equal(port.remap_lut, jax.remap_lut)
    assert len(port) == len(jax) == 2
    for i in (0, 1, 0, 1):
        got = port[i]
        _same(got, jax[i])
    assert got[0].shape == (512, 3 + with_remission) and got[2].max() > 0


def test_random_sample_subset_equals_jax(synthetic_kitti):  # noqa: F811
    kw = dict(split="valid", random_sample=True, random_rate=0.5)
    port = tsk.SemanticKittiDataset(synthetic_kitti, **kw)
    jax = jsk.SemanticKittiDataset(synthetic_kitti, **kw)
    assert port.points_name == jax.points_name and port.label_name == jax.label_name
    assert len(port) == 1


@pytest.mark.parametrize("with_remission", [False, True], ids=["xyz", "remission"])
def test_sliding_windows_equal_jax_to_the_bit(synthetic_kitti, with_remission):  # noqa: F811
    kw = dict(sample_points=512, split="valid", with_remission=with_remission)
    port = tsk.SemanticKittiDatasetSlidingWindow(synthetic_kitti,
                                                 random_state=np.random.RandomState(6), **kw)
    jax = jsk.SemanticKittiDatasetSlidingWindow(synthetic_kitti,
                                                random_state=np.random.RandomState(6), **kw)
    np.testing.assert_array_equal(port.color_map, jax.color_map)
    for i in (0, 1, 0):
        got = port[i]
        _same(got, jax[i])
        _same(port.whole_scan(i), jax.whole_scan(i))
    blocks, idx, raw, label = got
    assert blocks.shape[1:] == (512, 3 + with_remission) and idx.shape == blocks.shape[:2]
    assert set(np.unique(idx)) == set(range(raw.shape[0]))  # every raw point is in a block


def test_sliding_windows_of_the_test_split_have_no_labels(synthetic_kitti, tmp_path):  # noqa: F811
    """The test split (sequences 11-21) lists no labels: the items are
    (blocks, indices, raw scan), and whole_scan's labels are None."""
    import shutil

    root = tmp_path / "kitti"
    vel = root / "sequences" / "11" / "velodyne"
    vel.mkdir(parents=True)
    shutil.copy(_scan_files(synthetic_kitti)[0], vel / "000000.bin")
    for seq in range(12, 22):
        (root / "sequences" / f"{seq:02d}" / "velodyne").mkdir(parents=True)
    port, jax = (m.SemanticKittiDatasetSlidingWindow(str(root), sample_points=512, split="test",
                                                     random_state=np.random.RandomState(2))
                 for m in (tsk, jsk))
    got = port[0]
    assert len(got) == 3
    _same(got, jax[0])
    _same(port.whole_scan(0), jax.whole_scan(0))
    assert port.whole_scan(0)[1] is None


@pytest.mark.parametrize("with_remission", [False, True], ids=["xyz", "remission"])
def test_whole_scan_tiles_equal_jax_to_the_bit(synthetic_kitti, with_remission):  # noqa: F811
    kw = dict(sample_points=256, split="valid", with_remission=with_remission)
    port = tsk.SemanticKittiDatasetWhole(synthetic_kitti, random_state=np.random.RandomState(8),
                                         **kw)
    jax = jsk.SemanticKittiDatasetWhole(synthetic_kitti, random_state=np.random.RandomState(8),
                                        **kw)
    for i in (0, 1):
        got = port[i]
        _same(got, jax[i])
    assert got[0].shape[1:] == (256, 3 + with_remission) and got[0].shape[0] >= 4
