"""The port's ScanNet CLIs and what they run on, on the CPU.

- ``data/scannet.py`` and ``data/provider.py`` against the JAX package's: the
  same pickles and the same ``RandomState`` seeds give the same arrays, to
  the bit (the train crops, the whole-scene tiles, the sliding windows and
  their single-pass scene, the rotation and the normalisation).
- ``cli/seg_common.py``'s helpers against the JAX package's.
- ``cli.train_scannet`` then ``cli.test_scannet`` with ``--device cpu
  --debug`` at B2 x 512 on the synthetic pickles of ``tests/test_cli_scannet.py``:
  a ``latest`` checkpoint, mIoU in [0, 1], ``--profile`` traces; the tester
  also with ``--single_pass``.
- ``--dp`` and ``--sharded`` raise (not ported); the default device with no
  card raises, and never runs on the CPU.
"""

import argparse
import glob
import os

import numpy as np
import pytest
import torch
from test_cli_scannet import synthetic_scannet  # noqa: F401 (the pickles, a fixture)

from pointasnl_tpu.cli import seg_common as jsc
from pointasnl_tpu.data import provider as jprov
from pointasnl_tpu.data import scannet as jscan
from pointasnl_tpu_torch.cli import seg_common as tsc
from pointasnl_tpu_torch.cli import test_scannet, train_scannet
from pointasnl_tpu_torch.data import provider as tprov
from pointasnl_tpu_torch.data import scannet as tscan
from pointasnl_tpu_torch.utils import load_args

torch.set_num_threads(1)


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split,with_rgb", [("train", True), ("val", False)])
def test_scannet_crops_equal_jax_to_the_bit(synthetic_scannet, split, with_rgb):  # noqa: F811
    port = tscan.ScannetDataset(synthetic_scannet, block_points=512, split=split,
                                with_rgb=with_rgb, random_state=np.random.RandomState(3))
    jax = jscan.ScannetDataset(synthetic_scannet, block_points=512, split=split,
                               with_rgb=with_rgb, random_state=np.random.RandomState(3))
    np.testing.assert_array_equal(port.labelweights, jax.labelweights)
    assert len(port) == len(jax) == 2
    for i in (0, 1, 0):
        _same(port[i], jax[i])


def test_whole_scene_tiles_equal_jax_to_the_bit(synthetic_scannet):  # noqa: F811
    kw = dict(block_points=512, split="val", with_rgb=True)
    port = tscan.ScannetDatasetWholeScene(synthetic_scannet, **kw,
                                          random_state=np.random.RandomState(4))
    jax = jscan.ScannetDatasetWholeScene(synthetic_scannet, **kw,
                                         random_state=np.random.RandomState(4))
    for i in (0, 1):
        _same(port[i], jax[i])


def test_sliding_windows_equal_jax_to_the_bit(synthetic_scannet):  # noqa: F811
    kw = dict(split="val", block_points=512, with_rgb=True)
    port = tscan.ScannetDatasetWholeSceneSlidingWindow(synthetic_scannet, **kw,
                                                       random_state=np.random.RandomState(5))
    jax = jscan.ScannetDatasetWholeSceneSlidingWindow(synthetic_scannet, **kw,
                                                      random_state=np.random.RandomState(5))
    assert port.point_num == jax.point_num
    _same(port[0], jax[0])
    _same(port.whole_scene(1), jax.whole_scene(1))
    _same(port[1], jax[1])


def test_provider_equals_jax_to_the_bit():
    x = np.random.RandomState(6).randn(3, 100, 3).astype(np.float32) * 2 + 1
    _same(tprov.normalize_data(x), jprov.normalize_data(x))
    _same(tprov.rotate_point_cloud_z(x, random_state=np.random.RandomState(7)),
          jprov.rotate_point_cloud_z(x, random_state=np.random.RandomState(7)))


def test_seg_common_helpers_equal_jax():
    rng = np.random.RandomState(8)
    pred, label = rng.randint(0, 21, (3, 400)), rng.randint(0, 21, (3, 400))
    smpw = rng.rand(3, 400) * (rng.rand(3, 400) > 0.2)
    port, jax = tsc.SegEvalAccumulator(21), jsc.SegEvalAccumulator(21)
    for acc in (port, jax):
        acc.update(pred, label, smpw)
        acc.update(pred[0], label[0])
    assert port.miou() == jax.miou() and port.accuracy() == jax.accuracy()
    assert port.avg_class_accuracy() == jax.avg_class_accuracy()
    np.testing.assert_array_equal(port.per_class_iou(), jax.per_class_iou())

    votes = (rng.randint(0, 50, (4, 30)), pred[np.arange(4) % 3, :30], smpw[np.arange(4) % 3, :30])
    _same(tsc.add_vote(np.zeros((50, 21)), *votes), jsc.add_vote(np.zeros((50, 21)), *votes))
    batch = (rng.rand(1, 8, 6).astype(np.float32), label[:1, :8], smpw[:1, :8])
    for a, b in zip(tsc.pad_seg_batch(*batch, 3), jsc.pad_seg_batch(*batch, 3)):
        np.testing.assert_array_equal(a, b)
    for v in (True, False, "True", "false", "1", "yes", "no", 0):
        assert tsc.str2bool(v) == jsc.str2bool(v)

    parsers = []
    for mod in (tsc, jsc):
        p = argparse.ArgumentParser()
        mod.add_nl_args(p)
        mod.add_dp_arg(p)
        parsers.append(p)
    for argv in ([], ["--nl_block_size", "256", "--nl_flash", "true", "--dp"]):
        flags = [p.parse_args(argv) for p in parsers]
        assert vars(flags[0]) == vars(flags[1])
        assert tsc.nl_kwargs(flags[0]) == jsc.nl_kwargs(flags[1])
        assert tsc.nl_kwargs(vars(flags[0])) == jsc.nl_kwargs(vars(flags[1]))


def _has_trace(profile_dir):
    return any(f for _, _, fs in os.walk(profile_dir) for f in fs)


@pytest.fixture(scope="module")
def trained(synthetic_scannet, tmp_path_factory):  # noqa: F811
    """A --debug training run at B2 x 512 on the CPU: (log_dir, best mIoU)."""
    log_dir = str(tmp_path_factory.mktemp("train") / "logs")
    best = train_scannet.main(["--data", synthetic_scannet, "--log_dir", log_dir,
                               "--batch_size", "2", "--num_point", "512",
                               "--whole_eval_start", "0", "--debug", "--profile",
                               "--device", "cpu"])
    return log_dir, best


def test_train_scannet_cli_on_the_cpu(trained):
    log_dir, best = trained
    assert 0.0 <= best <= 1.0
    assert os.path.isdir(os.path.join(log_dir, "latest"))
    assert sorted(os.listdir(os.path.join(log_dir, "latest"))) == ["state.pt"]
    assert _has_trace(os.path.join(log_dir, "profile"))
    args = load_args(log_dir)
    assert args["model"] == "pointasnl_sem_seg" and args["device"] == "cpu"
    assert {"sem_seg.py", "pointasnl.py", "layers.py", "train_scannet.py"} <= set(
        os.listdir(os.path.join(log_dir, "src_snapshot")))
    assert os.path.getsize(os.path.join(log_dir, "metrics_eval.csv")) > 0


@pytest.mark.parametrize("single_pass", [False, True], ids=["votes", "single_pass"])
def test_test_scannet_cli_on_the_cpu(synthetic_scannet, trained, tmp_path,  # noqa: F811
                                     single_pass):
    dump = tmp_path / "dump"
    argv = ["--data", synthetic_scannet, "--model_path", trained[0], "--ckpt", "latest",
            "--dump_dir", str(dump), "--batch_size", "2", "--num_point", "512",
            "--num_votes", "1", "--max_scenes", "1", "--device", "cpu"]
    if single_pass:
        argv += ["--single_pass", "True", "--nl_block_size", "256", "--pad_quantum", "1024"]
    else:
        argv += ["--profile"]
    miou = test_scannet.main(argv)
    assert 0.0 <= miou <= 1.0
    (run,) = glob.glob(str(dump / "*"))
    with open(os.path.join(run, "scene0000_00.txt")) as f:
        assert len(f.read().splitlines()) == 3000
    if not single_pass:
        assert _has_trace(os.path.join(run, "profile"))


@pytest.mark.parametrize("cli,extra,item", [
    (train_scannet, ["--dp"], "item 6"), (test_scannet, ["--dp"], "item 6"),
    (test_scannet, ["--single_pass", "true", "--sharded", "true"], "item 7")])
def test_unported_parallel_flags_raise(tmp_path, cli, extra, item):
    argv = ["--data", str(tmp_path), "--device", "cpu"] + extra
    if cli is test_scannet:
        argv += ["--model_path", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


@pytest.mark.parametrize("cli", [train_scannet, test_scannet])
def test_the_default_device_is_the_card(tmp_path, monkeypatch, cli):
    """Without a card the CLIs raise at the default --device cuda; they
    never run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path), "--log_dir", str(tmp_path / "logs")] if cli is train_scannet \
        else ["--data", str(tmp_path), "--model_path", str(tmp_path)]
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)
