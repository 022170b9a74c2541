"""The port's grid drivers on the CPU, and their evaluations against JAX's.

- ``validation_eval``, ``vote_projection_eval`` and ``crop_confusion_miou``
  give JAX's mIoU (sklearn's confusion matrix there, numpy's bincount here)
  on the same probabilities, exactly.
- ``cli.train_scannet_grid`` then ``cli.test_scannet_grid`` (validation and
  test splits), and ``cli.train_semantic_kitti_grid --prepare_data`` then
  ``cli.test_semantic_kitti_grid``, with ``--device cpu --debug`` at B2 x
  512 on the tiny datasets of ``tests/test_cli_grid.py``: mIoU in [0, 100],
  a ``latest`` checkpoint that the tester reloads from args.txt, the dumps.
- ``--dp`` raises (not ported); the default device with no card raises, and
  never runs on the CPU.
"""

import glob
import os
import types

import numpy as np
import pytest
import torch
from test_cli_grid import (  # noqa: F401 (fixtures)
    make_scene_cloud,
    synthetic_kitti_raw,
    synthetic_scannet_grid,
)

from pointasnl_tpu.cli import train_scannet_grid as jsg
from pointasnl_tpu.cli import train_semantic_kitti_grid as jkg
from pointasnl_tpu.data.ply import write_ply
from pointasnl_tpu_torch.cli import (
    test_scannet_grid,
    test_semantic_kitti_grid,
    train_scannet_grid,
    train_semantic_kitti_grid,
)
from pointasnl_tpu_torch.data.scannet_grid import ScannetGridDataset
from pointasnl_tpu_torch.data.semantic_kitti_grid import SemanticKittiGridDataset
from pointasnl_tpu_torch.utils import load_args

torch.set_num_threads(1)


def _probs(rng, n, c):
    p = rng.rand(n, c)
    return p / p.sum(1, keepdims=True)


def test_scannet_grid_evals_equal_jax():
    rng = np.random.RandomState(0)
    label_values = np.sort(list(ScannetGridDataset.LABEL_TO_NAMES))
    sizes = [300, 200, 250]
    ds = types.SimpleNamespace(
        label_values=label_values, ignored_labels=np.sort([0]),
        train_files=np.array(["a", "b", "c", "d"]), all_splits=[1, 0, 1, 1],
        validation_proj=[rng.randint(0, n, 4 * n).astype(np.int32) for n in sizes],
        validation_labels=[rng.choice(label_values, 4 * n).astype(np.int32) for n in sizes])
    sub_probs = [_probs(rng, n, 20) for n in sizes]
    sub_probs[1][:, 3] = 0.0  # a class never predicted
    logged = []
    assert (train_scannet_grid.vote_projection_eval(ds, sub_probs, 21, logged.append)
            == jsg.vote_projection_eval(ds, sub_probs, 21, logged.append))
    assert len(logged) == 40 and logged[:20] == logged[20:]

    preds = [_probs(rng, 128, 20) for _ in range(6)]
    truth = [rng.choice(label_values[:12], 128) for _ in range(6)]  # classes absent
    props = rng.randint(0, 1000, 20).astype(np.float32)
    port = train_scannet_grid.validation_eval(ds, sub_probs, props, preds, truth, 21)
    assert port == jsg.validation_eval(ds, sub_probs, props, preds, truth, 21)
    assert 0.0 <= port <= 100.0


def test_kitti_grid_crop_miou_equals_jax():
    rng = np.random.RandomState(1)
    ds = types.SimpleNamespace(label_values=np.arange(20), ignored_labels=np.sort([0]))
    preds = [_probs(rng, 256, 19) for _ in range(5)]
    truth = [rng.randint(0, 15, 256) for _ in range(5)]
    logged = []
    port = train_semantic_kitti_grid.crop_confusion_miou(ds, preds, truth, 20, logged.append)
    assert port == jkg.crop_confusion_miou(ds, preds, truth, 20, logged.append)
    assert len(logged) == 38 and logged[:19] == logged[19:] and 0.0 <= port <= 100.0


# ----------------------------------------------------------------- drivers

@pytest.fixture(scope="module")
def scannet_grid_with_test_split(synthetic_scannet_grid):  # noqa: F811
    """The tiny ScanNet-grid layout with one test scene (as
    tests/test_cli_grid.py adds it)."""
    rng = np.random.RandomState(7)
    root = synthetic_scannet_grid
    os.makedirs(os.path.join(root, "test_points"))
    os.makedirs(os.path.join(root, "test_meshes"))
    xyz, rgb, _, vert_inds = make_scene_cloud(rng, n=1500)
    write_ply(os.path.join(root, "test_points", "scene0707_00.ply"), [xyz, rgb, vert_inds],
              ["x", "y", "z", "red", "green", "blue", "vert_ind"])
    write_ply(os.path.join(root, "test_meshes", "scene0707_00_mesh.ply"), [xyz, rgb],
              ["x", "y", "z", "red", "green", "blue"],
              triangular_faces=rng.randint(0, len(xyz), (30, 3)).astype(np.int32))
    return root


def _has_trace(profile_dir):
    return any(f for _, _, fs in os.walk(profile_dir) for f in fs)


def test_scannet_grid_drivers_on_the_cpu(scannet_grid_with_test_split, tmp_path):
    root = scannet_grid_with_test_split
    log_dir = str(tmp_path / "logs")
    best = train_scannet_grid.main(["--data", root, "--log_dir", log_dir, "--batch_size", "2",
                                    "--num_point", "512", "--num_buffer", "64",
                                    "--in_radius", "0.8", "--debug", "--profile",
                                    "--device", "cpu"])
    assert 0.0 <= best <= 100.0
    assert os.path.isfile(os.path.join(log_dir, "latest", "state.pt"))
    assert _has_trace(os.path.join(log_dir, "profile"))
    args = load_args(log_dir)
    assert (args["model"], args["device"], args["in_radius"]) == ("pointasnl_sem_seg_res",
                                                                  "cpu", 0.8)
    assert {"sem_seg_res.py", "train_scannet_grid.py"} <= set(
        os.listdir(os.path.join(log_dir, "src_snapshot")))
    assert not glob.glob(os.path.join(root, "input_0.040", "*_KDTree.pkl"))

    dump = tmp_path / "dump"
    common = ["--data", root, "--model_path", log_dir, "--ckpt", "latest", "--num_votes",
              "0.001", "--max_rounds", "1", "--batch_size", "2", "--device", "cpu"]
    miou = test_scannet_grid.main(common + ["--dump_dir", str(dump / "val"), "--profile"])
    assert 0.0 <= miou <= 100.0
    (run,) = glob.glob(str(dump / "val" / "*"))
    assert _has_trace(os.path.join(run, "profile"))
    assert test_scannet_grid.main(common + ["--dump_dir", str(dump / "test"),
                                            "--split", "test"]) is None
    (sub,) = glob.glob(str(dump / "test" / "*" / "scene0707_00.txt"))
    preds = np.loadtxt(sub, dtype=int)
    assert preds.shape == (1500,)  # one NYU40 id per mesh vertex
    assert set(np.unique(preds)) <= set(ScannetGridDataset.LABEL_TO_NAMES)


def test_kitti_grid_drivers_on_the_cpu(synthetic_kitti_raw, tmp_path):  # noqa: F811
    log_dir = str(tmp_path / "logs")
    best = train_semantic_kitti_grid.main([
        "--data", synthetic_kitti_raw, "--log_dir", log_dir, "--batch_size", "2",
        "--num_point", "512", "--num_buffer", "64", "--first_subsampling_dl", "0.2",
        "--prepare_data", "--debug", "--device", "cpu"])
    assert 0.0 <= best <= 100.0
    prepared = synthetic_kitti_raw.rstrip("/") + "_0.2"
    assert os.path.isdir(os.path.join(prepared, "08", "proj"))
    assert not os.path.isdir(os.path.join(prepared, "00", "KDTree"))
    assert os.path.isfile(os.path.join(log_dir, "latest", "state.pt"))

    pred = tmp_path / "pred"
    test_semantic_kitti_grid.main(["--data", synthetic_kitti_raw, "--model_path", log_dir,
                                   "--ckpt", "latest", "--save_dir", str(pred), "--test_id",
                                   "8", "--num_votes", "0.001", "--max_rounds", "1",
                                   "--batch_size", "2", "--device", "cpu"])
    files = sorted((pred / "sequences" / "08" / "predictions").glob("*.label"))
    assert len(files) == 2
    out = np.fromfile(files[0], dtype=np.uint32)
    assert out.shape == (3000,)  # reprojected to the raw scan
    valid = set(SemanticKittiGridDataset.LABEL_TO_NAMES)
    from pointasnl_tpu_torch.data.semantic_kitti_config import LEARNING_MAP_INV

    assert set(np.unique(out)) <= {LEARNING_MAP_INV[c] for c in valid}


DRIVERS = [(train_scannet_grid, ["--log_dir"]), (test_scannet_grid, ["--model_path"]),
           (train_semantic_kitti_grid, ["--log_dir"]),
           (test_semantic_kitti_grid, ["--model_path"])]


@pytest.mark.parametrize("cli,flag", DRIVERS, ids=lambda v: getattr(v, "__name__", ""))
def test_dp_raises(tmp_path, cli, flag):
    argv = ["--data", str(tmp_path), flag[0], str(tmp_path), "--device", "cpu", "--dp"]
    assert cli.parse_args(argv).dp
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(argv)


@pytest.mark.parametrize("cli,flag", DRIVERS, ids=lambda v: getattr(v, "__name__", ""))
def test_the_default_device_is_the_card(tmp_path, monkeypatch, cli, flag):
    """Without a card the drivers raise at the default --device cuda; they
    never run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path), flag[0], str(tmp_path / "logs")]
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)


@pytest.mark.parametrize("name,argv", [
    ("train_scannet_grid", []), ("test_scannet_grid", ["--model_path", "logs"]),
    ("train_semantic_kitti_grid", []), ("test_semantic_kitti_grid", ["--model_path", "logs"])])
def test_drivers_take_jax_flags_and_defaults(name, argv):
    import importlib

    port = importlib.import_module(f"pointasnl_tpu_torch.cli.{name}")
    jax = importlib.import_module(f"pointasnl_tpu.cli.{name}")
    got, want = vars(port.parse_args(argv)), vars(jax.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
