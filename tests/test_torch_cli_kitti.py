"""The port's SemanticKITTI block drivers on the CPU: ``cli.train_semantic_kitti``
then ``cli.test_semantic_kitti`` with ``--device cpu`` at B2 x 512 on the
synthetic sequences of ``tests/test_cli_kitti.py`` (two scans of 4000 points
in sequences 00 and 08).

- The trainer (``--debug --with_remission``): a ``latest`` checkpoint of
  ``PointASNLSemSeg(20, feature_channel=1)``, mIoU in [0, 1], args.txt.
- The tester by sliding windows (with ``--remap_inv`` and
  ``--random_rotate``) and by ``--single_pass``: mIoU in [0, 1] and a
  ``.label`` file of every raw point (raw ids, or training ids); it rebuilds
  the model from the training run's args.txt, with the flags given on its
  command line taking precedence.
- ``--dp`` and ``--sharded`` raise (not ported); the default device with no
  card raises, and never runs on the CPU.
"""

import os

import numpy as np
import pytest
import torch
from test_cli_kitti import synthetic_kitti  # noqa: F401 (the sequences, a fixture)

from pointasnl_tpu_torch.cli import test_semantic_kitti, train_semantic_kitti
from pointasnl_tpu_torch.data.semantic_kitti_config import LEARNING_MAP_INV
from pointasnl_tpu_torch.models import PointASNLSemSeg
from pointasnl_tpu_torch.utils import load_args

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained(synthetic_kitti, tmp_path_factory):  # noqa: F811
    """A --debug training run with remission at B2 x 512 on the CPU:
    (log_dir, best mIoU)."""
    log_dir = str(tmp_path_factory.mktemp("train") / "logs")
    best = train_semantic_kitti.main(["--data", synthetic_kitti, "--log_dir", log_dir,
                                      "--batch_size", "2", "--num_point", "512",
                                      "--with_remission", "--debug", "--device", "cpu"])
    return log_dir, best


def test_train_semantic_kitti_cli_on_the_cpu(trained):
    log_dir, best = trained
    assert 0.0 <= best <= 1.0
    assert sorted(os.listdir(os.path.join(log_dir, "latest"))) == ["state.pt"]
    args = load_args(log_dir)
    assert args["with_remission"] and args["device"] == "cpu" and args["batch_size"] == 2
    state = torch.load(os.path.join(log_dir, "latest", "state.pt"), map_location="cpu")
    PointASNLSemSeg(20, 1, device="cpu").load_state_dict(state["model"], strict=True)
    with pytest.raises(RuntimeError, match="size mismatch"):  # not the xyz-only model's
        PointASNLSemSeg(20, 0, device="cpu").load_state_dict(state["model"], strict=True)


def _labels(pred_dir):
    files = sorted(pred_dir.glob("*.label"))
    assert len(files) == 1
    return np.fromfile(files[0], dtype=np.uint32)


@pytest.mark.parametrize("single_pass", [False, True], ids=["sliding_windows", "single_pass"])
def test_test_semantic_kitti_cli_on_the_cpu(synthetic_kitti, trained, tmp_path,  # noqa: F811
                                            single_pass):
    argv = ["--data", synthetic_kitti, "--model_path", trained[0], "--ckpt", "latest",
            "--dump_dir", str(tmp_path / "dump"), "--save_dir", str(tmp_path / "pred"),
            "--batch_size", "2", "--num_point", "512", "--num_votes", "1", "--max_scans", "1",
            "--device", "cpu"]
    if single_pass:
        argv += ["--single_pass", "--pad_quantum", "512", "--nl_block_size", "512"]
    else:
        argv += ["--remap_inv", "--random_rotate"]
    miou = test_semantic_kitti.main(argv)
    assert 0.0 <= miou <= 1.0
    out = _labels(tmp_path / "pred" / "sequences" / "08" / "predictions")
    assert out.shape == (4000,)
    if single_pass:
        assert out.max() < 20  # training ids
    else:
        assert set(np.unique(out)) <= set(LEARNING_MAP_INV.values()) - {0}
    with open(tmp_path / "dump" / "log_evaluate.txt") as f:
        assert "eval point avg class IoU" in f.read()


def test_the_tester_takes_the_model_flags_from_args_txt(trained, tmp_path):
    """Flags left unset come from the training run's args.txt (remission,
    the model, its classes); flags given win; with no args.txt the JAX
    tester's defaults hold."""
    base = ["--data", "x", "--model_path", trained[0]]
    flags = test_semantic_kitti.parse_args(base)
    test_semantic_kitti.model_flags(flags)
    assert (flags.with_remission, flags.model, flags.num_classes,
            flags.nl_block_size, flags.nl_flash) == (True, "pointasnl_sem_seg", 20, 0, False)
    flags = test_semantic_kitti.parse_args(base + ["--nl_block_size", "256", "--nl_flash",
                                                   "true"])
    test_semantic_kitti.model_flags(flags)
    assert (flags.nl_block_size, flags.nl_flash, flags.with_remission) == (256, True, True)
    flags = test_semantic_kitti.parse_args(["--model_path", str(tmp_path)])
    test_semantic_kitti.model_flags(flags)
    assert vars(flags).items() >= test_semantic_kitti.MODEL_DEFAULTS.items()


@pytest.mark.parametrize("cli,extra,item", [
    (train_semantic_kitti, ["--dp"], "item 6"), (test_semantic_kitti, ["--dp"], "item 6"),
    (test_semantic_kitti, ["--single_pass", "--sharded"], "item 7")])
def test_unported_parallel_flags_raise(tmp_path, cli, extra, item):
    argv = ["--data", str(tmp_path), "--device", "cpu"] + extra
    if cli is test_semantic_kitti:
        argv += ["--model_path", str(tmp_path)]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


@pytest.mark.parametrize("cli", [train_semantic_kitti, test_semantic_kitti])
def test_the_default_device_is_the_card(tmp_path, monkeypatch, cli):
    """Without a card the CLIs raise at the default --device cuda; they
    never run on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--data", str(tmp_path), "--log_dir", str(tmp_path / "logs")]
            if cli is train_semantic_kitti else ["--data", str(tmp_path), "--model_path",
                                                 str(tmp_path)])
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)


def test_flags_match_the_jax_drivers():
    """The port's drivers take every flag of the JAX package's, with the same
    defaults, and add --device; the tester reads its model's flags from
    args.txt where they are left unset (None here)."""
    from pointasnl_tpu.cli import test_semantic_kitti as jtest
    from pointasnl_tpu.cli import train_semantic_kitti as jtrain

    for port, jax, argv in ((train_semantic_kitti, jtrain, []),
                            (test_semantic_kitti, jtest, ["--model_path", "m"])):
        got, want = vars(port.parse_args(argv)), vars(jax.parse_args(argv))
        assert got.pop("device") == "cuda"
        for key, default in getattr(port, "MODEL_DEFAULTS", {}).items():
            assert got.pop(key) is None and want.pop(key) == default
        assert got == want
