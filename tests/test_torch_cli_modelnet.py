"""The port's ModelNet40 drivers on the CPU: ``cli.train_modelnet`` (``--AS
--normal --debug``, float32 and ``--precision bfloat16``) then
``cli.test_modelnet --noise`` with ``--device cpu`` at B2 x 1024 on the
synthetic shapes of ``tests/test_cli.py``.

- The trainer: ``latest`` and ``best`` checkpoints, args.txt, the CSV
  metrics, accuracy in [0, 1]; under bfloat16 the parameters stay float32.
- The tester: voting over point shuffles, and the noise sweep's accuracies
  keyed {0, 1, 10, 50, 100}, as the JAX tester returns them.
- ``pad_batch`` and ``augment_batch`` equal to the JAX driver's to the bit
  for the same ``RandomState``; the flags equal to the JAX drivers', with
  ``--device`` beside.
- ``--dp`` raises (not ported); the default device with no card raises, and
  never runs on the CPU.
"""

import os

import numpy as np
import pytest
import torch
from test_cli import synthetic_modelnet_1024  # noqa: F401 (the shapes, a fixture)

from pointasnl_tpu_torch.cli import test_modelnet, train_modelnet

torch.set_num_threads(1)

COMMON = ["--batch_size", "2", "--num_point", "1024", "--AS", "--normal", "--device", "cpu"]


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def trained(request, synthetic_modelnet_1024, tmp_path_factory):  # noqa: F811
    """A --debug training run: (log_dir, precision, best accuracy)."""
    log_dir = str(tmp_path_factory.mktemp(f"train_{request.param}") / "logs")
    best = train_modelnet.main(["--data", synthetic_modelnet_1024, "--log_dir", log_dir,
                                "--precision", request.param, "--debug"] + COMMON)
    return log_dir, request.param, best


def test_train_modelnet_cli_on_the_cpu(trained):
    log_dir, precision, best = trained
    assert 0.0 <= best <= 1.0
    for name in ("args.txt", "latest", "best", "metrics_train.csv", "metrics_test.csv"):
        assert os.path.exists(os.path.join(log_dir, name)), name
    state = torch.load(os.path.join(log_dir, "latest", "state.pt"), map_location="cpu")
    assert state["step"] == 2  # two debug epochs of one step
    assert {v.dtype for v in state["model"].values() if v.is_floating_point()} == {torch.float32}


def test_test_modelnet_cli_noise_sweep(synthetic_modelnet_1024, trained):  # noqa: F811
    log_dir, precision, _ = trained
    sweep = test_modelnet.main(["--data", synthetic_modelnet_1024, "--log_dir", log_dir,
                                "--ckpt", "latest", "--num_votes", "2", "--noise",
                                "--precision", precision] + COMMON)
    assert sorted(sweep) == [0] + test_modelnet.NOISE_POINTS == [0, 1, 10, 50, 100]
    assert all(0.0 <= v <= 1.0 for v in sweep.values())
    acc = test_modelnet.main(["--data", synthetic_modelnet_1024, "--log_dir", log_dir,
                              "--ckpt", "best", "--num_votes", "1", "--profile",
                              "--precision", precision] + COMMON)
    assert 0.0 <= acc <= 1.0
    assert any(fs for _, _, fs in os.walk(os.path.join(log_dir, "profile")))


@pytest.mark.parametrize("rotation,normal", [(False, False), (True, False), (True, True),
                                             (False, True)])
def test_batch_helpers_equal_jax_to_the_bit(rotation, normal):
    from argparse import Namespace

    from pointasnl_tpu.cli import train_modelnet as jtrain

    x = np.random.RandomState(0).randn(3, 64, 6 if normal else 3).astype(np.float32)
    flags = Namespace(rotation=rotation, normal=normal)
    got = train_modelnet.augment_batch(x.copy(), flags, np.random.RandomState(4))
    want = jtrain.augment_batch(x.copy(), flags, np.random.RandomState(4))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for a, b in zip(train_modelnet.pad_batch(x, np.arange(3), 5),
                    jtrain.pad_batch(x, np.arange(3), 5)):
        np.testing.assert_array_equal(a, b)


def test_flags_match_the_jax_drivers():
    from pointasnl_tpu.cli import test_modelnet as jtest
    from pointasnl_tpu.cli import train_modelnet as jtrain

    for port, jax in ((train_modelnet, jtrain), (test_modelnet, jtest)):
        got, want = vars(port.parse_args([])), vars(jax.parse_args([]))
        assert got.pop("device") == "cuda"
        assert got == want


@pytest.mark.parametrize("cli", [train_modelnet, test_modelnet])
def test_dp_raises_and_the_default_device_is_the_card(tmp_path, monkeypatch, cli):
    with pytest.raises(NotImplementedError, match="item 6"):
        cli.main(["--data", str(tmp_path), "--log_dir", str(tmp_path), "--dp", "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--data", str(tmp_path), "--log_dir", str(tmp_path / "logs")]
    assert cli.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(argv)


class _Shapes:
    """A dataset of one batch of two clouds, for evaluate_once."""

    def __init__(self):
        self.left = 1

    def has_next_batch(self):
        return self.left > 0

    def next_batch(self):
        self.left -= 1
        return np.random.RandomState(1).randn(2, 16, 3).astype(np.float32), np.zeros(2, int)

    def reset(self):
        self.left = 1


def test_one_noisy_point_lies_at_the_origin_where_jax_puts_nan():
    """A fault of the reference that the JAX package keeps: the sweep's one
    noisy point is normalised alone, 0 / 0, so each cloud gets a NaN point
    (on the card the searches cannot rank it). The port centres it at the
    origin; with 10 points both packages give the same finite noise."""
    from argparse import Namespace

    from pointasnl_tpu.cli import test_modelnet as jtest

    flags = Namespace(num_classes=3, batch_size=2, num_point=16, num_votes=1)
    seen = {}

    def predict(name):
        def fn(state, points):
            seen.setdefault(name, []).append(np.asarray(points, np.float32))
            return torch.zeros(2, 3) if name == "port" else np.zeros((2, 3), np.float32)
        return fn

    for n in (1, 10):
        seen.clear()
        test_modelnet.evaluate_once(None, predict("port"), _Shapes(), flags,
                                    np.random.RandomState(2),
                                    lambda a: torch.from_numpy(np.asarray(a, np.float32)),
                                    num_noisy_points=n, log=lambda *a: None)
        jtest.evaluate_once(None, predict("jax"), _Shapes(), flags, np.random.RandomState(2),
                            num_noisy_points=n, log=lambda *a: None, place=lambda a, dt: a)
        port, jax = seen["port"][0], seen["jax"][0]
        assert np.isfinite(port).all()
        if n == 1:
            assert np.isnan(jax).any() and (port == 0).all(-1).sum() == 2
        else:
            np.testing.assert_array_equal(port, jax)
