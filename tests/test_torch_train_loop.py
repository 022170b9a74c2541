"""The port's train-loop modules against the JAX package's: metrics
(``train/metrics.py``), checkpoints (``train/checkpoint.py``), metric
writers (``train/summary.py``) and profiling (``train/profiling.py``).

- metrics: the same predictions through both packages' confusion matrix,
  IoU, evaluators and smoothed metrics give equal counts and values (to
  float rounding where the JAX side computes in float32);
- checkpoints: the same sequence of (epoch, is_best) saves leaves the same
  epoch directories and the same ``latest``/``best`` aliases in both
  packages' CheckpointManager; a save, two more steps, a restore and the
  same two steps again give the same bits as the run that was not stopped;
- CSV writer: the same scalars and histogram make the same file;
- profiling: a StepTraceWindow writes one trace of its steps.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointasnl_tpu.train import checkpoint as jckpt
from pointasnl_tpu.train import metrics as jmetrics
from pointasnl_tpu.train import summary as jsummary
from pointasnl_tpu_torch.train import checkpoint, metrics, profiling, summary
from pointasnl_tpu_torch.train import (
    CheckpointManager,
    TrainState,
    bn_momentum_schedule,
    create_train_state,
    make_optimizer,
    make_train_step,
    staircase_lr_schedule,
)

torch.set_num_threads(1)

C = 7


def _predictions(seed=0, n=5000):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, C, n)
    preds = np.where(rng.rand(n) < 0.6, labels, rng.randint(0, C, n))
    labels[labels == 5] = 4  # class 5 has no true points: IoU's backfill
    return preds.astype(np.int64), labels.astype(np.int64)


def test_confusion_and_iou_match_jax():
    preds, labels = _predictions()
    got = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), C)
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), C))
    np.testing.assert_array_equal(got.numpy(), want)
    conf = got.numpy()
    np.testing.assert_array_equal(metrics.IoU_from_confusions(conf),
                                  jmetrics.IoU_from_confusions(conf))
    stack = np.stack([conf, conf.T, conf * 2])  # an epoch axis for the smoothing
    for got_m, want_m in zip(metrics.metrics_from_confusion(stack),
                             jmetrics.metrics_from_confusion(stack)):
        np.testing.assert_array_equal(got_m, want_m)
    for smooth_n, ignore in ((0, False), (1, True), (2, False)):
        for got_m, want_m in zip(metrics.smooth_metrics(stack, smooth_n, ignore),
                                 jmetrics.smooth_metrics(stack, smooth_n, ignore)):
            np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("ignore", [None, [0], [2, 5]])
def test_iou_evaluators_match_jax(ignore):
    port_np, port_dev = metrics.IouEval(C, ignore), metrics.DeviceIouEval(C, ignore)
    jax_np, jax_dev = jmetrics.IouEval(C, ignore), jmetrics.JaxIouEval(C, ignore)
    for seed in range(3):  # three batches streamed in
        preds, labels = _predictions(seed, 2000)
        port_np.addBatch(preds, labels)
        port_dev.addBatch(torch.from_numpy(preds), torch.from_numpy(labels))
        jax_np.addBatch(preds, labels)
        jax_dev.addBatch(preds, labels)
    # conf[pred, target], as JAX keeps it
    np.testing.assert_array_equal(port_np.conf_matrix, jax_np.conf_matrix)
    np.testing.assert_array_equal(port_dev.conf_matrix.numpy(), np.asarray(jax_dev.conf_matrix))
    assert port_dev.conf_matrix.dtype == torch.int64
    for port, jax_eval in ((port_np, jax_np), (port_dev, jax_dev)):
        for got, want in zip(port.getStats(), jax_eval.getStats()):
            np.testing.assert_array_equal(got, want)
        (got_mean, got_iou), (want_mean, want_iou) = port.getIoU(), jax_eval.getIoU()
        assert got_mean == want_mean
        np.testing.assert_array_equal(got_iou, want_iou)
        assert port.getacc() == jax_eval.getacc()
    port_dev.reset()
    assert int(port_dev.conf_matrix.sum()) == 0


def test_csv_writer_file_matches_jax(tmp_path):
    files = []
    for name, module in (("port", summary), ("jax", jsummary)):
        w = module.MetricWriter.create(str(tmp_path / name), "train", backend="csv")
        w.scalars({"loss": 1.25, "accuracy": 0.5}, step=3)
        w.scalar("lr", np.float32(1e-3), step=4)
        w.histogram("counts", np.arange(17) ** 1.5, step=5)
        w.flush()
        w.close()
        files.append((tmp_path / name / "metrics_train.csv").read_text())
    assert files[0] == files[1]
    assert files[0].splitlines()[0] == "step,name,value"
    assert "5,counts_p50," in files[0]
    again = summary.CsvMetricWriter(str(tmp_path / "port"), "train")  # appends, no new header
    again.scalar("loss", 2.0, 6)
    again.close()
    assert (tmp_path / "port" / "metrics_train.csv").read_text() == files[0] + "6,loss,2.0\n"


class _TinyState:
    """What the JAX CheckpointManager needs of a state to be saved: only
    its layout on disk is compared here."""


def test_checkpoint_manager_retention_matches_jax(tmp_path, monkeypatch):
    saves = [(1, True), (2, False), (3, False), (4, True), (5, False), (6, False), (7, False)]

    def fake_save(state, ckpt_dir, name="latest"):  # the directory, without orbax
        path = jckpt._resolve(ckpt_dir, name, for_save=True)
        if os.path.islink(path):
            os.unlink(path)
        os.makedirs(path, exist_ok=True)
        return path

    monkeypatch.setattr(jckpt, "save_checkpoint", fake_save)
    model = torch.nn.Linear(2, 2)
    state = TrainState(model, make_optimizer("momentum", lambda t: 0.1, model.parameters()))
    port, jax_mgr = (CheckpointManager(str(tmp_path / "port"), max_to_keep=3),
                     jckpt.CheckpointManager(str(tmp_path / "jax"), max_to_keep=3))
    for epoch, is_best in saves:
        port.save(state, epoch, is_best=is_best)
        jax_mgr.save(_TinyState(), epoch, is_best=is_best)
        assert port.epochs() == jax_mgr.epochs()
        assert port.best_epoch() == jax_mgr.best_epoch()
        assert port.latest_epoch() == jax_mgr.latest_epoch()
        for alias in ("latest", "best"):
            link = [os.readlink(os.path.join(m.ckpt_dir, alias))
                    if os.path.islink(os.path.join(m.ckpt_dir, alias)) else None
                    for m in (port, jax_mgr)]
            assert link[0] == link[1], alias  # relative links onto epoch_%05d
    assert port.epochs() == [4, 6, 7]  # best (4) survives the pruning
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert checkpoint.list_epochs(str(tmp_path / "port")) == [4, 6, 7]
    assert checkpoint.checkpoint_exists(str(tmp_path / "port"), "best")
    assert checkpoint.checkpoint_exists(str(tmp_path / "port"), 6)
    assert not checkpoint.checkpoint_exists(str(tmp_path / "port"), 5)
    assert os.path.isfile(tmp_path / "port" / "epoch_00007" / checkpoint.STATE_FILE)


def _small_cls_run():
    """A cls model small enough for the CPU, its state and a train step."""
    from pointasnl_tpu_torch.models import PointASNLCls

    model = PointASNLCls(5, adaptive_sample=True, generator=torch.Generator().manual_seed(0),
                         device="cpu")
    state = create_train_state(model, optimizer="adam",
                               lr_schedule=staircase_lr_schedule(1e-3, 2, 4, 0.7))
    assert state.step == 0 and isinstance(state.optimizer, torch.optim.Adam)
    step = make_train_step(bn_schedule=bn_momentum_schedule(2, 4), task="cls")
    rng = np.random.RandomState(3)
    batch = {"points": torch.from_numpy(rng.randn(2, 1024, 3).astype(np.float32)),
             "labels": torch.from_numpy(rng.randint(0, 5, 2))}
    return state, step, batch


def _snapshot(state, m):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {k: float(v) for k, v in m.items()})


def test_restore_continues_training_to_the_bit(tmp_path):
    """Two steps, a save at epoch 1, two more; a fresh model restored from
    the save takes the same two steps to the same bits (parameters, BN
    statistics, Adam's moments, the LR schedule's count, the dropout
    masks, which follow the step)."""
    rng = torch.Generator().manual_seed(11)
    state, step, batch = _small_cls_run()
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for _ in range(2):
        step(state, batch, rng)
    mgr.save(state, 1, is_best=True)
    torch.rand(5, generator=rng)  # draws change nothing: the masks follow its seed and the step
    first = [_snapshot(state, step(state, batch, rng)) for _ in range(2)]

    state2, step2, _ = _small_cls_run()
    assert not torch.equal(state2.model.fc1.dense.weight, state.model.fc1.dense.weight)
    mgr.restore(state2, "best")
    assert state2.step == 2 and state2.optimizer.param_groups[0]["update_count"] == 2
    again = [_snapshot(state2, step2(state2, batch, torch.Generator().manual_seed(11)))
             for _ in range(2)]
    for (w1, m1), (w2, m2) in zip(first, again):
        assert m1 == m2
        assert w1.keys() == w2.keys() and all(torch.equal(w1[k], w2[k]) for k in w1)
    for p, q in zip(state.model.parameters(), state2.model.parameters()):
        s1, s2 = state.optimizer.state[p], state2.optimizer.state[q]
        assert torch.equal(s1["exp_avg"], s2["exp_avg"])
        assert torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])


def test_step_trace_window_writes_its_trace(tmp_path):
    logs = []
    win = profiling.StepTraceWindow(str(tmp_path / "profile"), enabled=True, steps=2,
                                    log=logs.append)
    timer = profiling.StepTimer(points_per_step=1000)
    x = torch.randn(64, 64)
    for _ in range(4):
        with timer.step():
            win.traced(lambda: (x @ x).sum())
    win.close()
    assert win.path is not None and os.path.getsize(win.path) > 0
    assert os.listdir(tmp_path / "profile") == [os.path.basename(win.path)]
    assert logs == [f"profile trace written to {win.path}"]
    assert timer.steps == 4 and "M points/sec" in timer.summary()
    off = profiling.StepTraceWindow(str(tmp_path / "off"), enabled=False)
    off.traced(lambda: None)
    off.close()
    assert not (tmp_path / "off").exists()
    with profiling.trace(str(tmp_path / "ctx")):
        with profiling.annotate("span"):
            (x @ x).sum()
    assert len(os.listdir(tmp_path / "ctx")) == 1
