"""ModelNet40 classification trainer, the port's counterpart of
``pointasnl_tpu/cli/train_modelnet.py`` (a rebuild of train.py).

Same flag surface and training recipe (train.py:18-35,95-113,208-264):
B=16, N=1024, adam with staircase LR decay (x0.7 / 200k samples, floor 1e-5),
scheduled BN momentum 0.5->0.99, numpy augmentation pipeline per batch
(rotation -> scale -> shift -> shared point shuffle -> random dropout) on a
Prefetcher's thread (capacity 4), per-epoch eval, best+latest checkpoints,
auto-resume from latest, CSV metrics. ``--precision bfloat16`` runs the
dense layers in bfloat16 (``nn.precision``). It runs on the card unless
``--device cpu``; ``--dp`` is not ported and raises; the dropout masks come
from a generator seeded with ``--seed`` + 1.

    python -m pointasnl_tpu_torch.cli.train_modelnet --data <modelnet40_normal_resampled> \\
        --log_dir <dir> --AS --normal
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import add_device_arg, add_dp_arg, check_dp, device


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_modelnet")
    p.add_argument("--data", default="data/modelnet40_normal_resampled", help="dataset root")
    p.add_argument("--log_dir", default="logs/modelnet_cls", help="log/checkpoint dir")
    p.add_argument("--model", default="pointasnl_cls")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--max_epoch", type=int, default=251)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument(
        "--max_to_keep", type=int, default=100,
        help="retained epoch-numbered checkpoints (<=0 keeps all)",
    )
    p.add_argument("--AS", action="store_true", help="adaptive sampling")
    p.add_argument("--normal", action="store_true", help="use normals as features")
    p.add_argument("--rotation", action="store_true", help="rotation augmentation")
    p.add_argument("--uniform", action="store_true", help="FPS resampling in the dataset")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument(
        "--precision", default="float32", choices=["float32", "bfloat16"],
        help="compute dtype of the dense layers (nn/precision.py)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true", help="1 batch per epoch, 2 epochs")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first train steps of epoch 0 into <log_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    add_dp_arg(p)
    add_device_arg(p)
    return p.parse_args(argv)


def pad_batch(batch_data, batch_label, batch_size):
    """Pad a short tail batch up to the static batch size (repeat row 0)."""
    bsize = batch_data.shape[0]
    if bsize == batch_size:
        return batch_data, batch_label, bsize
    data = np.concatenate([batch_data, np.repeat(batch_data[:1], batch_size - bsize, 0)], 0)
    label = np.concatenate([batch_label, np.repeat(batch_label[:1], batch_size - bsize, 0)], 0)
    return data, label, bsize


def augment_batch(batch_data, flags, rs):
    from pointasnl_tpu_torch.data import provider

    if flags.rotation:
        if flags.normal:
            batch_data = provider.rotate_point_cloud_with_normal(batch_data, random_state=rs)
            batch_data = provider.rotate_perturbation_point_cloud_with_normal(
                batch_data, random_state=rs
            )
        else:
            batch_data = provider.rotate_point_cloud(batch_data, random_state=rs)
            batch_data = provider.rotate_perturbation_point_cloud(batch_data, random_state=rs)
    batch_data = np.asarray(batch_data)
    batch_data[:, :, 0:3] = provider.random_scale_point_cloud(
        batch_data[:, :, 0:3], random_state=rs
    )
    batch_data[:, :, 0:3] = provider.shift_point_cloud(batch_data[:, :, 0:3], random_state=rs)
    batch_data = provider.shuffle_points(batch_data, random_state=rs)
    batch_data = provider.random_point_dropout(batch_data, random_state=rs)
    return batch_data


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)
    from pointasnl_tpu_torch.nn import precision

    # The policy is read at every dense layer's call: it covers the steps.
    with precision.compute_dtype(flags.precision):
        return _main_body(flags, dev)


def _main_body(flags, dev):
    from pointasnl_tpu_torch.data.grid_pipeline import Prefetcher
    from pointasnl_tpu_torch.data.modelnet import ModelNetDataset
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        CheckpointManager,
        bn_momentum_schedule,
        checkpoint_exists,
        create_train_state,
        make_eval_step,
        make_train_step,
        restore_checkpoint,
        staircase_lr_schedule,
    )
    from pointasnl_tpu_torch.train.profiling import StepTraceWindow
    from pointasnl_tpu_torch.train.summary import MetricWriter
    from pointasnl_tpu_torch.utils import Logger, save_args, snapshot_sources

    log = Logger(flags.log_dir)
    save_args(flags, flags.log_dir)
    snapshot_sources(flags.log_dir, flags.model, extra_modules=(__file__,))
    writers = {split: MetricWriter.create(flags.log_dir, split, backend="csv")
               for split in ("train", "test")}
    rs = np.random.RandomState(flags.seed)

    train_ds, test_ds = (ModelNetDataset(
        flags.data, batch_size=flags.batch_size, npoints=flags.num_point, split=split,
        normal_channel=flags.normal, uniform=flags.uniform, random_state=rs,
    ) for split in ("train", "test"))

    model = get_model_class(flags.model)(
        num_class=flags.num_classes, use_normal=flags.normal, adaptive_sample=flags.AS,
        generator=torch.Generator().manual_seed(flags.seed), device=dev,
    )
    lr_sched = staircase_lr_schedule(
        flags.learning_rate, flags.batch_size, float(flags.decay_step), flags.decay_rate
    )
    bn_sched = bn_momentum_schedule(flags.batch_size, float(flags.decay_step))
    state = create_train_state(model, optimizer=flags.optimizer, lr_schedule=lr_sched,
                               momentum=flags.momentum)
    if checkpoint_exists(flags.log_dir, "latest"):
        state = restore_checkpoint(state, flags.log_dir, "latest")
        log(f"resumed from latest checkpoint at step {state.step}")

    train_step = make_train_step(bn_schedule=bn_sched, task="cls")
    eval_step = make_eval_step(task="cls")
    dropout_rng = torch.Generator(device=dev).manual_seed(flags.seed + 1)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    max_epoch = 2 if flags.debug else flags.max_epoch
    ckpt_mgr = CheckpointManager(
        flags.log_dir,
        max_to_keep=flags.max_to_keep if flags.max_to_keep > 0 else None,
    )
    best_acc = 0.0
    try:
        for epoch in range(max_epoch):
            log(f"**** EPOCH {epoch:03d} ****")
            # --- train (host augmentation on a thread beside the steps) ---
            t0 = time.time()
            total_seen = num_batches = 0
            loss_sum = torch.zeros((), device=dev)
            correct_sum = torch.zeros((), device=dev)

            def augmented_batches():
                while train_ds.has_next_batch():
                    batch_data, batch_label = train_ds.next_batch()
                    batch_data = augment_batch(batch_data, flags, rs)
                    yield pad_batch(batch_data.astype(np.float32), batch_label, flags.batch_size)
                    if flags.debug:
                        break

            tracer = StepTraceWindow(
                os.path.join(flags.log_dir, "profile"),
                enabled=flags.profile and epoch == 0, steps=5, log=log,
            )
            try:
                with Prefetcher(augmented_batches(), capacity=4) as batches:
                    for batch_data, batch_label, bsize in batches:
                        batch = {"points": on_device(batch_data),
                                 "labels": on_device(batch_label)}
                        metrics = tracer.traced(lambda: train_step(state, batch, dropout_rng))
                        # on the device: no sync a step
                        loss_sum = loss_sum + metrics["loss"]
                        correct_sum = correct_sum + metrics["accuracy"] * flags.batch_size
                        total_seen += bsize
                        num_batches += 1
            finally:
                tracer.close()
            train_ds.reset()
            train_loss = float(loss_sum) / max(num_batches, 1)
            train_acc = float(correct_sum) / max(total_seen, 1)
            lr = float(lr_sched(state.step))
            log(f"train loss {train_loss:.4f} acc {train_acc:.4f} "
                f"({time.time() - t0:.1f}s, lr {lr:.6f})")
            writers["train"].scalars({"loss": train_loss, "accuracy": train_acc,
                                      "learning_rate": lr,
                                      "bn_decay": float(bn_sched(state.step))}, state.step)
            writers["train"].flush()

            # --- eval ---
            total_correct = total_seen = 0
            class_seen = np.zeros(flags.num_classes)
            class_correct = np.zeros(flags.num_classes)
            while test_ds.has_next_batch():
                batch_data, batch_label = test_ds.next_batch()
                batch_data, batch_label, bsize = pad_batch(
                    batch_data.astype(np.float32), batch_label, flags.batch_size
                )
                logits, _ = eval_step(state, {"points": on_device(batch_data),
                                              "labels": on_device(batch_label)})
                preds = logits.argmax(-1).cpu().numpy()[:bsize]
                labels = batch_label[:bsize]
                total_correct += int(np.sum(preds == labels))
                total_seen += bsize
                for i in range(bsize):
                    class_seen[labels[i]] += 1
                    class_correct[labels[i]] += int(preds[i] == labels[i])
                if flags.debug:
                    break
            test_ds.reset()
            acc = total_correct / max(total_seen, 1)
            avg_class_acc = float(np.mean(class_correct / np.maximum(class_seen, 1)))
            log(f"eval accuracy: {acc:.4f} avg class acc: {avg_class_acc:.4f}")
            writers["test"].scalars({"accuracy": acc, "avg_class_accuracy": avg_class_acc},
                                    state.step)
            writers["test"].flush()

            is_best = acc >= best_acc  # >= so a "best" checkpoint always exists
            if is_best:
                best_acc = acc
                log(f"new best accuracy: {best_acc:.4f}")
            ckpt_mgr.save(state, epoch, is_best=is_best)
        log(f"done; best eval accuracy {best_acc:.4f}")
    finally:
        for writer in writers.values():
            writer.close()
        log.close()
    return best_acc


if __name__ == "__main__":
    main()
