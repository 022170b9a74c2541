"""SemanticKITTI segmentation trainer (block-crop pipeline), the port's
counterpart of ``pointasnl_tpu/cli/train_semantic_kitti.py`` (a rebuild of
SemanticKITTI/train_semantic_kitti.py).

Same recipe and flags: B=6, N=8192, 20 classes, weighted CE + repulsion,
per-batch z-rotation (no normalisation: KITTI coordinates are metric,
train_semantic_kitti.py:244), optional remission channel
(``--with_remission``: feature_channel=1), random-crop eval on the valid
split each epoch, an epoch-numbered checkpoint each epoch with ``latest`` on
it and ``best`` on the eval mIoU. The train crops are drawn on a
Prefetcher's thread (capacity 4), as the JAX trainer draws them. It runs on
the card unless ``--device cpu``; ``--dp`` is not ported and raises; the
dropout masks come from a generator seeded with ``--seed`` + 1.

    python -m pointasnl_tpu_torch.cli.train_semantic_kitti --data <dataset> --log_dir <dir>
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    SegEvalAccumulator,
    add_device_arg,
    add_dp_arg,
    add_nl_args,
    check_dp,
    device,
    nl_kwargs,
    pad_seg_batch,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_semantic_kitti")
    p.add_argument("--data", default="data/kitti/dataset/")
    p.add_argument("--model", default="pointasnl_sem_seg")
    p.add_argument("--log_dir", default="logs/semantic_kitti")
    p.add_argument("--pretrain_dir", default=None)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--max_epoch", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    add_nl_args(p)
    add_dp_arg(p)
    add_device_arg(p)
    p.add_argument(
        "--max_to_keep", type=int, default=100,
        help="retained epoch-numbered checkpoints (<=0 keeps all)",
    )
    p.add_argument("--with_remission", action="store_true")
    p.add_argument("--config_file", default=None, help="external semantic-kitti.yaml")
    p.add_argument("--num_classes", type=int, default=20)
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = full dataset")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first train steps of epoch 0 into <log_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    return p.parse_args(argv)


def get_batch(dataset, idxs, start, end, num_point, feature_channel):
    bsize = end - start
    bd = np.zeros((bsize, num_point, 3 + feature_channel), np.float32)
    bl = np.zeros((bsize, num_point), np.int32)
    bw = np.zeros((bsize, num_point), np.float32)
    for i in range(bsize):
        bd[i], bl[i], bw[i] = dataset[idxs[i + start]]
    return bd, bl, bw


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data import provider
    from pointasnl_tpu_torch.data.grid_pipeline import Prefetcher
    from pointasnl_tpu_torch.data.semantic_kitti import SemanticKittiDataset
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
    from pointasnl_tpu_torch.utils import Logger, save_args, snapshot_sources

    log = Logger(flags.log_dir)
    save_args(flags, flags.log_dir)
    snapshot_sources(flags.log_dir, flags.model, extra_modules=(__file__,))
    rs = np.random.RandomState(flags.seed)
    feature_channel = 1 if flags.with_remission else 0

    datasets = {split: SemanticKittiDataset(
        flags.data, sample_points=flags.num_point, split=split,
        with_remission=flags.with_remission, config_file=flags.config_file, random_state=rs,
    ) for split in ("train", "valid")}
    train_ds, val_ds = datasets["train"], datasets["valid"]

    model = get_model_class(flags.model)(
        num_class=flags.num_classes, feature_channel=feature_channel, **nl_kwargs(flags),
        generator=torch.Generator().manual_seed(flags.seed), device=dev,
    )
    lr_sched = staircase_lr_schedule(
        flags.learning_rate, flags.batch_size, float(flags.decay_step), flags.decay_rate
    )
    bn_sched = bn_momentum_schedule(flags.batch_size, float(flags.decay_step))
    state = create_train_state(model, optimizer=flags.optimizer, lr_schedule=lr_sched,
                               momentum=flags.momentum)
    if flags.pretrain_dir and checkpoint_exists(flags.pretrain_dir, "latest"):
        state = restore_checkpoint(state, flags.pretrain_dir, "latest")
        log(f"restored pretrain from {flags.pretrain_dir}")
    elif checkpoint_exists(flags.log_dir, "latest"):
        state = restore_checkpoint(state, flags.log_dir, "latest")
        log(f"resumed from step {state.step}")

    train_step = make_train_step(bn_schedule=bn_sched, task="seg", uniform_weight=0.01)
    eval_step = make_eval_step(task="seg")
    dropout_rng = torch.Generator(device=dev).manual_seed(flags.seed + 1)

    def on_device(a):
        return torch.from_numpy(a).to(dev)

    ckpt_mgr = CheckpointManager(
        flags.log_dir,
        max_to_keep=flags.max_to_keep if flags.max_to_keep > 0 else None,
    )
    try:
        best_iou = 0.0
        max_epoch = 2 if flags.debug else flags.max_epoch
        for epoch in range(max_epoch):
            log(f"**** EPOCH {epoch:03d} ****")
            t0 = time.time()
            train_idxs = np.arange(len(train_ds))
            rs.shuffle(train_idxs)
            num_batches = len(train_ds) // flags.batch_size
            if flags.steps_per_epoch:
                num_batches = min(num_batches, flags.steps_per_epoch)
            if flags.debug:
                num_batches = 1
            loss_sum = torch.zeros((), device=dev)

            def train_batches():
                for b in range(num_batches):
                    bd, bl, bw = get_batch(train_ds, train_idxs, b * flags.batch_size,
                                           (b + 1) * flags.batch_size, flags.num_point,
                                           feature_channel)
                    bd[:, :, :3] = provider.rotate_point_cloud_z(bd[:, :, :3], random_state=rs)
                    yield bd, bl, bw

            tracer = StepTraceWindow(
                os.path.join(flags.log_dir, "profile"),
                enabled=flags.profile and epoch == 0, log=log,
            )
            try:
                # Nothing else draws from rs while the thread draws the crops,
                # so the batches and their order are those of a loop.
                with Prefetcher(train_batches(), capacity=4) as batches:
                    for bd, bl, bw in batches:
                        batch = {"points": on_device(bd), "labels": on_device(bl),
                                 "smpw": on_device(bw)}
                        metrics = tracer.traced(lambda: train_step(state, batch, dropout_rng))
                        loss_sum = loss_sum + metrics["loss"]  # on the device: no sync a step
            finally:
                tracer.close()
            log(
                f"train loss {float(loss_sum) / max(num_batches, 1):.4f} "
                f"({time.time() - t0:.1f}s, lr {float(lr_sched(state.step)):.6f})"
            )

            # --- eval on random crops of the valid split ---
            acc = SegEvalAccumulator(flags.num_classes)
            val_idxs = np.arange(len(val_ds))
            rs.shuffle(val_idxs)
            val_batches = 1 if flags.debug else max(len(val_ds) // flags.batch_size // 10, 1)
            for b in range(val_batches):
                bd, bl, bw = get_batch(val_ds, val_idxs, b * flags.batch_size,
                                       (b + 1) * flags.batch_size, flags.num_point,
                                       feature_channel)
                bd[:, :, :3] = provider.rotate_point_cloud_z(bd[:, :, :3], random_state=rs)
                bd, bl, bw, bsize = pad_seg_batch(bd, bl, bw, flags.batch_size)
                logits, _ = eval_step(state, {"points": on_device(bd), "labels": on_device(bl)})
                preds = logits.argmax(-1).cpu().numpy()[:bsize]
                acc.update(preds, bl[:bsize], bw[:bsize])
            iou = acc.miou()
            log(f"eval point avg class IoU: {iou:.5f} acc: {acc.accuracy():.5f}")

            is_best = iou >= best_iou
            if is_best:
                best_iou = iou
                log(f"new best mIoU: {best_iou:.5f}")
            ckpt_mgr.save(state, epoch, is_best=is_best)
    finally:
        log.close()
    return best_iou


if __name__ == "__main__":
    main()
