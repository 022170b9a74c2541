"""ScanNet segmentation trainer (random-crop pipeline), the port's
counterpart of ``pointasnl_tpu/cli/train_scannet.py`` (a rebuild of
ScanNet/train_scannet.py).

Same recipe and flags: B=6, N=8192, 21 classes, weighted CE + repulsion
loss, per-batch z-rotation + unit-sphere normalisation, chopped-scene eval
each epoch and whole-scene tiled eval every `whole_eval_gap` epochs after
`whole_eval_start` (reference: every 10 after 500, train_scannet.py:201-203),
an epoch-numbered checkpoint each epoch with ``latest`` on it, and ``best``
on the whole-scene mIoU. It runs on the card unless ``--device cpu``; the
dropout masks come from a generator seeded with ``--seed`` + 1.

    python -m pointasnl_tpu_torch.cli.train_scannet --data <dir> --log_dir <dir>
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
    str2bool,
)

SEG_LABEL_TO_CAT = {
    0: "unannotated", 1: "wall", 2: "floor", 3: "chair", 4: "table", 5: "desk",
    6: "bed", 7: "bookshelf", 8: "sofa", 9: "sink", 10: "bathtub", 11: "toilet",
    12: "curtain", 13: "counter", 14: "door", 15: "window", 16: "shower curtain",
    17: "refrigerator", 18: "picture", 19: "cabinet", 20: "otherfurniture",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_scannet")
    p.add_argument("--data", default="data/ScanNet/")
    p.add_argument("--model", default="pointasnl_sem_seg")
    p.add_argument("--log_dir", default="logs/scannet")
    p.add_argument("--pretrain_dir", default=None)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--max_epoch", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=200000)
    p.add_argument("--decay_rate", type=float, default=0.7)
    p.add_argument("--with_rgb", type=str2bool, default=True)
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--whole_eval_start", type=int, default=500)
    p.add_argument("--whole_eval_gap", type=int, default=10)
    add_nl_args(p)
    add_dp_arg(p)
    add_device_arg(p)
    p.add_argument(
        "--max_to_keep", type=int, default=100,
        help="retained epoch-numbered checkpoints (<=0 keeps all)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first train steps of epoch 0 into <log_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    return p.parse_args(argv)


def get_batch(dataset, idxs, start_idx, end_idx, num_point, feature_channel):
    bsize = end_idx - start_idx
    batch_data = np.zeros((bsize, num_point, 3 + feature_channel), np.float32)
    batch_label = np.zeros((bsize, num_point), np.int32)
    batch_smpw = np.zeros((bsize, num_point), np.float32)
    for i in range(bsize):
        ps, seg, smpw = dataset[idxs[i + start_idx]]
        batch_data[i] = ps
        batch_label[i] = seg
        batch_smpw[i] = smpw
    return batch_data, batch_label, batch_smpw


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data import provider
    from pointasnl_tpu_torch.data.scannet import ScannetDataset, ScannetDatasetWholeScene
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
    rs = np.random.RandomState(flags.seed)
    feature_channel = 3 if flags.with_rgb else 0

    log("Loading datasets ...")
    train_ds = ScannetDataset(
        flags.data, block_points=flags.num_point, split="train", with_rgb=flags.with_rgb,
        random_state=rs,
    )
    val_ds = ScannetDataset(
        flags.data, block_points=flags.num_point, split="val", with_rgb=flags.with_rgb,
        random_state=rs,
    )
    whole_ds = ScannetDatasetWholeScene(
        flags.data, block_points=flags.num_point, split="val", with_rgb=flags.with_rgb,
        random_state=rs,
    )

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
        log(f"restored pretrain from {flags.pretrain_dir} at step {state.step}")
    elif checkpoint_exists(flags.log_dir, "latest"):
        state = restore_checkpoint(state, flags.log_dir, "latest")
        log(f"resumed from latest checkpoint at step {state.step}")

    train_step = make_train_step(bn_schedule=bn_sched, task="seg", uniform_weight=0.01)
    eval_step = make_eval_step(task="seg")
    dropout_rng = torch.Generator(device=dev).manual_seed(flags.seed + 1)
    writers = {split: MetricWriter.create(flags.log_dir, split, backend="csv")
               for split in ("train", "eval")}

    def on_device(a):
        return torch.from_numpy(a).to(dev)

    def run_eval_batch(batch_data, batch_label, batch_smpw, acc: SegEvalAccumulator):
        batch_data, batch_label, batch_smpw, bsize = pad_seg_batch(
            batch_data, batch_label, batch_smpw, flags.batch_size
        )
        logits, _ = eval_step(
            state, {"points": on_device(batch_data), "labels": on_device(batch_label)})
        preds = logits.argmax(-1).cpu().numpy()[:bsize]
        acc.update(preds, batch_label[:bsize], batch_smpw[:bsize])

    ckpt_mgr = CheckpointManager(
        flags.log_dir,
        max_to_keep=flags.max_to_keep if flags.max_to_keep > 0 else None,
    )
    try:
        best_iou = 0.0
        best_whole_iou = 0.0
        max_epoch = 2 if flags.debug else flags.max_epoch
        for epoch in range(max_epoch):
            log(f"**** EPOCH {epoch:03d} ****")
            t0 = time.time()
            # --- train ---
            train_idxs = np.arange(len(train_ds))
            rs.shuffle(train_idxs)
            num_batches = 1 if flags.debug else len(train_ds) // flags.batch_size
            loss_sum = torch.zeros((), device=dev)
            tracer = StepTraceWindow(
                os.path.join(flags.log_dir, "profile"),
                enabled=flags.profile and epoch == 0, log=log,
            )
            try:
                for b in range(num_batches):
                    batch_data, batch_label, batch_smpw = get_batch(
                        train_ds, train_idxs, b * flags.batch_size, (b + 1) * flags.batch_size,
                        flags.num_point, feature_channel,
                    )
                    batch_data[:, :, :3] = provider.rotate_point_cloud_z(
                        batch_data[:, :, :3], random_state=rs
                    )
                    batch_data[:, :, :3] = provider.normalize_data(batch_data[:, :, :3])
                    batch = {"points": on_device(batch_data), "labels": on_device(batch_label),
                             "smpw": on_device(batch_smpw)}
                    metrics = tracer.traced(lambda: train_step(state, batch, dropout_rng))
                    loss_sum = loss_sum + metrics["loss"]  # on the device: no sync a step
            finally:
                tracer.close()
            train_loss = float(loss_sum) / max(num_batches, 1)
            lr = float(lr_sched(state.step))
            log(f"train loss {train_loss:.4f} ({time.time() - t0:.1f}s, lr {lr:.6f})")
            writers["train"].scalars({"loss": train_loss, "learning_rate": lr}, state.step)

            # --- chopped-scene eval ---
            acc = SegEvalAccumulator(flags.num_classes)
            val_batches = 1 if flags.debug else len(val_ds) // flags.batch_size
            val_idxs = np.arange(len(val_ds))
            for b in range(val_batches):
                batch_data, batch_label, batch_smpw = get_batch(
                    val_ds, val_idxs, b * flags.batch_size, (b + 1) * flags.batch_size,
                    flags.num_point, feature_channel,
                )
                batch_data[:, :, :3] = provider.normalize_data(batch_data[:, :, :3])
                batch_data[:, :, :3] = provider.rotate_point_cloud_z(
                    batch_data[:, :, :3], random_state=rs
                )
                run_eval_batch(batch_data, batch_label, batch_smpw, acc)
            iou = acc.miou()
            log(f"eval point avg class IoU: {iou:.5f} acc: {acc.accuracy():.5f}")
            writers["eval"].scalars({"miou": iou, "accuracy": acc.accuracy()}, state.step)

            # --- whole-scene eval (carry leftover blocks across scenes) ---
            whole_iou = 0.0
            whole_eval = epoch > flags.whole_eval_start or flags.debug
            if epoch % flags.whole_eval_gap == 0 and whole_eval:
                wacc = SegEvalAccumulator(flags.num_classes)
                carry_d = np.zeros((0, flags.num_point, 3 + feature_channel), np.float32)
                carry_l = np.zeros((0, flags.num_point), np.int32)
                carry_w = np.zeros((0, flags.num_point), np.float32)
                n_scenes = 1 if flags.debug else len(whole_ds)
                for si in range(n_scenes):
                    sd, sl, sw = whole_ds[si]
                    carry_d = np.concatenate([carry_d, sd.astype(np.float32)], 0)
                    carry_l = np.concatenate([carry_l, sl.astype(np.int32)], 0)
                    carry_w = np.concatenate([carry_w, sw.astype(np.float32)], 0)
                    while carry_d.shape[0] >= flags.batch_size:
                        bd = carry_d[: flags.batch_size].copy()
                        bl = carry_l[: flags.batch_size]
                        bw = carry_w[: flags.batch_size]
                        carry_d = carry_d[flags.batch_size:]
                        carry_l = carry_l[flags.batch_size:]
                        carry_w = carry_w[flags.batch_size:]
                        bd[:, :, :3] = provider.normalize_data(bd[:, :, :3])
                        run_eval_batch(bd, bl, bw, wacc)
                if carry_d.shape[0] > 0:
                    carry_d[:, :, :3] = provider.normalize_data(carry_d[:, :, :3])
                    run_eval_batch(carry_d, carry_l, carry_w, wacc)
                whole_iou = wacc.miou()
                log(f"Whole scene class avg mIOU: {whole_iou:.5f}")
                writers["eval"].scalars({"whole_scene_miou": whole_iou}, state.step)
                per_class = wacc.per_class_iou()
                for c in range(1, flags.num_classes):
                    log(f"  class {SEG_LABEL_TO_CAT.get(c, str(c)):<16s} IoU: {per_class[c]:.3f}")

            best_iou = max(best_iou, iou)
            is_best = whole_iou >= best_whole_iou and whole_iou > 0
            if is_best:
                best_whole_iou = whole_iou
                log(f"new best whole-scene mIoU: {best_whole_iou:.5f}")
            ckpt_mgr.save(state, epoch, is_best=is_best)
            log(f"Best chopped mIoU: {best_iou:.5f}")
            if best_whole_iou > 0:
                log(f"Best whole-scene mIoU: {best_whole_iou:.5f}")
    finally:
        for writer in writers.values():
            writer.close()
        log.close()
    return best_iou


if __name__ == "__main__":
    main()
