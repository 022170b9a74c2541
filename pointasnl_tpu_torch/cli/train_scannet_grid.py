"""ScanNet grid-sampled trainer, the port's counterpart of
``pointasnl_tpu/cli/train_scannet_grid.py`` (a rebuild of
ScanNet/train_scannet_grid.py, the flagship 66.6-mIoU recipe:
--num_point 10240 --in_radius 2 --model pointasnl_sem_seg_res).

Same recipe and flags: potential-based spatially-regular crops, per-cloud
augmentation, weighted CE + repulsion, lr decay x0.5 / 400k samples; the
batches come through a Prefetcher of 8. Validation via EMA (0.95) of
per-cloud class probabilities with confusion rebalancing by true class
proportions (train_scannet_grid.py:304-385), and a vote-projection eval
(subcloud probs -> mesh vertices through the cached projection indices)
every `snapshot_gap` epochs (:387-432), ``best`` on its mIoU (in percent).
args.txt JSON is written for the tester. The confusion matrices are counted
with numpy (``seg_common.label_confusion``). It runs on the card unless
``--device cpu``; ``--dp`` is not ported and raises.

    python -m pointasnl_tpu_torch.cli.train_scannet_grid --data <dir> --log_dir <dir> \\
        --num_point 10240 --in_radius 2
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    add_device_arg,
    add_dp_arg,
    add_nl_args,
    check_dp,
    class_probs,
    device,
    drop_ignored,
    label_confusion,
    nl_kwargs,
    str2bool,
    with_ignored_columns,
)
from pointasnl_tpu_torch.cli.train_scannet import SEG_LABEL_TO_CAT


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_scannet_grid")
    p.add_argument("--data", default="data/Scannet")
    p.add_argument("--model", default="pointasnl_sem_seg_res")
    p.add_argument("--log_dir", default="logs/scannet_grid")
    p.add_argument("--pretrain_dir", default=None)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--num_buffer", type=int, default=1024)
    p.add_argument("--in_radius", type=float, default=0)
    p.add_argument("--epoch_sample", type=int, default=4800)
    p.add_argument("--validation_size", type=int, default=100)
    p.add_argument("--max_epoch", type=int, default=500)
    p.add_argument("--from_epoch", type=int, default=0)
    p.add_argument("--snapshot_gap", type=int, default=20)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=0.001)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--optimizer", default="adam", choices=["adam", "momentum"])
    p.add_argument("--decay_step", type=int, default=400000)
    p.add_argument("--decay_rate", type=float, default=0.5)
    add_nl_args(p)
    add_dp_arg(p)
    add_device_arg(p)
    p.add_argument(
        "--max_to_keep", type=int, default=100,
        help="retained epoch-numbered checkpoints (<=0 keeps all)",
    )
    p.add_argument("--with_rgb", type=str2bool, default=True)
    p.add_argument("--input_threads", type=int, default=8)
    p.add_argument("--first_subsampling_dl", type=float, default=0.04)
    p.add_argument("--trainval", action="store_true")
    p.add_argument("--debug", action="store_true")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first train steps of the first epoch into "
        "<log_dir>/profile (a Chrome trace: Perfetto, chrome://tracing)",
    )
    p.add_argument("--seed", type=int, default=0)
    flags = p.parse_args(argv)
    flags.epoch_steps = flags.epoch_sample // flags.batch_size
    if flags.debug:
        flags.epoch_steps = 2
        flags.snapshot_gap = 1
        flags.validation_size = 2
        flags.max_epoch = 2
    return flags


def validation_eval(
    dataset, validation_probs, val_proportions, predictions, targets, num_classes
):
    """Rebalanced-confusion mIoU (percent) over this epoch's validation crops
    (:353-385)."""
    from pointasnl_tpu_torch.train.metrics import IoU_from_confusions

    label_values = dataset.label_values
    ignored = set(dataset.ignored_labels.tolist())
    confs = np.zeros((len(predictions), num_classes, num_classes), np.int32)
    for i, (probs, truth) in enumerate(zip(predictions, targets)):
        probs = with_ignored_columns(probs, label_values, ignored)
        preds = label_values[np.argmax(probs, axis=1)]
        confs[i] = label_confusion(truth, preds, label_values)

    C = drop_ignored(np.sum(confs, axis=0).astype(np.float32), label_values, ignored)
    C *= np.expand_dims(val_proportions / (np.sum(C, axis=1) + 1e-6), 1)
    return 100 * float(np.mean(IoU_from_confusions(C)))


def vote_projection_eval(dataset, validation_probs, num_classes, log):
    """Project EMA'd subcloud probs to mesh vertices, confusion + mIoU
    (percent) (:387-432)."""
    from pointasnl_tpu_torch.train.metrics import IoU_from_confusions

    label_values = dataset.label_values
    ignored = set(dataset.ignored_labels.tolist())
    confs = np.zeros((num_classes, num_classes), np.int32)
    i_val = 0
    for i, _file_path in enumerate(dataset.train_files):
        if dataset.all_splits[i] == 1:  # validation split
            sub_probs = with_ignored_columns(validation_probs[i_val], label_values, ignored)
            sub_preds = label_values[np.argmax(sub_probs, axis=1).astype(np.int32)]
            preds = sub_preds[dataset.validation_proj[i_val]].astype(np.int32)
            labels = dataset.validation_labels[i_val].astype(np.int32)
            confs += label_confusion(labels, preds, label_values).astype(np.int32)
            i_val += 1

    IoUs = IoU_from_confusions(drop_ignored(confs, label_values, ignored))
    for l in range(1, num_classes):
        log(f"  class {SEG_LABEL_TO_CAT[l]:<16s} IoU: {100 * IoUs[l - 1]:.3f}")
    return 100 * float(np.mean(IoUs))


def model_input(batch, with_rgb: bool) -> np.ndarray:
    """The network's input of a grid batch: xyz, then rgb where used."""
    pts = batch["points"].astype(np.float32)
    if with_rgb:
        return np.concatenate([pts, batch["colors"].astype(np.float32)], axis=-1)
    return pts


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data.grid_pipeline import GridConfig, Prefetcher
    from pointasnl_tpu_torch.data.scannet_grid import ScannetGridDataset
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        CheckpointManager,
        bn_momentum_schedule,
        checkpoint_exists,
        create_train_state,
        make_predict_step,
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
    feature_channel = 3 if flags.with_rgb else 0
    num_classes = 21

    dataset = ScannetGridDataset(
        flags.data,
        npoint=flags.num_point,
        buffer=flags.num_buffer,
        debug=flags.debug,
        trainval=flags.trainval,
        random_state=rs,
    )
    dataset.load_subsampled_clouds(flags.first_subsampling_dl)

    cfg = GridConfig(
        batch_size=flags.batch_size,
        epoch_steps=flags.epoch_steps,
        validation_size=flags.validation_size,
        in_radius=flags.in_radius,
        input_threads=flags.input_threads,
    )

    model = get_model_class(flags.model)(
        num_class=num_classes, feature_channel=feature_channel, **nl_kwargs(flags),
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
    predict = make_predict_step()
    dropout_rng = torch.Generator(device=dev).manual_seed(flags.seed + 1)

    def on_device(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    has_validation = dataset.num_validation > 0
    validation_probs = None
    val_proportions = None
    if has_validation:
        validation_probs = [
            np.zeros((l.shape[0], num_classes - 1)) for l in dataset.input_labels["validation"]
        ]
        val_proportions = np.zeros(num_classes - 1, np.float32)
        i = 0
        for label_value in dataset.label_values:
            if label_value not in dataset.ignored_labels:
                val_proportions[i] = np.sum(
                    [np.sum(labels == label_value) for labels in dataset.validation_labels]
                )
                i += 1

    ckpt_mgr = CheckpointManager(
        flags.log_dir,
        max_to_keep=flags.max_to_keep if flags.max_to_keep > 0 else None,
    )
    best_vote_iou = 0.0
    val_smooth = 0.95
    try:
        for epoch in range(flags.from_epoch, flags.max_epoch):
            log(f"**** EPOCH {epoch:03d} ****")
            t0 = time.time()
            loss_sum = torch.zeros((), device=dev)
            nsteps = 0
            tracer = StepTraceWindow(
                os.path.join(flags.log_dir, "profile"),
                enabled=flags.profile and epoch == flags.from_epoch,
                log=log,
            )
            try:
                with Prefetcher(dataset.batches("training", cfg), capacity=8) as batches:
                    for batch in batches:
                        feed = {"points": on_device(model_input(batch, flags.with_rgb)),
                                "labels": on_device(batch["labels"]),
                                "smpw": on_device(batch["label_weights"])}
                        metrics = tracer.traced(lambda: train_step(state, feed, dropout_rng))
                        loss_sum = loss_sum + metrics["loss"]  # on the device: no sync a step
                        nsteps += 1
            finally:
                tracer.close()
            log(
                f"train loss {float(loss_sum) / max(nsteps, 1):.4f} "
                f"({time.time() - t0:.1f}s, lr {float(lr_sched(state.step)):.6f})"
            )

            # --- validation with per-cloud prob EMA ---
            if has_validation:
                predictions, targets = [], []
                for batch in dataset.batches("validation", cfg, augment=False):
                    probs = class_probs(
                        predict(state, on_device(model_input(batch, flags.with_rgb))))
                    for b in range(probs.shape[0]):
                        c_i = int(batch["cloud_ind"][b])
                        inds = batch["point_inds"][b]
                        validation_probs[c_i][inds] = (
                            val_smooth * validation_probs[c_i][inds]
                            + (1 - val_smooth) * probs[b]
                        )
                        predictions.append(probs[b])
                        targets.append(dataset.input_labels["validation"][c_i][inds])
                miou = validation_eval(
                    dataset, validation_probs, val_proportions, predictions, targets,
                    num_classes
                )
                log(f"Eval point avg class IoU: {miou:.3f}")

                is_best = False
                if epoch % flags.snapshot_gap == 0:
                    log("---- VOTING EVALUATION ----")
                    vote_iou = vote_projection_eval(dataset, validation_probs, num_classes, log)
                    log(f"Eval voting avg class IoU: {vote_iou:.3f}")
                    if vote_iou >= best_vote_iou:
                        best_vote_iou = vote_iou
                        is_best = True
                        log(f"new best voting mIoU: {best_vote_iou:.3f}")
                ckpt_mgr.save(state, epoch, is_best=is_best)
            else:
                ckpt_mgr.save(state, epoch)
    finally:
        log.close()
    return best_vote_iou


if __name__ == "__main__":
    main()
