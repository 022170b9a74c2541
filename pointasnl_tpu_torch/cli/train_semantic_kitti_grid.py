"""SemanticKITTI grid-sampled trainer, the port's counterpart of
``pointasnl_tpu/cli/train_semantic_kitti_grid.py`` (a rebuild of
SemanticKITTI/train_semantic_kitti_grid.py, the ~52-mIoU recipe:
--num_point 10240 --model pointasnl_sem_seg_res --first_subsampling_dl 0.06).

Same recipe and flags: per-scan KNN crops, per-crop augmentation, weighted
CE + repulsion, the batches through a Prefetcher of 8, per-epoch
confusion-matrix mIoU (percent) over the validation crops
(train_semantic_kitti_grid.py:265-330; counted with numpy,
``seg_common.label_confusion``), args.txt JSON dump for the tester.
`--prepare_data` runs the offline grid-subsample + projection cache pass.
It runs on the card unless ``--device cpu``; ``--dp`` is not ported and
raises.

    python -m pointasnl_tpu_torch.cli.train_semantic_kitti_grid --data <sequences> \\
        --log_dir <dir> --prepare_data
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
    with_ignored_columns,
)
from pointasnl_tpu_torch.data.semantic_kitti_config import KITTI_LABEL_TO_CAT


def parse_args(argv=None):
    p = argparse.ArgumentParser("train_semantic_kitti_grid")
    p.add_argument("--data", default="data/semantic_kitti/dataset/sequences")
    p.add_argument("--model", default="pointasnl_sem_seg_res")
    p.add_argument("--log_dir", default="logs/kitti_grid")
    p.add_argument("--pretrain_dir", default=None)
    p.add_argument("--num_point", type=int, default=10240)
    p.add_argument("--num_buffer", type=int, default=1024)
    p.add_argument("--in_radius", type=float, default=0)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--from_epoch", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
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
    p.add_argument("--input_threads", type=int, default=8)
    p.add_argument("--first_subsampling_dl", type=float, default=0.06)
    p.add_argument("--prepare_data", action="store_true")
    p.add_argument("--steps_per_epoch", type=int, default=0, help="0 = full dataset")
    p.add_argument("--eval_steps", type=int, default=0, help="0 = full validation")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first train steps of the starting epoch into "
        "<log_dir>/profile (a Chrome trace: Perfetto, chrome://tracing)",
    )
    return p.parse_args(argv)


def crop_confusion_miou(dataset, predictions, targets, num_classes, log=None):
    """Confusion-matrix mIoU (percent) over crops
    (train_semantic_kitti_grid.py:300-330)."""
    from pointasnl_tpu_torch.train.metrics import IoU_from_confusions

    label_values = dataset.label_values
    ignored = set(dataset.ignored_labels.tolist())
    confs = np.zeros((len(predictions), num_classes, num_classes), np.int32)
    for i, (probs, truth) in enumerate(zip(predictions, targets)):
        probs = with_ignored_columns(probs, label_values, ignored)
        preds = label_values[np.argmax(probs, axis=1)]
        confs[i] = label_confusion(truth, preds, label_values)
    C = drop_ignored(np.sum(confs, axis=0).astype(np.float32), label_values, ignored)
    IoUs = IoU_from_confusions(C)
    if log is not None:
        for l in range(1, num_classes):
            log(f"  class {KITTI_LABEL_TO_CAT[l]:<16s} IoU: {100 * IoUs[l - 1]:.3f}")
    return 100 * float(np.mean(IoUs))


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data.grid_pipeline import GridConfig, Prefetcher
    from pointasnl_tpu_torch.data.semantic_kitti_grid import SemanticKittiGridDataset
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
    num_classes = 20

    dataset = SemanticKittiGridDataset(
        flags.data,
        num_point=flags.num_point,
        grid_size=flags.first_subsampling_dl,
        num_buffer=flags.num_buffer,
        in_radius=flags.in_radius,
        prepare_data=flags.prepare_data,
        random_state=rs,
    )

    cfg = GridConfig(
        batch_size=flags.batch_size,
        in_radius=flags.in_radius,
        input_threads=flags.input_threads,
    )

    model = get_model_class(flags.model)(
        num_class=num_classes, feature_channel=0, **nl_kwargs(flags),
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

    ckpt_mgr = CheckpointManager(
        flags.log_dir,
        max_to_keep=flags.max_to_keep if flags.max_to_keep > 0 else None,
    )
    best_iou = 0.0
    max_steps = 2 if flags.debug else (flags.steps_per_epoch or 10**9)
    max_eval = 2 if flags.debug else (flags.eval_steps or 10**9)
    max_epoch = 2 if flags.debug else flags.max_epoch
    try:
        for epoch in range(flags.from_epoch, max_epoch):
            log(f"**** EPOCH {epoch:03d} ****")
            t0 = time.time()
            loss_sum = torch.zeros((), device=dev)
            nsteps = 0
            tracer = StepTraceWindow(
                os.path.join(flags.log_dir, "profile"),
                enabled=flags.profile and epoch == flags.from_epoch, log=log,
            )
            try:
                with Prefetcher(dataset.batches("training", cfg), capacity=8) as batches:
                    for batch in batches:
                        feed = {"points": on_device(batch["points"]),
                                "labels": on_device(batch["labels"]),
                                "smpw": on_device(batch["label_weights"])}
                        metrics = tracer.traced(lambda: train_step(state, feed, dropout_rng))
                        loss_sum = loss_sum + metrics["loss"]  # on the device: no sync a step
                        nsteps += 1
                        if nsteps >= max_steps:
                            break
            finally:
                tracer.close()
            log(
                f"train loss {float(loss_sum) / max(nsteps, 1):.4f} "
                f"({time.time() - t0:.1f}s, lr {float(lr_sched(state.step)):.6f})"
            )

            # --- validation ---
            predictions, targets = [], []
            esteps = 0
            for batch in dataset.batches("validation", cfg, augment=False):
                probs = class_probs(predict(state, on_device(batch["points"])))
                for b in range(probs.shape[0]):
                    predictions.append(probs[b])
                    targets.append(batch["labels"][b])
                esteps += 1
                if esteps >= max_eval:
                    break
            miou = crop_confusion_miou(dataset, predictions, targets, num_classes, log)
            log(f"Eval point avg class IoU: {miou:.3f}")

            is_best = miou >= best_iou
            if is_best:
                best_iou = miou
                log(f"new best mIoU: {best_iou:.3f}")
            ckpt_mgr.save(state, epoch, is_best=is_best)
    finally:
        log.close()
    return best_iou


if __name__ == "__main__":
    main()
