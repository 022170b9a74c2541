"""SemanticKITTI sliding-window inference, the port's counterpart of
``pointasnl_tpu/cli/test_semantic_kitti.py`` (a rebuild of
SemanticKITTI/test_semantic_kitti.py).

Protocol parity: per scan, `num_votes` sliding-window passes (a short last
batch of blocks is filled with zero rows), per-block argmax over classes 1:
(+1), vote pooling into original point ids, a uint32 `.label` dump of every
raw point under sequences/{seq}/predictions (test_semantic_kitti.py:135-180).
`--remap_inv` maps training ids through learning_map_inv to raw label ids,
what the official semantic-kitti-api evaluator expects.

`--single_pass` feeds the whole scan through the model at once, per vote
(dup-padded to a multiple of `--pad_quantum`, in a fresh order each vote);
pair it with `--nl_block_size` for scan-scale attention memory.

The model's flags (`--model`, `--num_classes`, `--with_remission`,
`--nl_block_size`, `--nl_flash`) default to the training run's, read from
``<model_path>/args.txt`` where the trainer wrote one, and to the JAX
tester's defaults where it did not; a flag given on the command line wins.
It runs on the card unless ``--device cpu``; the batch-sharded ``--dp`` and
the point-sharded ``--sharded`` are not ported and raise.

    python -m pointasnl_tpu_torch.cli.test_semantic_kitti --data <dataset> --model_path <log_dir>
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    SegEvalAccumulator,
    add_device_arg,
    add_vote,
    check_dp,
    device,
    nl_kwargs,
    str2bool,
)
from pointasnl_tpu_torch.data import provider

# Single-pass scans are padded to a multiple of this (the levels' N / 256).
PAD_DIVISOR = 256
# The model's flags: the JAX tester's default where the training run left
# no args.txt.
MODEL_DEFAULTS = {"model": "pointasnl_sem_seg", "num_classes": 20, "with_remission": False,
                  "nl_block_size": 0, "nl_flash": False}


def parse_args(argv=None):
    p = argparse.ArgumentParser("test_semantic_kitti")
    p.add_argument("--data", default="data/kitti/dataset/")
    p.add_argument("--model", default=None)
    p.add_argument("--model_path", required=True, help="checkpoint dir")
    p.add_argument(
        "--ckpt", default="best",
        help="checkpoint to restore: best, latest, or an epoch number",
    )
    p.add_argument("--dump_dir", default="logs/kitti_dump/")
    p.add_argument("--save_dir", default="logs/kitti_pred/")
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--num_votes", type=int, default=1)
    p.add_argument("--with_remission", action="store_true", default=None)
    p.add_argument("--random_rotate", action="store_true")
    p.add_argument("--config_file", default=None)
    p.add_argument("--dataset", default="valid", choices=["valid", "test"])
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--remap_inv", action="store_true", help="write raw label ids")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_scans", type=int, default=0, help="0 = all")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first inference calls into <dump_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    p.add_argument(
        "--nl_block_size", type=int, default=None,
        help="chunk the non-local K/V axis with an online softmax "
        "(0 = dense attention map; >0 enables whole-scene-scale memory)",
    )
    p.add_argument(
        "--nl_flash", type=str2bool, default=None,
        help="use the flash-attention kernels in the non-local cells",
    )
    add_device_arg(p)
    p.add_argument(
        "--single_pass", action="store_true",
        help="whole-scan single-pass inference: the ENTIRE LiDAR scan goes "
        "through the model at once instead of the reference's strided block "
        "chopping. Pair with --nl_block_size for scan-scale attention memory.",
    )
    p.add_argument(
        "--pad_quantum", type=int, default=8192,
        help="single-pass scans are dup-padded up to a multiple of this "
        "(must be divisible by 256)",
    )
    p.add_argument(
        "--dp", action="store_true",
        help="batch-shard the sliding-window forwards over the local cards: "
        "not ported yet (raises)",
    )
    p.add_argument(
        "--sharded", action="store_true",
        help="single-pass inference with the POINT axis sharded over the "
        "local cards: not ported yet (raises)",
    )
    return p.parse_args(argv)


def model_flags(flags) -> None:
    """Fill the model's flags left unset from the training run's args.txt,
    else from MODEL_DEFAULTS."""
    from pointasnl_tpu_torch.utils import load_args

    trained = (load_args(flags.model_path)
               if os.path.isfile(os.path.join(flags.model_path, "args.txt")) else {})
    for key, default in MODEL_DEFAULTS.items():
        if getattr(flags, key) is None:
            setattr(flags, key, trained.get(key, default))


def main(argv=None):
    flags = parse_args(argv)
    if flags.sharded:
        raise NotImplementedError("--sharded: point-sharded whole-scan inference is not ported "
                                  "yet (ROADMAP.md, Open items §1 item 7)")
    check_dp(flags)
    dev = device(flags)
    model_flags(flags)

    from pointasnl_tpu_torch.data.semantic_kitti import SemanticKittiDatasetSlidingWindow
    from pointasnl_tpu_torch.data.semantic_kitti_config import LEARNING_MAP_INV
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        create_train_state,
        make_predict_step,
        restore_checkpoint,
        staircase_lr_schedule,
    )
    from pointasnl_tpu_torch.train.profiling import StepTraceWindow
    from pointasnl_tpu_torch.utils import Logger

    os.makedirs(flags.dump_dir, exist_ok=True)
    log = Logger(flags.dump_dir, filename="log_evaluate.txt")
    rs = np.random.RandomState(flags.seed)
    feature_channel = 1 if flags.with_remission else 0

    dataset = SemanticKittiDatasetSlidingWindow(
        flags.data,
        sample_points=flags.num_point,
        split=flags.dataset,
        with_remission=flags.with_remission,
        config_file=flags.config_file,
        random_state=rs,
    )

    model = get_model_class(flags.model)(
        num_class=flags.num_classes, feature_channel=feature_channel, **nl_kwargs(flags),
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    state = create_train_state(model, optimizer="adam",
                               lr_schedule=staircase_lr_schedule(1e-3, flags.batch_size, 2e5, 0.7))
    state = restore_checkpoint(state, flags.model_path, flags.ckpt)
    predict = make_predict_step()
    log("Model restored.")

    inv_lut = np.zeros(flags.num_classes, np.uint32)
    for k, v in LEARNING_MAP_INV.items():
        inv_lut[k] = v

    def logits_of(points: np.ndarray) -> np.ndarray:
        return predict(state, torch.from_numpy(points).to(dev)).cpu().numpy()

    tracer = StepTraceWindow(os.path.join(flags.dump_dir, "profile"), enabled=flags.profile,
                             log=log)
    total = SegEvalAccumulator(flags.num_classes)
    n_scans = len(dataset) if flags.max_scans == 0 else min(flags.max_scans, len(dataset))
    try:
        for scan_idx in range(n_scans):
            components = dataset.points_name[scan_idx].split(os.sep)
            sequence = components[-3]
            label_name = components[-1].replace("bin", "label")
            save_dir = os.path.join(flags.save_dir, "sequences", sequence, "predictions")
            os.makedirs(save_dir, exist_ok=True)
            if flags.single_pass:
                vote_label_pool, whole_scene_label = _single_pass(
                    flags, dataset, scan_idx, rs, feature_channel, tracer, logits_of)
            else:
                vote_label_pool, whole_scene_label = _sliding_windows(
                    flags, dataset, scan_idx, rs, feature_channel, tracer, logits_of)

            final_preds = np.argmax(vote_label_pool, axis=1).astype(np.uint32)
            out = inv_lut[final_preds] if flags.remap_inv else final_preds
            out.astype(np.uint32).tofile(os.path.join(save_dir, label_name))

            if flags.dataset != "test" and whole_scene_label is not None:
                scan_acc = SegEvalAccumulator(flags.num_classes)
                scan_acc.update(final_preds, whole_scene_label)
                total.update(final_preds, whole_scene_label)
                log(
                    f"[{scan_idx + 1}/{n_scans}] {sequence}-{label_name.split('.')[0]} "
                    f"mIoU {scan_acc.miou():.4f}"
                )
        if flags.dataset != "test":
            log(f"eval point avg class IoU: {total.miou():.6f}")
            log(f"eval point accuracy: {total.accuracy():.6f}")
        else:
            log("Done!")
    finally:
        # Fewer calls than the window's steps, or an exception between two
        # calls, must still end the trace.
        tracer.close()
        log.close()
    return total.miou() if flags.dataset != "test" else None


def _single_pass(flags, dataset, scan_idx, rs, feature_channel, tracer, logits_of):
    """The whole scan through the model at once, per vote: a fresh point
    order each vote re-seeds FPS (the voting randomness), and dup-padding to
    a quantum bounds the shapes across scan sizes. Returns (vote pool,
    labels or None)."""
    pts_full, label = dataset.whole_scan(scan_idx)
    n = pts_full.shape[0]
    vote_label_pool = np.zeros((n, flags.num_classes))
    quantum = max(PAD_DIVISOR, flags.pad_quantum - flags.pad_quantum % PAD_DIVISOR)
    for _ in range(flags.num_votes):
        pidx = np.arange(n)
        pts = pts_full
        n_pad = (-n) % quantum
        if n_pad:
            dup = rs.choice(n, n_pad)
            pts = np.concatenate([pts, pts[dup]], axis=0)
            pidx = np.concatenate([pidx, dup], axis=0)
        order = rs.permutation(pts.shape[0])
        pts, pidx = pts[order].copy(), pidx[order]
        if flags.random_rotate:
            pts[:, :3] = provider.rotate_point_cloud_z(pts[None, :, :3], random_state=rs)[0]
        scene_in = np.ascontiguousarray(pts[None, :, : 3 + feature_channel], dtype=np.float32)
        logits = tracer.traced(lambda: logits_of(scene_in))[0]
        pred_label = np.argmax(logits[:, 1:], 1) + 1
        vote_label_pool = add_vote(vote_label_pool, pidx[None], pred_label[None],
                                   np.ones((1, len(pidx))))
    return vote_label_pool, label


def _sliding_windows(flags, dataset, scan_idx, rs, feature_channel, tracer, logits_of):
    """`num_votes` passes of the sliding-window blocks, `batch_size` blocks a
    forward, the last batch's unused rows zeros. Returns (vote pool, labels
    or None)."""
    vote_label_pool, label = None, None
    for _ in range(flags.num_votes):
        item = dataset[scan_idx]
        if flags.dataset == "test":
            scene_data, scene_point_index, whole_scene_data = item
        else:
            scene_data, scene_point_index, whole_scene_data, label = item
        if vote_label_pool is None:
            vote_label_pool = np.zeros((whole_scene_data.shape[0], flags.num_classes))
        num_blocks = scene_data.shape[0]
        for start in range(0, num_blocks, flags.batch_size):
            real = min(flags.batch_size, num_blocks - start)
            batch_data = np.zeros((flags.batch_size, flags.num_point, 3 + feature_channel),
                                  np.float32)
            batch_index = np.zeros((flags.batch_size, flags.num_point))
            batch_data[:real] = scene_data[start:start + real]
            batch_index[:real] = scene_point_index[start:start + real]
            if flags.random_rotate:
                batch_data[:, :, :3] = provider.rotate_point_cloud_z(batch_data[:, :, :3],
                                                                     random_state=rs)
            logits = tracer.traced(lambda: logits_of(batch_data))
            pred_label = np.argmax(logits[:, :, 1:], 2) + 1
            vote_label_pool = add_vote(vote_label_pool, batch_index[:real], pred_label[:real],
                                       np.ones_like(batch_index[:real]))
    return vote_label_pool, label


if __name__ == "__main__":
    main()
