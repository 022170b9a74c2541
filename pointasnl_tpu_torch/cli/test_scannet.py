"""ScanNet whole-scene evaluation with sliding-window vote pooling, the port's
counterpart of ``pointasnl_tpu/cli/test_scannet.py`` (a rebuild of
ScanNet/test_scannet.py).

Protocol parity: per scene, `num_votes` passes of the sliding-window dataset
(each pass re-randomises the block split), per-block argmax over classes 1:
(+1), weighted vote accumulation into the original point ids
(test_scannet.py:96-163), a per-scene txt dump of 21->NYU40 ids
(:179-186), and val-split mIoU over classes 1..20. ``--single_pass`` feeds
each whole scene through the model at once (pair it with
``--nl_block_size``). It runs on one card unless ``--device cpu``; the
point-sharded ``--sharded`` and the batch-sharded ``--dp`` are not ported
and raise.

    python -m pointasnl_tpu_torch.cli.test_scannet --data <dir> --model_path <log_dir>
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    SegEvalAccumulator,
    add_device_arg,
    add_nl_args,
    add_vote,
    check_dp,
    device,
    nl_kwargs,
    str2bool,
)

# 21-class training ids -> NYU40 ids (prepare_scannet.py:13)
TEST_CLASS = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
# Single-pass scenes are padded to a multiple of this (the levels' N / 256).
PAD_DIVISOR = 256


def parse_args(argv=None):
    p = argparse.ArgumentParser("test_scannet")
    p.add_argument("--data", default="data/ScanNet/")
    p.add_argument("--model", default="pointasnl_sem_seg")
    p.add_argument("--batch_size", type=int, default=6)
    p.add_argument("--num_point", type=int, default=8192)
    p.add_argument("--model_path", required=True, help="checkpoint dir (containing best/latest)")
    p.add_argument(
        "--ckpt", default="best",
        help="checkpoint to restore: best, latest, or an epoch number",
    )
    p.add_argument("--dump_dir", default="logs/dump/")
    p.add_argument("--num_votes", type=int, default=10)
    p.add_argument("--with_rgb", type=str2bool, default=True)
    p.add_argument("--dataset", default="val", choices=["val", "test"])
    p.add_argument("--num_classes", type=int, default=21)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_scenes", type=int, default=0, help="0 = all (debug aid)")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first inference calls into <dump_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    add_nl_args(p)
    add_device_arg(p)
    p.add_argument(
        "--single_pass", type=str2bool, default=False,
        help="whole-scene single-pass inference: the ENTIRE scene goes "
        "through the model at once (memory-bounded attention/kNN) instead of "
        "the reference's sliding-window chopping. Pair with --nl_block_size.",
    )
    p.add_argument(
        "--pad_quantum", type=int, default=8192,
        help="single-pass scenes are dup-padded up to a multiple of this "
        "(must be divisible by 256)",
    )
    p.add_argument(
        "--sharded", type=str2bool, default=False,
        help="single-pass inference with the POINT axis sharded over the "
        "local cards: not ported yet (raises)",
    )
    p.add_argument(
        "--dp", action="store_true",
        help="batch-shard the sliding-window forwards over the local cards: "
        "not ported yet (raises)",
    )
    return p.parse_args(argv)


def main(argv=None):
    flags = parse_args(argv)
    if flags.sharded:
        raise NotImplementedError("--sharded: point-sharded whole-scene inference is not ported "
                                  "yet (ROADMAP.md, Open items §1 item 7)")
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data.scannet import ScannetDatasetWholeSceneSlidingWindow
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        create_train_state,
        make_predict_step,
        restore_checkpoint,
        staircase_lr_schedule,
    )
    from pointasnl_tpu_torch.train.profiling import StepTraceWindow
    from pointasnl_tpu_torch.utils import Logger

    dump_dir = os.path.join(flags.dump_dir, datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(dump_dir, exist_ok=True)
    log = Logger(dump_dir, filename="log_evaluate.txt")
    rs = np.random.RandomState(flags.seed)
    feature_channel = 3 if flags.with_rgb else 0

    dataset = ScannetDatasetWholeSceneSlidingWindow(
        flags.data,
        split=flags.dataset,
        block_points=flags.num_point,
        with_rgb=flags.with_rgb,
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

    scene_list_path = os.path.join(flags.data, f"scannetv2_{flags.dataset}.txt")
    if os.path.exists(scene_list_path):
        with open(scene_list_path) as fl:
            scene_ids = fl.read().splitlines()
    else:
        scene_ids = [f"scene{i:04d}" for i in range(len(dataset))]

    def logits_of(points: np.ndarray) -> np.ndarray:
        return predict(state, torch.from_numpy(points).to(dev)).cpu().numpy()

    tracer = StepTraceWindow(os.path.join(dump_dir, "profile"), enabled=flags.profile, log=log)
    total = SegEvalAccumulator(flags.num_classes)
    n_scenes = len(dataset) if flags.max_scenes == 0 else min(flags.max_scenes, len(dataset))
    try:
        _scene_loop(flags, dataset, scene_ids, n_scenes, tracer, total, dump_dir, rs,
                    feature_channel, logits_of, log)
        if flags.dataset == "val":
            iou = total.per_class_iou()[1:]
            log(f"eval point avg class IoU: {float(np.mean(iou)):.6f}")
            for i, v in enumerate(iou):
                log(f"Class {i + 1} : {v:.4f}")
        log("Done!")
    finally:
        # Fewer calls than the window's steps, or an exception between two
        # calls, must still end the trace.
        tracer.close()
        log.close()
    return total.miou() if flags.dataset == "val" else None


def _scene_loop(flags, dataset, scene_ids, n_scenes, tracer, total, dump_dir, rs,
                feature_channel, logits_of, log):
    for scene_idx in range(n_scenes):
        whole_scene_points_index = dataset.scene_points_id[scene_idx]
        whole_scene_points_num = dataset.scene_points_num[scene_idx]
        whole_scene_label = dataset.semantic_labels_list[scene_idx]
        vote_label_pool = np.zeros((whole_scene_label.shape[0], flags.num_classes))

        if flags.single_pass:
            # Whole scene through the model at once, per vote (fresh noise and
            # point order each vote: the order changes the FPS seeds, which is
            # the voting randomness, as in the reference protocol).
            quantum = max(PAD_DIVISOR, flags.pad_quantum - flags.pad_quantum % PAD_DIVISOR)
            for _ in range(flags.num_votes):
                pts, seg, smpw, pidx = dataset.whole_scene(scene_idx)
                n = pts.shape[0]
                n_pad = (-n) % quantum
                if n_pad:
                    dup = rs.choice(n, n_pad)
                    pts = np.concatenate([pts, pts[dup]], axis=0)
                    smpw = np.concatenate([smpw, smpw[dup]], axis=0)
                    pidx = np.concatenate([pidx, pidx[dup]], axis=0)
                order = rs.permutation(pts.shape[0])
                pts, smpw, pidx = pts[order], smpw[order], pidx[order]
                scene_in = np.ascontiguousarray(pts[None, :, : 3 + feature_channel],
                                                dtype=np.float32)
                logits = tracer.traced(lambda: logits_of(scene_in))[0]
                pred_label = np.argmax(logits[:, 1:], 1) + 1
                vote_label_pool = add_vote(
                    vote_label_pool, pidx[None], pred_label[None], smpw[None]
                )
            num_votes_done = flags.num_votes
        else:
            num_votes_done = 0
        for _ in range(flags.num_votes - num_votes_done):
            scene_data, scene_label, scene_smpw, scene_point_index = dataset[scene_idx]
            num_blocks = scene_data.shape[0]
            s_batch_num = (num_blocks + flags.batch_size - 1) // flags.batch_size
            for sbatch in range(s_batch_num):
                start = sbatch * flags.batch_size
                end = min((sbatch + 1) * flags.batch_size, num_blocks)
                real = end - start
                batch_data = np.zeros(
                    (flags.batch_size, flags.num_point, 3 + feature_channel), np.float32
                )
                batch_index = np.zeros((flags.batch_size, flags.num_point))
                batch_smpw = np.zeros((flags.batch_size, flags.num_point))
                batch_data[:real] = scene_data[start:end, :, : 3 + feature_channel]
                batch_index[:real] = scene_point_index[start:end]
                batch_smpw[:real] = scene_smpw[start:end]

                logits = tracer.traced(lambda: logits_of(batch_data))
                # argmax over classes 1: then +1 (never predict unannotated)
                pred_label = np.argmax(logits[:, :, 1:], 2) + 1
                vote_label_pool = add_vote(
                    vote_label_pool,
                    batch_index[:real],
                    pred_label[:real],
                    batch_smpw[:real],
                )

        pred_label = np.argmax(vote_label_pool, 1)
        scene_acc = SegEvalAccumulator(flags.num_classes)
        scene_acc.update(pred_label, whole_scene_label)
        total.update(pred_label, whole_scene_label)
        sid = scene_ids[scene_idx] if scene_idx < len(scene_ids) else f"scene{scene_idx}"
        log(f"[{scene_idx + 1}/{n_scenes}] {sid} mIoU {scene_acc.miou():.4f}")

        # dump NYU40-id predictions on the original vertex ordering
        whole_scene_data = np.zeros(whole_scene_points_num)
        whole_scene_data[whole_scene_points_index] = TEST_CLASS[pred_label.astype(np.int32)]
        with open(os.path.join(dump_dir, sid + ".txt"), "w") as f:
            for v in whole_scene_data:
                f.write(f"{int(v)}\n")


if __name__ == "__main__":
    main()
