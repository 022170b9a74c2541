"""SemanticKITTI grid-sampled tester, the port's counterpart of
``pointasnl_tpu/cli/test_semantic_kitti_grid.py`` (a rebuild of
SemanticKITTI/test_semantic_kitti_grid.py).

Protocol parity: reload args.txt (test_semantic_kitti_grid.py:44-46),
possibility-driven crops until every point's possibility exceeds num_votes,
per-cloud prob EMA (0.98), reproject to the raw scan through the cached
projection indices, remap through learning_map_inv, and write uint32 .label
files for the official semantic-kitti-api evaluator (:120-180). It runs on
the card unless ``--device cpu``; ``--dp`` is not ported and raises.

    python -m pointasnl_tpu_torch.cli.test_semantic_kitti_grid --data <sequences> \\
        --model_path <log_dir> --test_id 8
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    add_device_arg,
    add_dp_arg,
    check_dp,
    class_probs,
    device,
    nl_kwargs,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser("test_semantic_kitti_grid")
    p.add_argument("--data", default="data/semantic_kitti/dataset/sequences")
    p.add_argument("--model_path", required=True, help="train log dir (args.txt + ckpts)")
    p.add_argument(
        "--ckpt", default="best",
        help="checkpoint to restore: best, latest, or an epoch number",
    )
    p.add_argument("--save_dir", default="logs/kitti_grid_pred/")
    p.add_argument("--test_id", type=int, default=14, help="sequence to test (8=valid)")
    p.add_argument("--num_votes", type=float, default=4.0)
    p.add_argument("--batch_size", type=int, default=0, help="0 = train-time value")
    p.add_argument("--max_rounds", type=int, default=100)
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first inference steps into <save_dir>/profile "
        "(the reference's TimeLiner role, test_scannet_grid.py:53-75)",
    )
    p.add_argument("--seed", type=int, default=0)
    add_dp_arg(p)
    add_device_arg(p)
    return p.parse_args(argv)


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)

    from pointasnl_tpu_torch.data.grid_pipeline import GridConfig
    from pointasnl_tpu_torch.data.semantic_kitti_config import LEARNING_MAP_INV
    from pointasnl_tpu_torch.data.semantic_kitti_grid import SemanticKittiGridDataset
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        create_train_state,
        make_predict_step,
        restore_checkpoint,
        staircase_lr_schedule,
    )
    from pointasnl_tpu_torch.train.profiling import StepTraceWindow
    from pointasnl_tpu_torch.utils import Logger, load_args

    train_args = load_args(flags.model_path)
    os.makedirs(flags.save_dir, exist_ok=True)
    log = Logger(flags.save_dir, filename="log_test.txt")
    rs = np.random.RandomState(flags.seed)

    num_point = train_args["num_point"]
    num_classes = 20
    batch_size = flags.batch_size or train_args["batch_size"]

    dataset = SemanticKittiGridDataset(
        flags.data,
        num_point=num_point,
        grid_size=train_args.get("first_subsampling_dl", 0.06),
        num_buffer=train_args.get("num_buffer", 1024),
        in_radius=train_args.get("in_radius", 0),
        test_id=flags.test_id,
        random_state=rs,
    )
    if len(dataset.test_list) == 0:
        raise RuntimeError(f"no scans for test sequence {flags.test_id}")

    cfg = GridConfig(
        batch_size=batch_size,
        in_radius=train_args.get("in_radius", 0),
        input_threads=train_args.get("input_threads", 8),
    )

    model = get_model_class(train_args["model"])(
        num_class=num_classes, feature_channel=0, **nl_kwargs(train_args),
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    state = create_train_state(model, optimizer="adam",
                               lr_schedule=staircase_lr_schedule(1e-3, batch_size, 2e5, 0.7))
    state = restore_checkpoint(state, flags.model_path, flags.ckpt)
    predict = make_predict_step()
    log("Model restored.")

    dataset.reset_possibility()
    cloud_probs = [
        np.zeros((dataset.get_data(f)[0].shape[0], num_classes - 1))
        for f in dataset.test_list
    ]

    tracer = StepTraceWindow(
        os.path.join(flags.save_dir, "profile"), enabled=flags.profile, log=log
    )
    smooth = 0.98
    round_idx = 0
    try:
        while round_idx < flags.max_rounds:
            for batch in dataset.batches("test", cfg, augment=False):
                points = torch.from_numpy(batch["points"]).to(dev)
                # class_probs' copy to the host waits for the card
                probs = tracer.traced(lambda: class_probs(predict(state, points)))
                for b in range(probs.shape[0]):
                    c_i = int(batch["cloud_ind"][b])
                    inds = batch["point_inds"][b]
                    cloud_probs[c_i][inds] = (
                        smooth * cloud_probs[c_i][inds] + (1 - smooth) * probs[b]
                    )
            min_pos = float(np.min(dataset.min_possibility))
            log(f"round {round_idx}: min possibility {min_pos:.2f}")
            round_idx += 1
            if min_pos > flags.num_votes:
                break
    finally:
        tracer.close()  # fewer steps than the window, or an exception

    inv_lut = np.zeros(num_classes, np.uint32)
    for k, v in LEARNING_MAP_INV.items():
        inv_lut[k] = v

    try:
        for i_scan, file_path in enumerate(dataset.test_list):
            # classes 1..19 probs -> training id (argmax+1) -> raw label id
            sub_preds = (np.argmax(cloud_probs[i_scan], axis=1) + 1).astype(np.int32)
            proj_inds = dataset.get_proj_inds(file_path)
            preds = sub_preds[proj_inds]
            raw = inv_lut[preds]
            seq_id = file_path.split(os.sep)[-3]
            frame_id = file_path.split(os.sep)[-1][:-4]
            out_dir = os.path.join(flags.save_dir, "sequences", seq_id, "predictions")
            os.makedirs(out_dir, exist_ok=True)
            raw.astype(np.uint32).tofile(os.path.join(out_dir, frame_id + ".label"))
            log(f"wrote {seq_id}/{frame_id}.label ({len(raw)} points)")
        log("Done!")
    finally:
        log.close()


if __name__ == "__main__":
    main()
