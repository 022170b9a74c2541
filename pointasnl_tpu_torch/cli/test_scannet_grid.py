"""ScanNet grid-sampled tester, the port's counterpart of
``pointasnl_tpu/cli/test_scannet_grid.py`` (a rebuild of
ScanNet/test_scannet_grid.py).

Protocol parity: reload the training args.txt to reconstruct the model
(test_scannet_grid.py:37-39), run potential-driven crops until every point's
potential exceeds `num_votes` (:271), EMA the per-cloud class probabilities
(0.95 val / 0.98 test, :101,234), then reproject the subcloud probs onto the
mesh vertices through the cached projection indices and report the voting
mIoU in percent (val) or dump NYU40-id txt submissions (test). It runs on
the card unless ``--device cpu``; ``--dp`` is not ported and raises.

    python -m pointasnl_tpu_torch.cli.test_scannet_grid --data <dir> --model_path <log_dir>
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import (
    add_device_arg,
    add_dp_arg,
    check_dp,
    class_probs,
    device,
    nl_kwargs,
    with_ignored_columns,
)
from pointasnl_tpu_torch.cli.train_scannet_grid import model_input, vote_projection_eval


def parse_args(argv=None):
    p = argparse.ArgumentParser("test_scannet_grid")
    p.add_argument("--data", default="data/Scannet")
    p.add_argument("--model_path", required=True, help="train log dir (args.txt + ckpts)")
    p.add_argument(
        "--ckpt", default="best",
        help="checkpoint to restore: best, latest, or an epoch number",
    )
    p.add_argument("--dump_dir", default="logs/scannet_grid_dump/")
    p.add_argument("--num_votes", type=float, default=10.0)
    p.add_argument("--split", default="validation", choices=["validation", "test"])
    p.add_argument("--batch_size", type=int, default=0, help="0 = train-time value")
    p.add_argument("--max_rounds", type=int, default=100, help="safety cap on vote rounds")
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first inference steps into <dump_dir>/profile "
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
    from pointasnl_tpu_torch.data.scannet_grid import ScannetGridDataset
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
    dump_dir = os.path.join(flags.dump_dir, datetime.now().strftime("%Y_%m_%d_%H_%M_%S"))
    os.makedirs(dump_dir, exist_ok=True)
    log = Logger(dump_dir, filename="log_test.txt")
    rs = np.random.RandomState(flags.seed)

    num_point = train_args["num_point"]
    with_rgb = train_args.get("with_rgb", True)
    feature_channel = 3 if with_rgb else 0
    num_classes = 21
    batch_size = flags.batch_size or train_args["batch_size"]
    load_test = flags.split == "test"

    dataset = ScannetGridDataset(
        flags.data,
        npoint=num_point,
        buffer=train_args.get("num_buffer", 1024),
        load_test=load_test,
        random_state=rs,
    )
    dataset.load_subsampled_clouds(train_args.get("first_subsampling_dl", 0.04))

    cfg = GridConfig(
        batch_size=batch_size,
        validation_size=max(
            sum(t.data.shape[0] for t in dataset.input_trees[flags.split])
            // max(num_point * batch_size, 1),
            1,
        ),
        in_radius=train_args.get("in_radius", 0),
        input_threads=train_args.get("input_threads", 8),
    )

    model = get_model_class(train_args["model"])(
        num_class=num_classes, feature_channel=feature_channel, **nl_kwargs(train_args),
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    state = create_train_state(model, optimizer="adam",
                               lr_schedule=staircase_lr_schedule(1e-3, batch_size, 2e5, 0.7))
    state = restore_checkpoint(state, flags.model_path, flags.ckpt)
    predict = make_predict_step()
    log("Model restored.")

    test_smooth = 0.98 if load_test else 0.95
    cloud_probs = [
        np.zeros((t.data.shape[0], num_classes - 1)) for t in dataset.input_trees[flags.split]
    ]

    def logits_of(batch) -> torch.Tensor:
        return predict(state, torch.from_numpy(model_input(batch, with_rgb)).to(dev))

    tracer = StepTraceWindow(os.path.join(dump_dir, "profile"), enabled=flags.profile, log=log)
    round_idx = 0
    try:
        while round_idx < flags.max_rounds:
            for batch in dataset.batches(flags.split, cfg, augment=False):
                # class_probs' copy to the host waits for the card
                probs = tracer.traced(lambda: class_probs(logits_of(batch)))
                for b in range(probs.shape[0]):
                    c_i = int(batch["cloud_ind"][b])
                    inds = batch["point_inds"][b]
                    cloud_probs[c_i][inds] = (
                        test_smooth * cloud_probs[c_i][inds] + (1 - test_smooth) * probs[b]
                    )
            min_pot = float(np.min(dataset.min_potentials[flags.split]))
            log(f"round {round_idx}: min potential {min_pot:.2f}")
            round_idx += 1
            if min_pot > flags.num_votes:
                break
    finally:
        tracer.close()  # fewer steps than the window, or an exception

    try:
        if flags.split == "validation":
            miou = vote_projection_eval(dataset, cloud_probs, num_classes, log)
            log(f"Final voting mIoU: {miou:.3f}")
            return miou

        # test split: reproject and dump NYU40-id txt submissions
        label_values = dataset.label_values
        ignored = set(dataset.ignored_labels.tolist())
        for i_test, file_path in enumerate(dataset.test_files):
            sub_probs = with_ignored_columns(cloud_probs[i_test], label_values, ignored)
            sub_preds = label_values[np.argmax(sub_probs, axis=1).astype(np.int32)]
            preds = sub_preds[dataset.test_proj[i_test]].astype(np.int32)
            cloud_name = file_path.split("/")[-1][:-4]
            with open(os.path.join(dump_dir, cloud_name + ".txt"), "w") as f:
                for v in preds:
                    f.write(f"{int(v)}\n")
            log(f"dumped {cloud_name} ({len(preds)} vertices)")
        log("Done!")
        return None
    finally:
        log.close()


if __name__ == "__main__":
    main()
