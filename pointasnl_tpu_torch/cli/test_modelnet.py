"""ModelNet40 voting evaluation, the port's counterpart of
``pointasnl_tpu/cli/test_modelnet.py`` (a rebuild of test.py).

Same protocol (test.py:105-174): logit-sum voting over `num_votes` forward
passes, each on its own shuffle of the point order (which re-seeds FPS; the
reference computes the shuffle and never applies it, test.py:140-146), the
optional noisy-point sweep (1/10/50/100 injected random points,
:34,94-103, returned as {noise points: accuracy}), the per-class accuracy
table. It runs on the card unless ``--device cpu``; ``--dp`` is not ported
and raises.

    python -m pointasnl_tpu_torch.cli.test_modelnet --data <modelnet40_normal_resampled> \\
        --log_dir <train log dir> --AS --normal [--noise]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from pointasnl_tpu_torch.cli.seg_common import add_device_arg, add_dp_arg, check_dp, device

NOISE_POINTS = [1, 10, 50, 100]


def parse_args(argv=None):
    p = argparse.ArgumentParser("test_modelnet")
    p.add_argument("--data", default="data/modelnet40_normal_resampled")
    p.add_argument("--log_dir", default="logs/modelnet_cls", help="checkpoint dir")
    p.add_argument(
        "--ckpt", default="best",
        help="checkpoint to restore: best, latest, or an epoch number",
    )
    p.add_argument("--model", default="pointasnl_cls")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--num_point", type=int, default=1024)
    p.add_argument("--num_votes", type=int, default=5)
    p.add_argument("--AS", action="store_true")
    p.add_argument("--normal", action="store_true")
    p.add_argument("--noise", action="store_true", help="noisy-point robustness sweep")
    p.add_argument("--num_classes", type=int, default=40)
    p.add_argument(
        "--precision", default="float32", choices=["float32", "bfloat16"],
        help="compute dtype of the dense layers (nn/precision.py)",
    )
    p.add_argument("--seed", type=int, default=0)
    add_dp_arg(p)
    add_device_arg(p)
    p.add_argument(
        "--profile", action="store_true",
        help="trace the first voting forwards into <log_dir>/profile "
        "(a Chrome trace: Perfetto, chrome://tracing)",
    )
    return p.parse_args(argv)


def evaluate_once(state, predict, dataset, flags, rs, place, num_noisy_points=0, log=print,
                  tracer=None):
    """One pass over `dataset`: each batch (padded to the batch size) voted
    over `num_votes` point shuffles, with `num_noisy_points` random points
    put in place of each cloud's first. `place` moves a numpy batch to the
    model's device. Returns (accuracy, per-class accuracy)."""
    from pointasnl_tpu_torch.data import provider

    total_correct = total_seen = 0
    class_seen = np.zeros(flags.num_classes)
    class_correct = np.zeros(flags.num_classes)
    while dataset.has_next_batch():
        batch_data, batch_label = dataset.next_batch()
        bsize = batch_data.shape[0]
        if num_noisy_points > 0:
            noisy = rs.random_sample((bsize, num_noisy_points, 3))
            # One point has no scale: normalize_data divides 0 by 0 there,
            # and the reference (and the JAX package) put NaN in each cloud,
            # which the searches cannot rank. Centred, it lies at the origin.
            noisy = (provider.normalize_data(noisy) if num_noisy_points > 1
                     else np.zeros_like(noisy))
            batch_data[:, :num_noisy_points, :3] = noisy
        if bsize < flags.batch_size:
            pad = flags.batch_size - bsize
            batch_data = np.concatenate([batch_data, np.repeat(batch_data[:1], pad, 0)], 0)
            batch_label = np.concatenate([batch_label, np.repeat(batch_label[:1], pad, 0)], 0)
        pred_sum = np.zeros((flags.batch_size, flags.num_classes))
        for _ in range(flags.num_votes):
            shuffled = np.arange(flags.num_point)
            rs.shuffle(shuffled)
            points = place(batch_data[:, shuffled, :])
            logits = (tracer.traced(lambda: predict(state, points)) if tracer is not None
                      else predict(state, points))
            pred_sum += logits.float().cpu().numpy()
        preds = np.argmax(pred_sum, 1)[:bsize]
        labels = batch_label[:bsize]
        total_correct += int(np.sum(preds == labels))
        total_seen += bsize
        for i in range(bsize):
            class_seen[labels[i]] += 1
            class_correct[labels[i]] += int(preds[i] == labels[i])
    dataset.reset()
    acc = total_correct / max(total_seen, 1)
    log(f"Eval accuracy: {acc:.4f}")
    log(f"Eval avg class acc: {float(np.mean(class_correct / np.maximum(class_seen, 1))):.4f}")
    return acc, class_correct / np.maximum(class_seen, 1)


def main(argv=None):
    flags = parse_args(argv)
    check_dp(flags)
    dev = device(flags)
    from pointasnl_tpu_torch.nn import precision

    with precision.compute_dtype(flags.precision):
        return _main_body(flags, dev)


def _main_body(flags, dev):
    from pointasnl_tpu_torch.data.modelnet import ModelNetDataset
    from pointasnl_tpu_torch.models import get_model_class
    from pointasnl_tpu_torch.train import (
        create_train_state,
        make_predict_step,
        restore_checkpoint,
        staircase_lr_schedule,
    )
    from pointasnl_tpu_torch.train.profiling import StepTraceWindow
    from pointasnl_tpu_torch.utils import Logger

    log = Logger(flags.log_dir, filename="log_eval.txt")
    rs = np.random.RandomState(flags.seed)

    dataset = ModelNetDataset(
        flags.data,
        batch_size=flags.batch_size,
        npoints=flags.num_point,
        split="test",
        normal_channel=flags.normal,
        random_state=rs,
    )

    model = get_model_class(flags.model)(
        num_class=flags.num_classes, use_normal=flags.normal, adaptive_sample=flags.AS,
        generator=torch.Generator().manual_seed(0), device=dev,
    )
    state = create_train_state(model, optimizer="adam",
                               lr_schedule=staircase_lr_schedule(1e-3, flags.batch_size, 2e5, 0.7))
    state = restore_checkpoint(state, flags.log_dir, flags.ckpt)
    predict = make_predict_step()

    def place(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)

    tracer = StepTraceWindow(os.path.join(flags.log_dir, "profile"), enabled=flags.profile,
                             log=log)
    try:
        log("*** Evaluation ***")
        try:
            acc, class_accs = evaluate_once(state, predict, dataset, flags, rs, place, log=log,
                                            tracer=tracer)
        finally:
            tracer.close()
        for i, name in enumerate(dataset.cat):
            log(f"{name:>12s}:\t{class_accs[i]:.3f}")

        if not flags.noise:
            return acc
        lines = ["Noise    Accuracy", f" 000       {acc:.3f}"]
        sweep = {0: acc}
        for n in NOISE_POINTS:
            log(f"*** Evaluation with {n} Noisy Points ***")
            nacc, _ = evaluate_once(state, predict, dataset, flags, rs, place,
                                    num_noisy_points=n, log=log)
            lines.append(f" {n:03d}       {nacc:.3f}")
            sweep[n] = nacc
        log("\n".join(lines))
        return sweep
    finally:
        log.close()


if __name__ == "__main__":
    main()
