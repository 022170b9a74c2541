"""Browse SemanticKITTI scans (ground truth or dumped predictions), the
port's counterpart of ``pointasnl_tpu/cli/visualize_semantic_kitti.py``.

User surface for `data/laserscan_vis.LaserScanVis` — the rebuild of the
reference's vispy viewer (SemanticKITTI/auxiliary/laserscanvis.py). Points at
a dataset root laid out like the tester's input
(sequences/{seq}/velodyne/*.bin [+ labels/*.label]); `--predictions` swaps in
the uint32 `.label` files written by `test_semantic_kitti --save_dir` so
model output can be inspected next to (or instead of) ground truth.

Interactive under a GUI matplotlib backend (n/b step, q quits); with
`--out_dir` it renders frames headlessly to pngs instead. It runs on the
host only (numpy and matplotlib) and uses no card.

    python -m pointasnl_tpu_torch.cli.visualize_semantic_kitti --data <dataset> --out_dir <dir>
"""

from __future__ import annotations

import argparse
import glob
import os

from pointasnl_tpu_torch.data.laserscan import SemLaserScan
from pointasnl_tpu_torch.data.laserscan_vis import LaserScanVis
from pointasnl_tpu_torch.data.semantic_kitti_config import default_config, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser("visualize_semantic_kitti")
    p.add_argument("--data", required=True, help="dataset root (contains sequences/)")
    p.add_argument("--sequence", default="08")
    p.add_argument(
        "--predictions", default=None,
        help="root of a tester --save_dir; its sequences/{seq}/predictions/*.label "
        "are shown instead of the ground-truth labels",
    )
    p.add_argument("--config_file", default=None)
    p.add_argument("--offset", type=int, default=0, help="first scan to show")
    p.add_argument("--no_semantics", action="store_true", help="range coloring only")
    p.add_argument("--instances", action="store_true")
    p.add_argument("--max_points", type=int, default=65536)
    p.add_argument(
        "--out_dir", default=None,
        help="render up to --max_frames scans to pngs here instead of opening a window",
    )
    p.add_argument("--max_frames", type=int, default=10)
    return p.parse_args(argv)


def collect_files(data_root, sequence, predictions_root=None):
    scan_names = sorted(
        glob.glob(os.path.join(data_root, "sequences", sequence, "velodyne", "*.bin"))
    )
    if not scan_names:
        raise FileNotFoundError(
            f"no scans under {data_root}/sequences/{sequence}/velodyne"
        )
    label_dir = (
        os.path.join(predictions_root, "sequences", sequence, "predictions")
        if predictions_root
        else os.path.join(data_root, "sequences", sequence, "labels")
    )
    label_names = sorted(glob.glob(os.path.join(label_dir, "*.label")))
    if label_names and len(label_names) != len(scan_names):
        raise ValueError(
            f"{len(scan_names)} scans but {len(label_names)} labels in {label_dir}"
        )
    return scan_names, label_names


def main(argv=None):
    args = parse_args(argv)
    cfg = load_config(args.config_file) if args.config_file else default_config()
    semantics = not args.no_semantics

    scan_names, label_names = collect_files(args.data, args.sequence, args.predictions)
    if semantics and not label_names:
        raise FileNotFoundError(
            "no .label files found; pass --no_semantics to browse raw scans"
        )

    # the config stores BGR (reference convention); matplotlib wants RGB
    color_dict = {int(k): list(v)[::-1] for k, v in cfg["color_map"].items()}
    scan = SemLaserScan(
        nclasses=len(cfg["learning_map_inv"]), sem_color_dict=color_dict
    )

    if args.out_dir is not None:
        import matplotlib

        matplotlib.use("Agg")
        os.makedirs(args.out_dir, exist_ok=True)
        vis = LaserScanVis(
            scan, scan_names, label_names or None, offset=args.offset,
            semantics=semantics, instances=args.instances,
            max_points=args.max_points,
        )
        n = min(args.max_frames, len(scan_names) - args.offset)
        for i in range(n):
            out = os.path.join(args.out_dir, f"{args.offset + i:06d}.png")
            vis.save_frame(out)
            print(f"wrote {out}", flush=True)
            if i + 1 < n:
                vis.offset += 1
                vis.update_scan()
        vis.destroy()
        return n

    vis = LaserScanVis(
        scan, scan_names, label_names or None, offset=args.offset,
        semantics=semantics, instances=args.instances, max_points=args.max_points,
    )
    print("n: next scan, b: previous scan, q/esc: quit", flush=True)
    vis.run()
    return 0


if __name__ == "__main__":
    main()
