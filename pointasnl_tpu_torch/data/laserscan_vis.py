"""Laser-scan visualization (a host tool, not in the train path), the port's
copy of ``pointasnl_tpu/data/laserscan_vis.py``.

Equivalent of SemanticKITTI/auxiliary/laserscanvis.py (a vispy app) built on
matplotlib: the interactive browser (`LaserScanVis`) keeps the reference's
window layout, key bindings and colouring, and the pure-numpy helpers
(`render_scan`, `render_range_image`) serve headless pipelines. All consume
the same SemLaserScan objects. matplotlib is imported inside the functions
and methods that draw, so the module imports where it is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pointasnl_tpu_torch.data.laserscan import LaserScan, SemLaserScan


def render_range_image(scan: LaserScan) -> np.ndarray:
    """The spherical range projection as a normalized grayscale image."""
    if scan.proj_range.max() <= 0:
        scan.do_range_projection()
    img = scan.proj_range.copy()
    img[img < 0] = 0
    mx = img.max()
    return img / mx if mx > 0 else img


def render_scan(
    scan: SemLaserScan,
    out_path: Optional[str] = None,
    max_points: int = 50000,
    random_state: Optional[np.random.RandomState] = None,
):
    """Top-down scatter of a (semantic) scan; saves a png when out_path given.

    Returns (points, colors) for further use. Requires matplotlib only when
    out_path is set.
    """
    rs = random_state if random_state is not None else np.random
    pts = scan.points
    if len(pts) > max_points:
        sel = rs.choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        sem = scan.sem_label[sel] if len(scan.sem_label) == len(scan.points) else None
    else:
        sem = scan.sem_label if len(scan.sem_label) == len(scan.points) else None

    if sem is not None and len(scan.sem_color_lut):
        colors = scan.sem_color_lut[np.clip(sem, 0, len(scan.sem_color_lut) - 1)]
    else:
        d = np.linalg.norm(pts, axis=1)
        dmax = d.max() if d.size else 1.0
        colors = np.stack([d / dmax] * 3, axis=1)

    if out_path is not None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(10, 10))
        ax.scatter(pts[:, 0], pts[:, 1], s=0.2, c=np.clip(colors, 0, 1))
        ax.set_aspect("equal")
        ax.axis("off")
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return pts, colors


class LaserScanVis:
    """Interactive scan browser on matplotlib.

    Behavioral equivalent of the reference's vispy app
    (SemanticKITTI/auxiliary/laserscanvis.py:14-226): one window with a 3D
    point-cloud panel per enabled view (range-colored, semantics, instances)
    above the corresponding spherical range-image rows; keys n/b step through
    the scan list with wraparound, q/escape quits. Runs interactively under
    any GUI matplotlib backend and headlessly (for tests / frame dumps) under
    Agg — `save_frame` writes the current window to a png either way.
    """

    #: the reference compresses ranges with range**(1/16) before colormapping
    RANGE_POWER = 16

    def __init__(
        self,
        scan: SemLaserScan,
        scan_names,
        label_names=None,
        offset: int = 0,
        semantics: bool = True,
        instances: bool = False,
        max_points: int = 65536,
    ):
        if not semantics and instances:
            raise ValueError("Instances are only allowed when semantics=True")
        if semantics and label_names is None:
            raise ValueError("semantics=True requires label_names")
        self.scan = scan
        self.scan_names = list(scan_names)
        self.label_names = list(label_names) if label_names is not None else None
        self.offset = offset
        self.total = len(self.scan_names)
        self.semantics = semantics
        self.instances = instances
        self.max_points = max_points
        self.action = "no"  # no / next / back / quit, mirroring the reference
        self._closed = False
        self.reset()
        self.update_scan()

    # -- canvas ----------------------------------------------------------
    def reset(self):
        import matplotlib.pyplot as plt

        ncols = 1 + int(self.semantics) + int(self.instances)
        self.fig = plt.figure(figsize=(6 * ncols, 8))
        gs = self.fig.add_gridspec(
            1 + ncols, ncols, height_ratios=[6] + [1] * ncols
        )
        self.cloud_axes = []
        for c in range(ncols):
            ax = self.fig.add_subplot(gs[0, c], projection="3d")
            ax.set_axis_off()
            self.cloud_axes.append(ax)
        # one full-width range-image row per enabled view (reference stacks
        # depth / sem / inst rows in its img canvas)
        self.img_axes = []
        for r in range(ncols):
            ax = self.fig.add_subplot(gs[1 + r, :])
            ax.set_axis_off()
            self.img_axes.append(ax)
        self.fig.canvas.mpl_connect("key_press_event", self.key_press)

    # -- data ------------------------------------------------------------
    def _subsample(self, n: int, rs=None):
        if n <= self.max_points:
            return np.arange(n)
        rs = rs or np.random.RandomState(0)
        return np.sort(rs.choice(n, self.max_points, replace=False))

    def update_scan(self):
        self.scan.open_scan(self.scan_names[self.offset])
        if self.semantics:
            self.scan.open_label(self.label_names[self.offset])
            self.scan.colorize()
        if self.scan.proj_range.max() <= 0:
            self.scan.do_range_projection()
            if self.semantics:
                self.scan.do_label_projection()

        title = "scan " + str(self.offset)
        try:
            self.fig.canvas.manager.set_window_title(title)
        except AttributeError:  # headless backends have no window manager
            pass
        self.fig.suptitle(title)

        sel = self._subsample(len(self.scan.points))
        pts = self.scan.points[sel]

        # range-colored cloud: range**(1/16) normalized into viridis
        rng_data = self.scan.unproj_range[sel] ** (1 / self.RANGE_POWER)
        span = rng_data.max() - rng_data.min()
        rng01 = (rng_data - rng_data.min()) / span if span > 0 else rng_data * 0
        import matplotlib

        viridis = matplotlib.colormaps["viridis"]
        panels = [(rng01, viridis(rng01)[:, :3])]
        if self.semantics:
            panels.append((None, np.clip(self.scan.sem_label_color[sel], 0, 1)))
        if self.instances:
            panels.append((None, np.clip(self.scan.inst_label_color[sel], 0, 1)))

        for ax, (_, colors) in zip(self.cloud_axes, panels):
            ax.clear()
            ax.set_axis_off()
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.3, c=colors)
            ax.set_box_aspect((1, 1, 0.25))

        # range-image rows (depth normalized exactly like the reference)
        depth = np.copy(self.scan.proj_range)
        valid = depth > 0
        if valid.any():
            depth[valid] = depth[valid] ** (1 / self.RANGE_POWER)
            dmin = depth[valid].min()
            depth[~valid] = dmin
            dspan = depth.max() - dmin
            depth = (depth - dmin) / dspan if dspan > 0 else depth * 0
        imgs = [(depth, "viridis")]
        if self.semantics:
            imgs.append((np.clip(self.scan.proj_sem_color, 0, 1), None))
        if self.instances:
            imgs.append((np.clip(self.scan.proj_inst_color, 0, 1), None))
        for ax, (img, cmap) in zip(self.img_axes, imgs):
            ax.clear()
            ax.set_axis_off()
            ax.imshow(img, cmap=cmap, aspect="auto", interpolation="nearest")
        self.fig.canvas.draw_idle()

    # -- interface (n next, b back, q quit — reference key_press parity) --
    def key_press(self, event):
        key = (event.key or "").lower()
        if key == "n":
            self.action = "next"
            self.offset = (self.offset + 1) % self.total
            self.update_scan()
        elif key == "b":
            self.action = "back"
            self.offset = (self.offset - 1) % self.total
            self.update_scan()
        elif key in ("q", "escape"):
            self.action = "quit"
            self.destroy()

    def save_frame(self, out_path: str):
        """Write the current window to a png (works headless)."""
        self.fig.savefig(out_path, dpi=100)

    def destroy(self):
        import matplotlib.pyplot as plt

        if not self._closed:
            plt.close(self.fig)
            self._closed = True

    def run(self):
        """Block in the GUI event loop (no-op under non-interactive backends)."""
        import matplotlib.pyplot as plt

        plt.show()
