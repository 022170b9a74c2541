"""Point-cloud utility functions: volume/image conversions and renders, the
port's numpy copy of ``pointasnl_tpu/data/pc_util.py``.

API parity with utils/pc_util.py: voxel-volume round trips, per-voxel
sampled volumes/images, orthographic three-view renders, colored ply dumps.
Implementations are vectorized numpy (the reference loops per point).
matplotlib is imported only inside the functions that draw or colour with
it, so the module imports where matplotlib is absent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


# ----------------------------------------------------------------- volumes


def point_cloud_to_volume(points: np.ndarray, vsize: int, radius: float = 1.0) -> np.ndarray:
    """Occupancy voxel grid: points assumed in [-radius, radius]^3 -> (v, v, v)."""
    vol = np.zeros((vsize, vsize, vsize), np.float32)
    voxel = 2 * radius / float(vsize)
    locations = np.clip(((points + radius) / voxel).astype(int), 0, vsize - 1)
    vol[locations[:, 0], locations[:, 1], locations[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds, vsize=12, radius=1.0, flatten=True):
    """(B, N, 3) -> (B, v, v, v) occupancy (or flattened (B, v^3))."""
    vol_list = [
        point_cloud_to_volume(np.squeeze(pc), vsize, radius)[None] for pc in point_clouds
    ]
    out = np.concatenate(vol_list, 0)
    return out.reshape(out.shape[0], -1) if flatten else np.expand_dims(out, -1)


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupied voxel centers (indices) of a (v, v, v) grid -> (K, 3)."""
    assert vol.ndim == 3 and vol.shape[0] == vol.shape[1] == vol.shape[2]
    return np.argwhere(vol > 0).astype(np.float32)


def _group_points_by_voxel(points, vsize, radius, num_sample):
    """Map each voxel to up to num_sample member points (pad by resampling)."""
    voxel = 2 * radius / float(vsize)
    locations = np.clip(((points + radius) / voxel).astype(int), 0, vsize - 1)
    groups = {}
    for i, loc in enumerate(map(tuple, locations)):
        groups.setdefault(loc, []).append(i)
    return groups


def point_cloud_to_volume_v2(points, vsize, radius=1.0, num_sample=128):
    """Voxel grid where each voxel stores num_sample normalized local points.

    Returns (vsize, vsize, vsize, num_sample, 3) — pc_util.py:84-123 contract
    (voxel-local coordinates, short voxels padded by resampling).
    """
    vol = np.zeros((vsize, vsize, vsize, num_sample, 3), np.float32)
    voxel = 2 * radius / float(vsize)
    groups = _group_points_by_voxel(points, vsize, radius, num_sample)
    for loc, idxs in groups.items():
        pts = points[idxs]
        if len(pts) > num_sample:
            choice = np.random.choice(len(pts), num_sample, replace=False)
            pts = pts[choice]
        elif len(pts) < num_sample:
            choice = np.random.choice(len(pts), num_sample - len(pts), replace=True)
            pts = np.concatenate([pts, pts[choice]], 0)
        center = (np.array(loc) + 0.5) * voxel - radius
        vol[loc[0], loc[1], loc[2]] = (pts - center) / voxel
    return vol


def point_cloud_to_volume_v2_batch(point_clouds, vsize=12, radius=1.0, num_sample=128):
    return np.stack(
        [point_cloud_to_volume_v2(np.squeeze(pc), vsize, radius, num_sample) for pc in point_clouds]
    )


def point_cloud_to_image(points, imgsize, radius=1.0, num_sample=128):
    """2D pixel grid of num_sample normalized local points per pixel:
    (imgsize, imgsize, num_sample, 3) — pc_util.py:138-173."""
    img = np.zeros((imgsize, imgsize, num_sample, 3), np.float32)
    pixel = 2 * radius / float(imgsize)
    locations = np.clip(((points[:, :2] + radius) / pixel).astype(int), 0, imgsize - 1)
    groups = {}
    for i, loc in enumerate(map(tuple, locations)):
        groups.setdefault(loc, []).append(i)
    for loc, idxs in groups.items():
        pts = points[idxs]
        if len(pts) > num_sample:
            choice = np.random.choice(len(pts), num_sample, replace=False)
            pts = pts[choice]
        elif len(pts) < num_sample:
            choice = np.random.choice(len(pts), num_sample - len(pts), replace=True)
            pts = np.concatenate([pts, pts[choice]], 0)
        center = np.array([(loc[0] + 0.5) * pixel - radius, (loc[1] + 0.5) * pixel - radius, 0.0])
        img[loc[0], loc[1]] = (pts - center) / pixel
    return img


def point_cloud_to_image_batch(point_clouds, imgsize, radius=1.0, num_sample=128):
    return np.stack(
        [point_cloud_to_image(np.squeeze(pc), imgsize, radius, num_sample) for pc in point_clouds]
    )


# ---------------------------------------------------------------- renders


def euler2mat(z=0, y=0, x=0):
    """ZYX euler angles to rotation matrix."""
    Ms = []
    if z:
        c, s = np.cos(z), np.sin(z)
        Ms.append(np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]))
    if y:
        c, s = np.cos(y), np.sin(y)
        Ms.append(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]]))
    if x:
        c, s = np.cos(x), np.sin(x)
        Ms.append(np.array([[1, 0, 0], [0, c, -s], [0, s, c]]))
    if Ms:
        out = Ms[0]
        for M in Ms[1:]:
            out = out @ M
        return out
    return np.eye(3)


def draw_point_cloud(
    input_points,
    canvasSize=500,
    space=200,
    diameter=25,
    xrot=0,
    yrot=0,
    zrot=0,
    switch_xyz=(0, 1, 2),
    normalize=True,
):
    """Render a cloud to a grayscale orthographic image (pc_util.py:196-253).

    Gaussian disk splatting of unit-normalized points, depth-sorted.
    """
    image = np.zeros((canvasSize, canvasSize))
    if input_points is None or input_points.shape[0] == 0:
        return image
    points = input_points[:, switch_xyz]
    M = euler2mat(zrot, yrot, xrot)
    points = (M @ points.T).T

    if normalize:
        centroid = np.mean(points, axis=0)
        points = points - centroid
        furthest = np.max(np.sqrt(np.sum(points**2, axis=-1)))
        points = points / (furthest + 1e-12)

    # Gaussian disk
    radius = diameter / 2.0
    disk = np.zeros((diameter, diameter))
    for i in range(diameter):
        for j in range(diameter):
            if (i - radius) ** 2 + (j - radius) ** 2 <= radius**2:
                disk[i, j] = np.exp(
                    (-((i - radius) ** 2) - (j - radius) ** 2) / (radius**2)
                )
    mask = np.argwhere(disk > 0)
    dx = mask[:, 0] - int(radius)
    dy = mask[:, 1] - int(radius)
    dv = disk[disk > 0]

    zorder = np.argsort(points[:, 2])
    points = points[zorder]
    max_depth = np.max(points[:, 2]) + 1e-12

    for p in points:
        j = int(np.round((p[0] + 1.0) / 2.0 * space)) + (canvasSize - space) // 2
        i = int(np.round((p[1] + 1.0) / 2.0 * space)) + (canvasSize - space) // 2
        xs = i + dx
        ys = j + dy
        inb = (xs >= 0) & (xs < canvasSize) & (ys >= 0) & (ys < canvasSize)
        image[xs[inb], ys[inb]] = dv[inb] * max(0.0, 1.0 - 0.5 * p[2] / max_depth)

    image = image / (np.max(image) + 1e-12)
    return image


def point_cloud_three_views(points):
    """Three orthographic renders stacked vertically (pc_util.py:255-266)."""
    img1 = draw_point_cloud(points, zrot=110 / 180.0 * np.pi, xrot=45 / 180.0 * np.pi)
    img2 = draw_point_cloud(points, zrot=70 / 180.0 * np.pi, xrot=135 / 180.0 * np.pi)
    img3 = draw_point_cloud(points, zrot=180.0 / 180.0 * np.pi, xrot=90 / 180.0 * np.pi)
    return np.concatenate([img1, img2, img3], axis=0)


def pyplot_draw_point_cloud(points, output_filename):  # pragma: no cover - viz
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2])
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    plt.savefig(output_filename)
    plt.close(fig)


def pyplot_draw_volume(vol, output_filename):  # pragma: no cover - viz
    pyplot_draw_point_cloud(volume_to_point_cloud(vol), output_filename)


# --------------------------------------------------------------------- IO


def write_ply_color(points, labels, out_filename, num_classes: Optional[int] = None):
    """Colored ascii ply of a labeled cloud (pc_util.py:299-315)."""
    import matplotlib.pyplot as plt

    labels = labels.astype(int)
    N = points.shape[0]
    if num_classes is None:
        num_classes = np.max(labels) + 1
    assert num_classes > np.max(labels), "labels should be 0..num_classes-1"
    colors = [plt.cm.hsv(i / float(num_classes)) for i in range(num_classes)]
    with open(out_filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {N}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for i in range(N):
            c = [int(x * 255) for x in colors[labels[i]][:3]]
            f.write(
                f"{points[i, 0]:f} {points[i, 1]:f} {points[i, 2]:f} {c[0]} {c[1]} {c[2]}\n"
            )
