"""Visualize a 3DGS scene directory of .npy assets (counterpart of the
repo's ``tools/visualize_scene.py``; numpy only, no device).

Headless-first: the default backend writes a PLY (coloured point cloud, or
opacity-modulated ellipsoid surface samples for mode=gaussians) that any
viewer opens; the matplotlib backend renders a PNG scatter. The interactive
open3d path stays behind --backend open3d, imported only then.

    python -m scenesplat_tpu_torch.tools.visualize_scene SCENE_DIR \
        [--mode pointcloud|gaussians|both] [--backend ply|matplotlib|open3d]
        [--sample-ratio 0.25] [--out viz/scene0011_00]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from scenesplat_tpu_torch.utils.visualization import save_point_cloud_ply

REQUIRED = ("coord", "color")
OPTIONAL = ("opacity", "quat", "scale", "normal", "pc_coord", "lang_feat",
            "valid_feat_mask", "segment")


def load_scene_data(scene_path):
    """The scene's required and optional .npy assets by name."""
    if not os.path.isdir(scene_path):
        raise FileNotFoundError(f"Scene directory not found: {scene_path}")
    data = {}
    for name in REQUIRED:
        path = os.path.join(scene_path, name + ".npy")
        if not os.path.exists(path):
            raise FileNotFoundError(f"Required asset missing: {path}")
        data[name] = np.load(path)
    for name in OPTIONAL:
        path = os.path.join(scene_path, name + ".npy")
        if os.path.exists(path):
            data[name] = np.load(path)
    return data


def _sample(n, ratio, rng):
    if ratio >= 1.0:
        return np.arange(n)
    k = max(1, int(n * ratio))
    return rng.choice(n, k, replace=False)


def quat_to_rotmat(quat):
    """wxyz quaternions [N, 4] -> rotation matrices [N, 3, 3]."""
    q = quat / np.clip(np.linalg.norm(quat, axis=-1, keepdims=True), 1e-12, None)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=1)


def gaussian_surface_points(data, max_gaussians=10000, samples_per_gaussian=32,
                            seed=0):
    """Ellipsoid surface samples per Gaussian: unit-sphere points scaled by
    `scale`, rotated by `quat`, translated by `coord`; colours modulated by
    opacity."""
    rng = np.random.default_rng(seed)
    n = len(data["coord"])
    idx = rng.choice(n, min(max_gaussians, n), replace=False)
    coord = data["coord"][idx].astype(np.float64)
    scale = data.get("scale")
    scale = (scale[idx] if scale is not None
             else np.full((len(idx), 3), 0.01))
    quat = data.get("quat")
    rot = (quat_to_rotmat(quat[idx]) if quat is not None
           else np.broadcast_to(np.eye(3), (len(idx), 3, 3)))
    opacity = data.get("opacity")
    opacity = (np.asarray(opacity[idx]).reshape(-1, 1)
               if opacity is not None else np.ones((len(idx), 1)))
    color = data["color"][idx] / 255.0 * np.clip(opacity, 0.0, 1.0)

    sphere = rng.normal(size=(samples_per_gaussian, 3))
    sphere /= np.clip(np.linalg.norm(sphere, axis=-1, keepdims=True), 1e-12, None)
    # [G, S, 3] = coord + (R @ diag(scale) @ sphere^T)^T
    pts = coord[:, None, :] + np.einsum(
        "gij,gsj->gsi", rot, sphere[None] * scale[:, None, :])
    cols = np.repeat(color, samples_per_gaussian, axis=0)
    return pts.reshape(-1, 3), (cols * 255.0).astype(np.uint8)


def visualize_ply(data, mode, sample_ratio, out_prefix, seed=0):
    rng = np.random.default_rng(seed)
    written = []
    if mode in ("pointcloud", "both"):
        idx = _sample(len(data["coord"]), sample_ratio, rng)
        path = out_prefix + "_points.ply"
        save_point_cloud_ply(path, data["coord"][idx], data["color"][idx])
        written.append(path)
    if mode in ("gaussians", "both"):
        pts, cols = gaussian_surface_points(data, seed=seed)
        path = out_prefix + "_gaussians.ply"
        save_point_cloud_ply(path, pts, cols)
        written.append(path)
    return written


def visualize_matplotlib(data, sample_ratio, out_prefix, seed=0):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    idx = _sample(len(data["coord"]), min(sample_ratio, 0.25), rng)
    coord, color = data["coord"][idx], data["color"][idx] / 255.0
    fig = plt.figure(figsize=(12, 8))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(coord[:, 0], coord[:, 1], coord[:, 2], c=color, s=1, alpha=0.6)
    ax.set_title(f"SceneSplat point cloud ({len(idx):,} points)")
    path = out_prefix + "_points.png"
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return [path]


def visualize_open3d(data, mode, sample_ratio, seed=0):
    import open3d as o3d  # optional; not in the base image

    rng = np.random.default_rng(seed)
    geoms = []
    if mode in ("pointcloud", "both"):
        idx = _sample(len(data["coord"]), sample_ratio, rng)
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(data["coord"][idx])
        pcd.colors = o3d.utility.Vector3dVector(data["color"][idx] / 255.0)
        if "normal" in data:
            pcd.normals = o3d.utility.Vector3dVector(data["normal"][idx])
        geoms.append(pcd)
    if mode in ("gaussians", "both"):
        pts, cols = gaussian_surface_points(data, seed=seed)
        pcd = o3d.geometry.PointCloud()
        pcd.points = o3d.utility.Vector3dVector(pts)
        pcd.colors = o3d.utility.Vector3dVector(cols / 255.0)
        geoms.append(pcd)
    o3d.visualization.draw_geometries(geoms)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("scene_path")
    parser.add_argument("--mode", choices=["pointcloud", "gaussians", "both"],
                        default="pointcloud")
    parser.add_argument("--backend", choices=["ply", "matplotlib", "open3d"],
                        default="ply")
    parser.add_argument("--sample-ratio", type=float, default=1.0)
    parser.add_argument("--out", default=None,
                        help="output path prefix (default: viz/<scene name>)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    data = load_scene_data(args.scene_path)
    print("Scene data summary:")
    print(f"- points: {len(data['coord']):,}")
    for key in OPTIONAL:
        if key in data:
            print(f"- {key}: {data[key].shape} {data[key].dtype}")

    out_prefix = args.out or os.path.join(
        "viz", os.path.basename(os.path.normpath(args.scene_path)))
    os.makedirs(os.path.dirname(out_prefix) or ".", exist_ok=True)

    if args.backend == "open3d":
        visualize_open3d(data, args.mode, args.sample_ratio, args.seed)
        return 0
    if args.backend == "matplotlib":
        written = visualize_matplotlib(data, args.sample_ratio, out_prefix,
                                       args.seed)
    else:
        written = visualize_ply(data, args.mode, args.sample_ratio, out_prefix,
                                args.seed)
    for path in written:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
