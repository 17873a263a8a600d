"""Point-cloud visualization writers (counterpart of
``scenesplat_tpu/utils/visualization.py``; reference: pointcept/utils/
visualization.py ply writers, tools/visualize_features_pca.py): an ascii
PLY of points and colours, PCA colours of per-point features and a fixed
label palette. numpy in, numpy and files out."""

from __future__ import annotations

import os

import numpy as np


def save_point_cloud_ply(path: str, coord: np.ndarray, color=None):
    """Write an ascii ply of points (+uint8 color)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    n = coord.shape[0]
    has_color = color is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_color:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if has_color:
            color = np.clip(color, 0, 255).astype(np.uint8)
            for p, c in zip(coord, color):
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in coord:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def features_to_pca_colors(feat: np.ndarray, dim: int = 3) -> np.ndarray:
    """Project per-point features to RGB by PCA (the reference's 768 -> 3
    -> min-max over the 1st to 99th percentiles -> uint8), from the
    covariance's eigendecomposition in float64."""
    x = feat.astype(np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    cov = x.T @ x / max(x.shape[0] - 1, 1)
    w, v = np.linalg.eigh(cov)
    comps = v[:, np.argsort(w)[::-1][:dim]]
    proj = x @ comps
    lo = np.percentile(proj, 1, axis=0)
    hi = np.percentile(proj, 99, axis=0)
    norm = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return (norm * 255).astype(np.uint8)


def segmentation_to_colors(labels: np.ndarray, num_classes: int,
                           ignore_index: int = -1) -> np.ndarray:
    """A fixed label palette (numpy seed 7); ignored and out-of-range
    labels are gray."""
    rng = np.random.default_rng(7)
    palette = rng.integers(30, 255, size=(num_classes, 3)).astype(np.uint8)
    colors = np.full((labels.shape[0], 3), 128, np.uint8)
    valid = (labels >= 0) & (labels < num_classes)
    colors[valid] = palette[labels[valid]]
    return colors
