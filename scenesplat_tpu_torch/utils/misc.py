"""Metric and voting helpers on the host (the port's copy of
``scenesplat_tpu/utils/misc.py``: ``AverageMeter``,
``intersection_and_union``, ``neighbor_voting``, ``clustering_voting``).
The neighbour search is ``ops/knn.py`` in place of the JAX package's host
C++ library."""

from __future__ import annotations

from typing import Optional

import numpy as np

from scenesplat_tpu_torch.ops.knn import knn


class AverageMeter:
    """Tracks current value / running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def intersection_and_union(output: np.ndarray, target: np.ndarray, num_classes: int,
                           ignore_index: int = -1):
    """Per-class intersection / union / target counts; predictions at
    ignored targets are themselves set to ignore before the histogram."""
    output = output.reshape(-1).copy()
    target = target.reshape(-1)
    output[target == ignore_index] = ignore_index
    bins = np.arange(num_classes + 1)
    area_intersection, _ = np.histogram(output[output == target], bins=bins)
    area_output, _ = np.histogram(output, bins=bins)
    area_target, _ = np.histogram(target, bins=bins)
    return area_intersection, area_output + area_target - area_intersection, area_target


def neighbor_voting(coord: np.ndarray, pred: np.ndarray, vote_k: int,
                    valid_mask: np.ndarray, num_classes: int,
                    query_coord: Optional[np.ndarray] = None, ignore_index: int = -1,
                    device="cpu") -> np.ndarray:
    """Majority vote over the k nearest neighbours that hold a valid
    prediction. Queries default to all points; only points with
    ``valid_mask`` vote. The search runs on ``device`` (``ops/knn.py``)."""
    valid_coord = coord[valid_mask]
    valid_pred = pred[valid_mask]
    if valid_coord.shape[0] == 0:
        n = coord.shape[0] if query_coord is None else query_coord.shape[0]
        return np.full(n, ignore_index, dtype=pred.dtype)
    if query_coord is None:
        query_coord = coord
    nn_idx = knn(valid_coord, query_coord, min(vote_k, valid_coord.shape[0]), device=device)
    return _majority_vote(valid_pred[nn_idx], num_classes, ignore_index)


def _majority_vote(neighbor_labels: np.ndarray, num_classes: int, ignore_index: int,
                   rows_per_chunk: int = 1 << 16) -> np.ndarray:
    """Per-row majority vote over [M, k] labels (the lowest class among the
    most frequent wins); ``ignore_index`` never wins unless every vote is
    ignored. Counted in chunks of rows with one ``bincount`` each."""
    labels = neighbor_labels.astype(np.int64)
    valid = labels != ignore_index
    shifted = np.where(valid, labels, num_classes)  # bin ignore at the end
    width = num_classes + 1
    maj = np.empty(labels.shape[0], np.int64)
    for s in range(0, labels.shape[0], rows_per_chunk):
        chunk = shifted[s:s + rows_per_chunk]
        flat = chunk + np.arange(chunk.shape[0])[:, None] * width
        counts = np.bincount(flat.ravel(), minlength=chunk.shape[0] * width)
        maj[s:s + rows_per_chunk] = counts.reshape(-1, width)[:, :num_classes].argmax(axis=1)
    maj = maj.astype(neighbor_labels.dtype)
    maj[~valid.any(axis=1)] = ignore_index
    return maj


def clustering_voting(pred: np.ndarray, instance: np.ndarray,
                      ignore_index: int = -1) -> np.ndarray:
    """Assign each instance the majority predicted class of its points; the
    ignore label votes like any other class."""
    pred = pred.copy()
    for inst_id in np.unique(instance):
        if inst_id == ignore_index:
            continue
        mask = instance == inst_id
        values, counts = np.unique(pred[mask], return_counts=True)
        pred[mask] = values[counts.argmax()]
    return pred
