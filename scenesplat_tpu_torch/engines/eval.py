"""Zero-shot open-vocabulary evaluation core (counterpart of
``scenesplat_tpu/engines/eval.py``): cosine logits of L2-normalized features
against text embeddings, sigmoid, argmax with a confidence threshold; then,
on the host, neighbour voting onto the evaluation point cloud, instance
clustering voting, and the per-class intersection / union counts behind
mIoU and foreground mIoU."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from scenesplat_tpu_torch.data import metadata
from scenesplat_tpu_torch.utils.misc import (
    clustering_voting,
    intersection_and_union,
    neighbor_voting,
)


def load_text_embeddings(path: str) -> np.ndarray:
    """[num_classes, D] L2-normalized text embeddings from a ``.npy`` file,
    a torch ``.pt`` file (a tensor, or a dict holding one tensor) or a
    packaged table (``builtin:<name>``)."""
    if path.startswith("builtin:"):
        return metadata.text_embeddings(path.split(":", 1)[1])
    if path.endswith(".npy"):
        emb = np.load(path)
    else:
        loaded = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(loaded, dict):
            tensors = [v for v in loaded.values() if isinstance(v, torch.Tensor)]
            if len(tensors) != 1:
                raise ValueError(f"{path} holds {len(tensors)} tensors, expected one")
            loaded = tensors[0]
        emb = loaded.detach().float().numpy() if isinstance(loaded, torch.Tensor) \
            else np.asarray(loaded)
    emb = emb.astype(np.float32)
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return emb


def load_class_names(path_or_list) -> List[str]:
    if isinstance(path_or_list, (list, tuple)):
        return list(path_or_list)
    if path_or_list.startswith("builtin:"):
        return metadata.class_labels(path_or_list.split(":", 1)[1])
    with open(path_or_list) as f:
        return [ln.strip() for ln in f if ln.strip()]


def zero_shot_predict(feat: np.ndarray, text_emb: np.ndarray,
                      confidence_threshold: float = 0.0, ignore_index: int = -1,
                      top3: bool = False):
    """Per-point class prediction from normalized features: logits =
    feat @ text^T -> sigmoid -> argmax, below ``confidence_threshold`` set
    to ``ignore_index``; ``top3`` keeps the three best classes with no
    threshold (ScanNet++ protocol). Returns (pred, prob)."""
    logits = feat @ text_emb.T
    prob = 1.0 / (1.0 + np.exp(-logits))
    if top3:
        k = min(3, prob.shape[1])
        pred = np.argsort(-prob, axis=1, kind="stable")[:, :k].astype(np.int32)
        return pred, prob
    pred = prob.argmax(axis=1).astype(np.int32)
    if confidence_threshold > 0:
        pred = np.where(prob.max(axis=1) >= confidence_threshold, pred, ignore_index)
    return pred, prob


class ZeroShotMetric:
    """Accumulates per-class intersection, union and target counts over
    scenes and reports mIoU / fg_mIoU (classes in ``excluded_classes`` left
    out of the foreground means)."""

    def __init__(self, class_names: Sequence[str], excluded_classes: Sequence[str] = (),
                 ignore_index: int = -1):
        self.class_names = list(class_names)
        self.num_classes = len(self.class_names)
        self.excluded = [i for i, n in enumerate(self.class_names)
                         if n in set(excluded_classes)]
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.intersection = np.zeros(self.num_classes, np.float64)
        self.union = np.zeros(self.num_classes, np.float64)
        self.target = np.zeros(self.num_classes, np.float64)

    def update(self, pred: np.ndarray, target: np.ndarray):
        i, u, t = intersection_and_union(pred, target, self.num_classes, self.ignore_index)
        self.intersection += i
        self.union += u
        self.target += t

    def results(self, protocol: str = "hook"):
        """protocol="hook": IoU over the classes present in the targets;
        protocol="tester": mIoU over union != 0 and mAcc over target != 0
        (the reference's evaluator hook and tester mask differently)."""
        iou = self.intersection / np.maximum(self.union, 1e-10)
        acc = self.intersection / np.maximum(self.target, 1e-10)
        seen = self.target > 0
        iou_mask = (self.union > 0) if protocol == "tester" else seen
        fg_iou = iou_mask.copy()
        fg_iou[self.excluded] = False
        fg_acc = seen.copy()
        fg_acc[self.excluded] = False
        fg_t = self.target.copy()
        fg_i = self.intersection.copy()
        fg_i[self.excluded] = 0
        fg_t[self.excluded] = 0
        return {
            "mIoU": float(iou[iou_mask].mean()) if iou_mask.any() else 0.0,
            "fg_mIoU": float(iou[fg_iou].mean()) if fg_iou.any() else 0.0,
            "mAcc": float(acc[seen].mean()) if seen.any() else 0.0,
            "fg_mAcc": float(acc[fg_acc].mean()) if fg_acc.any() else 0.0,
            "allAcc": float(self.intersection.sum() / max(self.target.sum(), 1e-10)),
            "fg_allAcc": float(fg_i.sum() / max(fg_t.sum(), 1e-10)),
            "iou_per_class": iou,
            "acc_per_class": acc,
        }


def evaluate_scene(feat: np.ndarray, coord: np.ndarray, segment: np.ndarray,
                   text_emb: np.ndarray, metric: ZeroShotMetric,
                   valid_feat_mask: Optional[np.ndarray] = None,
                   pc_coord: Optional[np.ndarray] = None,
                   pc_segment: Optional[np.ndarray] = None,
                   instance: Optional[np.ndarray] = None, vote_k: int = 25,
                   enable_voting: bool = True, confidence_threshold: float = 0.1,
                   ignore_index: int = -1, device="cpu") -> np.ndarray:
    """One scene's zero-shot pipeline; updates ``metric`` and returns the
    prediction. With ``pc_coord`` / ``pc_segment``, predictions move to the
    evaluation point cloud by a majority vote over the ``vote_k`` nearest
    Gaussians that hold a valid language feature and a confident
    prediction (searched on ``device``)."""
    pred, _ = zero_shot_predict(feat, text_emb, confidence_threshold, ignore_index)
    if enable_voting and pc_coord is not None:
        valid = (valid_feat_mask.astype(bool) if valid_feat_mask is not None
                 else np.ones(len(pred), bool))
        pred_eval = neighbor_voting(coord, pred, vote_k, valid & (pred != ignore_index),
                                    metric.num_classes, query_coord=pc_coord,
                                    ignore_index=ignore_index, device=device)
        target = pc_segment
    else:
        pred_eval, target = pred, segment
    if instance is not None:
        pred_eval = clustering_voting(pred_eval, instance, ignore_index)
    if target is not None:
        metric.update(pred_eval, target)
    return pred_eval
