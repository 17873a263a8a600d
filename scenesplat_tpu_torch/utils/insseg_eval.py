"""ScanNet-protocol instance-segmentation AP on the host, numpy (the port's
copy of ``scenesplat_tpu/utils/insseg_eval.py``; reference
evaluator.py:273-546).

  - ``associate_instances`` intersects every prediction with every ground
    truth instance of its class, and with the void (ignored) region.
  - ``evaluate_matches`` runs the ScanNet benchmark's greedy matching at
    each overlap threshold: a second match to one instance is a false
    positive at the lower score, an unmatched valid instance a hard false
    negative, and an unmatched prediction that mostly covers void or small
    instances is ignored. AP integrates the precision-recall curve with the
    benchmark's [-0.5, 0, 0.5] step widths.

Overlaps 0.50 to 0.90 in steps of 0.05, and 0.25; regions of at least 100
points (reference l.256-259).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

OVERLAPS = np.append(np.arange(0.5, 0.95, 0.05), 0.25)
MIN_REGION_SIZE = 100


@dataclass
class SceneClassRecord:
    """Association of one scene's predictions/GTs for one class."""

    gt_counts: np.ndarray  # [G] vertex counts
    pred_conf: np.ndarray  # [P]
    pred_counts: np.ndarray  # [P]
    pred_void: np.ndarray  # [P] intersection with ignored segment region
    inter: np.ndarray  # [P, G] intersection counts


def associate_instances(
    pred_masks: np.ndarray,
    pred_classes: np.ndarray,
    pred_scores: np.ndarray,
    segment: np.ndarray,
    instance: np.ndarray,
    num_classes: int,
    segment_ignore_index: Sequence[int] = (-1,),
    instance_ignore_index: int = -1,
    min_region_size: int = MIN_REGION_SIZE,
) -> Dict[int, SceneClassRecord]:
    """Build per-class records for one scene (reference l.273-346).

    pred_masks [P, N] bool, pred_classes/scores [P]; segment/instance [N].
    Predictions with classes in segment_ignore_index or fewer than
    min_region_size vertices are dropped (reference l.313-327).
    """
    void_mask = np.isin(segment, np.asarray(segment_ignore_index))
    records: Dict[int, SceneClassRecord] = {}
    for cls in range(num_classes):
        if cls in segment_ignore_index:
            continue
        gt_sel = (segment == cls) & (instance != instance_ignore_index)
        gt_ids = np.unique(instance[gt_sel])
        gt_masks = [instance == g for g in gt_ids]
        gt_counts = np.array([m.sum() for m in gt_masks], np.int64)

        p_sel = np.where(pred_classes == cls)[0]
        keep = []
        for p in p_sel:
            if pred_masks[p].sum() >= min_region_size:
                keep.append(p)
        P, G = len(keep), len(gt_ids)
        conf = pred_scores[keep].astype(np.float64)
        counts = np.array([pred_masks[p].sum() for p in keep], np.int64)
        void = np.array(
            [np.count_nonzero(void_mask & pred_masks[p]) for p in keep], np.int64
        )
        inter = np.zeros((P, G), np.int64)
        for pi, p in enumerate(keep):
            for gi, gm in enumerate(gt_masks):
                inter[pi, gi] = np.count_nonzero(gm & pred_masks[p])
        records[cls] = SceneClassRecord(
            gt_counts=gt_counts, pred_conf=conf, pred_counts=counts,
            pred_void=void, inter=inter,
        )
    return records


def _average_precision(y_true, y_score, hard_fn):
    """ScanNet PR-curve integration (reference l.468-525)."""
    order = np.argsort(y_score)
    y_score, y_true = y_score[order], y_true[order]
    cum = np.cumsum(y_true)
    thresholds, uniq = np.unique(y_score, return_index=True)
    n_pr = len(uniq) + 1
    n = len(y_score)
    n_true = cum[-1] if len(cum) else 0
    precision = np.zeros(n_pr)
    recall = np.zeros(n_pr)
    cum = np.append(cum, 0)
    for r, i in enumerate(uniq):
        c = cum[i - 1]
        tp = n_true - c
        fp = n - i - tp
        fn = c + hard_fn
        precision[r] = tp / max(tp + fp, 1e-12)
        recall[r] = tp / max(tp + fn, 1e-12)
    precision[-1] = 1.0
    recall[-1] = 0.0
    rc = np.concatenate([[recall[0]], recall, [0.0]])
    step = np.convolve(rc, [-0.5, 0, 0.5], "valid")
    return float(np.dot(precision, step))


def evaluate_matches(
    scenes: List[Dict[int, SceneClassRecord]],
    num_classes: int,
    class_names: Sequence[str],
    segment_ignore_index: Sequence[int] = (-1,),
    overlaps: np.ndarray = OVERLAPS,
    min_region_size: int = MIN_REGION_SIZE,
) -> dict:
    """Greedy-match predictions to GTs per overlap threshold and compute the
    per-class AP table (reference l.349-546). Returns the ap_scores dict
    (all_ap / all_ap_50% / all_ap_25% / per-class)."""
    valid = [c for c in range(num_classes) if c not in segment_ignore_index]
    ap_table = np.zeros((len(valid), len(overlaps)))
    for oi, th in enumerate(overlaps):
        for li, cls in enumerate(valid):
            y_true, y_score = [], []
            hard_fn = 0
            has_gt = has_pred = False
            for scene in scenes:
                rec = scene.get(cls)
                if rec is None:
                    continue
                gt_valid = rec.gt_counts >= min_region_size
                G, P = rec.gt_counts.shape[0], rec.pred_conf.shape[0]
                if gt_valid.any():
                    has_gt = True
                if P:
                    has_pred = True
                visited = np.zeros(P, bool)
                matched_pred = np.zeros(P, bool)
                # greedy per-gt matching (reference l.394-427)
                for g in np.where(gt_valid)[0]:
                    cur_score = -np.inf
                    cur_match = False
                    for p in range(P):
                        if visited[p] or rec.inter[p, g] <= 0:
                            continue
                        ov = rec.inter[p, g] / (
                            rec.gt_counts[g] + rec.pred_counts[p] - rec.inter[p, g]
                        )
                        if ov <= th:
                            continue
                        conf = rec.pred_conf[p]
                        if cur_match:
                            # duplicate: lower score becomes an FP
                            y_true.append(0)
                            y_score.append(min(cur_score, conf))
                            cur_score = max(cur_score, conf)
                        else:
                            cur_match = True
                            cur_score = conf
                            visited[p] = True
                            matched_pred[p] = True
                    if cur_match:
                        y_true.append(1)
                        y_score.append(cur_score)
                    else:
                        hard_fn += 1
                # unmatched predictions (reference l.429-460)
                for p in range(P):
                    found_gt = False
                    for g in range(G):
                        if rec.inter[p, g] <= 0:
                            continue
                        ov = rec.inter[p, g] / (
                            rec.gt_counts[g] + rec.pred_counts[p] - rec.inter[p, g]
                        )
                        if ov > th:
                            found_gt = True
                            break
                    if found_gt:
                        continue
                    num_ignore = rec.pred_void[p] + int(
                        rec.inter[p, ~gt_valid].sum()
                    )
                    if num_ignore / max(rec.pred_counts[p], 1) <= th:
                        y_true.append(0)
                        y_score.append(rec.pred_conf[p])
            if has_gt and has_pred:
                ap = _average_precision(
                    np.asarray(y_true, float), np.asarray(y_score, float), hard_fn
                )
            elif has_gt:
                ap = 0.0
            else:
                ap = float("nan")
            ap_table[li, oi] = ap

    o50 = np.isclose(overlaps, 0.5)
    o25 = np.isclose(overlaps, 0.25)
    scores = dict(
        all_ap=float(np.nanmean(ap_table[:, ~o25])),
        **{
            "all_ap_50%": float(np.nanmean(ap_table[:, o50])),
            "all_ap_25%": float(np.nanmean(ap_table[:, o25])),
        },
        classes={},
    )
    names = [class_names[c] for c in valid]
    for li, name in enumerate(names):
        scores["classes"][name] = {
            "ap": float(np.average(ap_table[li, ~o25])),
            "ap50%": float(np.average(ap_table[li, o50])),
            "ap25%": float(np.average(ap_table[li, o25])),
        }
    return scores
