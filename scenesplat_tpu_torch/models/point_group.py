"""PointGroup instance segmentation, PG-v1m1 (counterpart of
``scenesplat_tpu/models/point_group.py``; reference
point_group_v1m1_base.py:23-178).

The model is a backbone (any registered one) with a semantic head and a
centre-bias head; ``pointgroup_loss`` is the reference's three training
terms; ``proposals_from_predictions`` is its evaluation branch: the
points of the kept classes shifted by their predicted bias, clustered
(``ops/cluster.py:pointgroup_cluster``, on the predictions' device), and
each cluster of more than ``cluster_propose_points`` points a proposal
with its class and mean class probability.

State-dict names are the reference's: ``backbone.*``, ``bias_head.{0,1,3}``
(Linear, BatchNorm1d(eps 1e-3, momentum 0.01), ReLU, Linear(3)) and
``seg_head``. Without ``criteria`` in the model config the semantic term is
the reference's own cross-entropy with ``semantic_ignore_index``: the JAX
package's loss adds the empty criteria's input, the logits themselves, and
is then no scalar (ROADMAP Queue 3)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.cluster import pointgroup_cluster
from scenesplat_tpu_torch.parallel.dist import all_reduce_sum

from .builder import MODELS, build_model
from .losses.misc import CrossEntropyLoss
from .norm import MaskedBatchNorm
from .ptv3 import Linear
from .structure import PointBatch


@MODELS.register_module("PG-v1m1")
class PointGroup(nn.Module):
    """Backbone with the seg and bias heads (reference
    point_group_v1m1_base.py:23-58). The heads compute in fp32; their
    parameters are drawn from the backbone's ``seed`` + 1. The ``cluster_*``
    and ``voxel_size`` settings are the evaluator's: InsSegEvaluator reads
    them from the model config, as the JAX hook does
    (``cluster_closed_points`` goes unused, as in the JAX op)."""

    def __init__(self, backbone: dict, backbone_out_channels: int = 64,
                 semantic_num_classes: int = 20, semantic_ignore_index: int = -1,
                 segment_ignore_index: Sequence[int] = (-1, 0, 1),
                 instance_ignore_index: int = -1, cluster_thresh: float = 1.5,
                 cluster_closed_points: int = 300, cluster_propose_points: int = 100,
                 cluster_min_points: int = 50, voxel_size: float = 0.02):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        c = backbone_out_channels
        self.semantic_ignore_index = semantic_ignore_index
        self.instance_ignore_index = instance_ignore_index
        self.bias_head = nn.ModuleList([Linear(c, c), MaskedBatchNorm(c), nn.ReLU(),
                                        Linear(c, 3)])
        self.seg_head = Linear(c, semantic_num_classes)
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        for lin in (self.bias_head[0], self.bias_head[3], self.seg_head):
            lin.reset_parameters(gen)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None,
                **kwargs):
        """Returns (the backbone output with the logits as ``feat``, the
        bias [B, N, 3])."""
        out = self.backbone(point, generator=generator, **kwargs)
        x = self.bias_head[0](out.feat)
        x = F.relu(self.bias_head[1](x, out.mask))
        return out.replace(feat=self.seg_head(out.feat)), self.bias_head[3](x)


def pointgroup_loss(logits: torch.Tensor, bias_pred: torch.Tensor, coord: torch.Tensor,
                    segment: torch.Tensor, instance: torch.Tensor,
                    instance_centroid: torch.Tensor, mask: torch.Tensor, criteria=None,
                    semantic_ignore_index: int = -1, instance_ignore_index: int = -1):
    """CE + bias L1 + bias cosine (reference point_group_v1m1_base.py:72-95),
    fp32. Returns (total, dict of the three terms). ``criteria`` (a
    ``Criteria`` with losses) gives the semantic term; without one, it is
    CrossEntropyLoss(ignore_index=``semantic_ignore_index``). The bias terms
    are means over the valid points with an instance; under data parallel
    every mean spans the global batch."""
    if criteria is None or not getattr(criteria, "criteria", True):
        criteria = CrossEntropyLoss(ignore_index=semantic_ignore_index)
    seg_loss = criteria(logits, segment, mask=mask)
    w = ((instance != instance_ignore_index) & mask).float()
    bias_gt = instance_centroid.float() - coord.float()
    bp = bias_pred.float()
    l1 = (bp - bias_gt).abs().sum(-1)
    bp_n = bp / (torch.linalg.vector_norm(bp, dim=-1, keepdim=True) + 1e-8)
    gt_n = bias_gt / (torch.linalg.vector_norm(bias_gt, dim=-1, keepdim=True) + 1e-8)
    cos = -(bp_n * gt_n).sum(-1)
    l1_sum, cos_sum, count = all_reduce_sum(torch.stack([(l1 * w).sum(), (cos * w).sum(),
                                                         w.sum()]))
    denom = count + 1e-8
    terms = dict(seg_loss=seg_loss, bias_l1_loss=l1_sum / denom,
                 bias_cosine_loss=cos_sum / denom)
    return terms["seg_loss"] + terms["bias_l1_loss"] + terms["bias_cosine_loss"], terms


def _empty(n: int) -> Dict[str, np.ndarray]:
    return dict(pred_masks=np.zeros((0, n), bool), pred_classes=np.zeros(0, np.int32),
                pred_scores=np.zeros(0, np.float32))


def proposals_from_predictions(coord, logits, bias_pred, segment_ignore_index=(-1, 0, 1),
                               cluster_thresh: float = 1.5, cluster_propose_points: int = 100,
                               cluster_min_points: int = 50, voxel_size: float = 0.02,
                               device=None) -> Dict[str, np.ndarray]:
    """The reference's evaluation branch (l.97-178) on one scene's valid
    points: coord [N, 3], logits [N, C], bias_pred [N, 3] (tensors or numpy
    arrays), computed on ``device`` (the tensors' by default). Returns numpy
    pred_masks [P, N] bool, pred_classes [P] int32 and pred_scores [P]
    float32, the proposals in the clusters' order."""
    def tensor(x):
        t = torch.as_tensor(x)
        return t.to(device) if device is not None else t

    coord, logits, bias_pred = tensor(coord).float(), tensor(logits), tensor(bias_pred).float()
    n = coord.shape[0]
    prob = torch.softmax(logits.float(), -1)
    segment_pred = prob.argmax(-1)
    ignore = torch.as_tensor(tuple(segment_ignore_index), device=segment_pred.device)
    keep_idx = torch.nonzero(~torch.isin(segment_pred, ignore)).squeeze(1)
    if keep_idx.numel() == 0:
        return _empty(n)
    centers = coord[keep_idx] + bias_pred[keep_idx]
    centers = centers / torch.full_like(centers, voxel_size)
    labels = segment_pred[keep_idx]
    cluster, num = pointgroup_cluster(centers, labels, cluster_thresh, cluster_min_points)
    members = cluster >= 0
    size = torch.bincount(cluster[members], minlength=num)
    chosen = size > cluster_propose_points
    if not chosen.any():
        return _empty(n)
    rank = torch.cumsum(chosen, 0) - 1
    sel = members.clone()
    sel[members] = chosen[cluster[members]]
    pid, point = rank[cluster[sel]], keep_idx[sel]
    n_prop = int(chosen.sum())
    masks = torch.zeros(n_prop, n, dtype=torch.bool, device=coord.device)
    masks[pid, point] = True
    # a cluster's points share one label; its class is its first point's
    classes = torch.zeros(n_prop, dtype=torch.int64, device=coord.device)
    classes[pid] = labels[sel]
    score_sum = torch.zeros(n_prop, dtype=torch.float32, device=coord.device).index_add_(
        0, pid, prob[point, classes[pid]])
    scores = score_sum / size[chosen].float()
    return dict(pred_masks=masks.cpu().numpy(), pred_classes=classes.int().cpu().numpy(),
                pred_scores=scores.cpu().numpy())
