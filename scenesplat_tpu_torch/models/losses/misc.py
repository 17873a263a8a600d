"""Mask-aware losses for padded batches (counterpart of
``scenesplat_tpu/models/losses/misc.py``: CrossEntropyLoss,
CosineSimilarity, L2Loss). All compute in fp32 whatever the prediction's
dtype. A masked mean is over the valid points of the global batch: under
data parallel its sum and its count add up over the processes."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from scenesplat_tpu_torch.ops.segops import at_least_fp32
from scenesplat_tpu_torch.parallel.dist import all_reduce_sum

from .builder import LOSSES


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    total, count = all_reduce_sum(torch.stack([(values * m).sum(), m.sum()]))
    return total / count.clamp(min=1.0)


def _valid(shape, valid_feat_mask, mask, device):
    valid = torch.ones(shape, dtype=torch.bool, device=device)
    if valid_feat_mask is not None:
        valid = valid & valid_feat_mask.bool()
    if mask is not None:
        valid = valid & mask
    return valid


@LOSSES.register_module()
class CosineSimilarity:
    """1 - cos(pred, target) over valid features, the primary VL loss."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, valid_feat_mask=None, mask=None, **kwargs):
        pf, tf = pred.float(), target.float()
        cos = (pf * tf).sum(-1) / (pf.norm(dim=-1) * tf.norm(dim=-1) + 1e-8)
        loss = 1.0 - cos
        valid = _valid(loss.shape, valid_feat_mask, mask, loss.device)
        out = _masked_mean(loss, valid) if self.reduction == "mean" else (loss * valid).sum()
        return self.loss_weight * out


@LOSSES.register_module()
class L2Loss:
    """Per-point squared error summed over channels, averaged over valid
    points."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, valid_feat_mask=None, mask=None, **kwargs):
        err = ((pred.float() - target.float()) ** 2).sum(-1)
        valid = _valid(err.shape, valid_feat_mask, mask, err.device)
        out = _masked_mean(err, valid) if self.reduction == "mean" else (err * valid).sum()
        return self.loss_weight * out


@LOSSES.register_module()
class CrossEntropyLoss:
    """Cross-entropy over the points that are valid (``mask``) and not
    ``ignore_index``. With ``weight`` (one per class) the loss is the
    weighted sum over those points divided by the sum of their weights,
    both over the global batch;
    ``label_smoothing`` mixes the one-hot target with the uniform one."""

    def __init__(self, weight: Optional[Sequence[float]] = None, reduction: str = "mean",
                 label_smoothing: float = 0.0, loss_weight: float = 1.0,
                 ignore_index: int = -1):
        self.weight = None if weight is None else torch.as_tensor(weight, dtype=torch.float32)
        self.reduction = reduction
        self.label_smoothing = label_smoothing
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None, **kwargs):
        num_classes = pred.shape[-1]
        valid = target != self.ignore_index
        if mask is not None:
            valid = valid & mask
        logp = F.log_softmax(at_least_fp32(pred), dim=-1)
        safe_t = target.long().clamp(0, num_classes - 1)
        if self.label_smoothing > 0:
            off = self.label_smoothing / num_classes
            one_hot = F.one_hot(safe_t, num_classes).float()
            tgt = one_hot * (1.0 - self.label_smoothing + off) + (1.0 - one_hot) * off
            nll = -(tgt * logp).sum(-1)
        else:
            nll = -logp.gather(-1, safe_t[..., None])[..., 0]
        if self.weight is not None:
            w = self.weight.to(nll.device)[safe_t] * valid
            total, weight = all_reduce_sum(torch.stack([(nll * w).sum(), w.sum()]))
            loss = total / weight.clamp(min=1e-12)
        elif self.reduction == "mean":
            loss = _masked_mean(nll, valid)
        else:
            loss = (nll * valid).sum()
        return self.loss_weight * loss
