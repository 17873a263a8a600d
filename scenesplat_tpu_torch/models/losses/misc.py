"""Mask-aware losses for padded batches (counterpart of
``scenesplat_tpu/models/losses/misc.py``: CrossEntropyLoss,
CosineSimilarity, L2Loss, SmoothCELoss, FocalLoss, BinaryFocalLoss,
DiceLoss, L1Loss). All compute in fp32 whatever the prediction's dtype (a
float64 one in float64). A masked mean is over the valid points of the
global batch: under data parallel its sum and its count add up over the
processes, as do the focal loss's count and the dice loss's per-class
sums."""

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


def _smooth_one_hot(target: torch.Tensor, num_classes: int, smoothing: float) -> torch.Tensor:
    """One-hot targets (labels clamped into range) mixed with the uniform
    one: 1 - smoothing + smoothing / C on, smoothing / C off."""
    one_hot = F.one_hot(target.long().clamp(0, num_classes - 1), num_classes).float()
    off = smoothing / num_classes
    return one_hot * (1.0 - smoothing + off) + (1.0 - one_hot) * off


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
            tgt = _smooth_one_hot(safe_t, num_classes, self.label_smoothing)
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


def _not_ignored(target, mask, ignore_index):
    valid = target != ignore_index
    return valid if mask is None else valid & mask


def _bce_with_logits(pred, target):
    """Binary cross-entropy on logits, in its stable form."""
    return pred.clamp(min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))


@LOSSES.register_module()
class SmoothCELoss:
    """Label-smoothed cross-entropy over the points that are valid and not
    ``ignore_index`` (the reference's ``.total`` call, which raises, is the
    mean the JAX package takes)."""

    def __init__(self, smoothing_ratio: float = 0.1, loss_weight: float = 1.0,
                 ignore_index: int = -1):
        self.smoothing_ratio = smoothing_ratio
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None, **kwargs):
        valid = _not_ignored(target, mask, self.ignore_index)
        pred = at_least_fp32(pred)
        tgt = _smooth_one_hot(target, pred.shape[-1], self.smoothing_ratio).to(pred.dtype)
        nll = -(tgt * F.log_softmax(pred, dim=-1)).sum(-1)
        return self.loss_weight * _masked_mean(nll, valid)


@LOSSES.register_module()
class FocalLoss:
    """Sigmoid (one-vs-all) focal loss over one-hot targets: each valid
    point's C terms, alpha-weighted and scaled by (1 - p_t)^gamma; the mean
    over the [points, C] elements of the valid points, or their sum."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.5, reduction: str = "mean",
                 loss_weight: float = 1.0, ignore_index: int = -1):
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None, **kwargs):
        num_classes = pred.shape[-1]
        valid = _not_ignored(target, mask, self.ignore_index).reshape(-1)
        pred = at_least_fp32(pred).reshape(-1, num_classes)
        t = F.one_hot(target.reshape(-1).long().clamp(0, num_classes - 1),
                      num_classes).to(pred.dtype)
        p = torch.sigmoid(pred)
        one_minus_pt = (1 - p) * t + p * (1 - t)
        focal_w = (self.alpha * t + (1 - self.alpha) * (1 - t)) * one_minus_pt ** self.gamma
        per_el = _bce_with_logits(pred, t) * focal_w * valid[:, None]
        if self.reduction != "mean":
            return self.loss_weight * per_el.sum()
        total, count = all_reduce_sum(torch.stack([per_el.sum(),
                                                   valid.sum().to(pred.dtype) * num_classes]))
        return self.loss_weight * total / count.clamp(min=1.0)


@LOSSES.register_module()
class BinaryFocalLoss:
    """Binary focal loss on logits (on probabilities with ``logits=False``)
    against targets in [0, 1]: alpha-weighted BCE scaled by (1 - p_t)^gamma,
    the masked mean of the elements (``mask`` shaped like them), or their
    sum."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.25, logits: bool = True,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.gamma = gamma
        self.alpha = alpha
        self.logits = logits
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None, **kwargs):
        pred = at_least_fp32(pred)
        target = target.to(pred.dtype)
        if self.logits:
            p = torch.sigmoid(pred)
            bce = _bce_with_logits(pred, target)
        else:
            p = pred
            bce = -(target * torch.log(p + 1e-12) + (1 - target) * torch.log(1 - p + 1e-12))
        pt = p * target + (1 - p) * (1 - target)
        at = self.alpha * target + (1 - self.alpha) * (1 - target)
        focal = at * (1 - pt) ** self.gamma * bce
        valid = torch.ones_like(focal, dtype=torch.bool) if mask is None else mask
        if self.reduction == "mean":
            return self.loss_weight * _masked_mean(focal, valid)
        return self.loss_weight * (focal * valid).sum()


@LOSSES.register_module()
class DiceLoss:
    """Soft dice over the classes: softmax probabilities against one-hot
    targets over the valid, not ignored points; each class but
    ``ignore_index`` adds 1 - (2 sum(p t) + smooth) / (sum(p^e + t^e) +
    smooth), and the sum is divided by the number of classes."""

    def __init__(self, smooth: float = 1.0, exponent: float = 2.0, loss_weight: float = 1.0,
                 ignore_index: int = -1):
        self.smooth = smooth
        self.exponent = exponent
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None, **kwargs):
        num_classes = pred.shape[-1]
        valid = _not_ignored(target, mask, self.ignore_index)[..., None]
        pred = at_least_fp32(pred)
        prob = F.softmax(pred, dim=-1) * valid
        oh = F.one_hot(target.long().clamp(0, num_classes - 1),
                       num_classes).to(pred.dtype) * valid
        dims = tuple(range(prob.dim() - 1))
        sums = all_reduce_sum(torch.stack([
            (prob * oh).sum(dims), (prob ** self.exponent + oh ** self.exponent).sum(dims)]))
        per_class = 1 - (sums[0] * 2 + self.smooth) / (sums[1] + self.smooth)
        keep = torch.arange(num_classes, device=pred.device) != self.ignore_index
        return self.loss_weight * (per_class * keep).sum() / num_classes


@LOSSES.register_module()
class L1Loss:
    """Absolute error: the masked mean (a ``mask`` of fewer axes than the
    error counts its points, not their channels, as the JAX loss does), or
    the sum."""

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, mask=None, **kwargs):
        err = (at_least_fp32(pred) - at_least_fp32(target)).abs()
        if mask is None:
            valid = torch.ones_like(err, dtype=torch.bool)
        else:
            valid = mask[..., None] if mask.dim() < err.dim() else mask
        if self.reduction == "mean":
            return self.loss_weight * _masked_mean(err, valid)
        return self.loss_weight * (err * valid).sum()
