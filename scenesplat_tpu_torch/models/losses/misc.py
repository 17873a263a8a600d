"""Mask-aware feature losses for padded batches (counterpart of
``scenesplat_tpu/models/losses/misc.py``: CosineSimilarity, L2Loss).
Both compute in fp32 whatever the prediction's dtype."""

from __future__ import annotations

import torch

from .builder import LOSSES


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(values.dtype)
    return (values * m).sum() / m.sum().clamp(min=1.0)


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
