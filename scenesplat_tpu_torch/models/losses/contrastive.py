"""Class-aggregated contrastive loss for VL pretraining (counterpart of
``scenesplat_tpu/models/losses/contrastive.py``).

For every semantic class of the batch, the valid Gaussians are split into
two groups, each group's predicted features are summed and L2-normalized,
and a symmetric InfoNCE runs over classes. The JAX package's fixed-shape
form is kept: the split is an i.i.d. Bernoulli(0.5) draw per point, classes
go into a static ``num_classes`` table, classes with fewer than
``min_samples`` points (or an empty group) are masked out of both
directions, and ``schedule="last_<p>"`` gates the term on to the last p
percent of training (``epoch_progress``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .builder import LOSSES


@LOSSES.register_module()
class AggregatedContrastiveLoss:
    def __init__(self, temperature: float = 0.2, reduction: str = "mean",
                 loss_weight: float = 1.0, schedule: str = "all",
                 num_classes: int = 256, min_samples: int = 100):
        self.temperature = temperature
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.schedule = schedule
        self.num_classes = num_classes
        self.min_samples = min_samples
        self.last_percent = (float(schedule.split("_")[-1]) / 100.0
                             if schedule.startswith("last_") else None)

    def __call__(self, pred, target, valid_feat_mask=None, mask=None, segment=None,
                 epoch_progress=None, generator=None, split=None, **kwargs):
        """``split`` (bool, one per point: True = group a) fixes the
        Bernoulli split; otherwise it is drawn from ``generator``."""
        if self.schedule == "skip" or segment is None:
            return pred.new_zeros((), dtype=torch.float32)
        c = self.num_classes
        pf = pred.float().reshape(-1, pred.shape[-1])
        seg = segment.reshape(-1).long()
        valid = seg >= 0
        if valid_feat_mask is not None:
            valid = valid & valid_feat_mask.reshape(-1).bool()
        if mask is not None:
            valid = valid & mask.reshape(-1)
        valid = valid & (seg < c)
        seg_safe = torch.where(valid, seg, c)  # c = discard bin
        if split is not None:
            in_a = split.reshape(-1).bool()
        elif generator is not None:
            in_a = torch.rand(seg.shape, generator=generator, device=seg.device) < 0.5
        else:
            raise ValueError("AggregatedContrastiveLoss needs a split or a torch.Generator")

        w_a = (valid & in_a).float()
        w_b = (valid & ~in_a).float()

        def seg_sum(x):
            out = x.new_zeros((c + 1,) + x.shape[1:])
            return out.index_add_(0, seg_safe, x)[:c]

        agg_a, agg_b = seg_sum(pf * w_a[:, None]), seg_sum(pf * w_b[:, None])
        cnt_a, cnt_b = seg_sum(w_a), seg_sum(w_b)
        used = (cnt_a + cnt_b >= self.min_samples) & (cnt_a > 0) & (cnt_b > 0)
        n_used = used.sum()
        agg_a = agg_a / agg_a.norm(dim=-1, keepdim=True).clamp(min=1e-12)
        agg_b = agg_b / agg_b.norm(dim=-1, keepdim=True).clamp(min=1e-12)

        logits = (agg_a @ agg_b.T) / self.temperature  # [C, C]
        col_bias = torch.where(used, 0.0, -1e9)[None, :]

        def masked_ce(lg):
            # unused columns leave the softmax; unused rows leave the average
            logp = F.log_softmax(lg + col_bias, dim=-1)
            return -(logp.diagonal() * used).sum() / n_used.clamp(min=1)

        loss = 0.5 * (masked_ce(logits) + masked_ce(logits.T))
        loss = torch.where(n_used > 0, loss, 0.0)
        if self.reduction == "sum":
            loss = loss * n_used
        if self.last_percent is not None and epoch_progress is not None:
            if float(epoch_progress) <= 1.0 - self.last_percent:
                loss = loss * 0.0
        return self.loss_weight * loss
