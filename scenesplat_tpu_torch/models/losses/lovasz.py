"""Lovasz-softmax loss over padded batches (counterpart of
``scenesplat_tpu/models/losses/lovasz.py``).

Every class is done at once on a [C, N] tensor: each class's errors
|fg - p| are sorted in descending order with a stable sort, invalid and
ignored points carry -inf so they sort last, and the dot product with the
Lovasz gradient stops at the valid count. A stable sort keeps tied errors in
point order, as ``jnp.argsort(-errors)`` does, so the gradients reach the
same points. The loss averages over the classes present in the batch.
"""

from __future__ import annotations

import torch

from .builder import LOSSES


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovasz extension with respect to each row's sorted
    errors ([C, P] floats)."""
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(-1)
    union = gts + (1.0 - gt_sorted).cumsum(-1)
    jaccard = 1.0 - intersection / union.clamp(min=1e-12)
    return torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=-1)


@LOSSES.register_module()
class LovaszLoss:
    def __init__(self, mode: str = "multiclass", loss_weight: float = 1.0,
                 ignore_index: int = -1):
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"mode {mode!r} is not multiclass or binary")
        self.mode = mode
        self.loss_weight = loss_weight
        self.ignore_index = ignore_index

    def __call__(self, pred, target, mask=None, **kwargs):
        num_classes = pred.shape[-1]
        logits = pred.reshape(-1, num_classes).float()
        labels = target.reshape(-1)
        valid = labels != self.ignore_index
        if mask is not None:
            valid = valid & mask.reshape(-1)
        probs = torch.softmax(logits, dim=-1)
        classes = torch.arange(num_classes, device=labels.device)
        fg = ((labels[None, :] == classes[:, None]) & valid[None, :]).float()  # [C, N]
        present = fg.sum(-1) > 0
        errors = torch.where(valid[None, :], (fg - probs.T).abs(), float("-inf"))
        errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
        grad = _lovasz_grad(fg.gather(-1, order))
        in_valid = torch.arange(labels.shape[0], device=labels.device) < valid.sum()
        losses = torch.where(in_valid[None, :], errors_sorted.clamp(min=0.0) * grad, 0.0).sum(-1)
        loss = torch.where(present, losses, 0.0).sum() / present.sum().clamp(min=1)
        return self.loss_weight * loss
