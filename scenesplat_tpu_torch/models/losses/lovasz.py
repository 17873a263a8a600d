"""Lovasz-softmax loss over padded batches (counterpart of
``scenesplat_tpu/models/losses/lovasz.py``).

Every class is done at once on a [C, N] tensor: each class's errors
|fg - p| are sorted in descending order with a stable sort, invalid and
ignored points carry -inf so they sort last, and the dot product with the
Lovasz gradient stops at the valid count. A stable sort keeps tied errors in
point order, as ``jnp.argsort(-errors)`` does, so the gradients reach the
same points. The loss averages over the classes present in the batch.

Under data parallel the batch is the global one, as the JAX function sorts
it: every process gathers every process's probabilities and labels in rank
order (``parallel/dist.py:all_gather_rows``), computes the loss of the
whole batch, and keeps through the gather's backward its own rows' share
of the gradient, as with ``all_reduce_sum``. A gathered [C, N_global] sort
on every process is the cost.
"""

from __future__ import annotations

import torch

from scenesplat_tpu_torch.ops.segops import at_least_fp32
from scenesplat_tpu_torch.parallel.dist import all_gather_rows, world

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
        logits = at_least_fp32(pred.reshape(-1, num_classes))
        labels = target.reshape(-1)
        valid = labels != self.ignore_index
        if mask is not None:
            valid = valid & mask.reshape(-1)
        probs = torch.softmax(logits, dim=-1)
        if world() > 1:
            # the global batch's points in rank order, the one process's order:
            # probabilities and labels (-1 where invalid) in one gather
            rows = all_gather_rows(torch.cat(
                [probs, torch.where(valid, labels, -1).float()[:, None]], 1), fill=-1.0)
            probs, labels = rows[:, :-1], rows[:, -1].long()
            valid = labels >= 0
        return self.loss_weight * _lovasz_softmax(probs, labels, valid)


def _lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """The multiclass loss of probabilities [N, C] against ``labels`` [N] at
    the ``valid`` points."""
    num_classes = probs.shape[-1]
    classes = torch.arange(num_classes, device=labels.device)
    fg = ((labels[None, :] == classes[:, None]) & valid[None, :]).float()  # [C, N]
    present = fg.sum(-1) > 0
    errors = torch.where(valid[None, :], (fg - probs.T).abs(), float("-inf"))
    errors_sorted, order = torch.sort(errors, dim=-1, descending=True, stable=True)
    grad = _lovasz_grad(fg.gather(-1, order))
    in_valid = torch.arange(labels.shape[0], device=labels.device) < valid.sum()
    losses = torch.where(in_valid[None, :], errors_sorted.clamp(min=0.0) * grad, 0.0).sum(-1)
    return torch.where(present, losses, 0.0).sum() / present.sum().clamp(min=1)
