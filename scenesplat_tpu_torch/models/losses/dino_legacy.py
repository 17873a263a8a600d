"""The legacy DINOv2 losses (counterpart of
``scenesplat_tpu/models/losses/dino_legacy.py``): the class-token
``DINOLoss``, the masked-patch ``iBOTPatchLoss`` and the Sinkhorn-Knopp
teacher assignment. The shipped SSL files use SimDINO's MCR and cosine
losses instead; these are kept for the reference's older recipes.

Each loss keeps its teacher centre in a registered buffer, updated by an
exponential moving average under ``no_grad`` after the loss is taken with
the old centre. Every mean spans the global batch: under data parallel
its sums and counts add up over the processes (``parallel/dist.py``), so
the loss, its gradient's sum over processes and the centre are what one
process computes over the whole batch (the JAX package's ``pmean`` of the
batch centre over its data mesh, with equal rows on each process).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import at_least_fp32
from scenesplat_tpu_torch.parallel.dist import all_reduce_sum


def _global_sum_and_count(total: torch.Tensor, count) -> torch.Tensor:
    """[sum over the processes of ``total``, of ``count``], one all_reduce."""
    return all_reduce_sum(torch.stack([total, total.new_tensor(float(count))]))


def sinkhorn_knopp_teacher(teacher_output: torch.Tensor, teacher_temp: float,
                           n_iterations: int = 3) -> torch.Tensor:
    """Sinkhorn-Knopp assignment of teacher logits [B, K] over the global
    batch: a fixed ``n_iterations`` of row and column normalizations, the
    rows summed over the processes; returns [B, K], each row summing to 1."""
    q = torch.exp(at_least_fp32(teacher_output) / teacher_temp).t()  # [K, B]
    k = q.shape[0]
    sum_q, b = _global_sum_and_count(q.sum(), q.shape[1])
    q = q / sum_q
    for _ in range(n_iterations):
        q = q / all_reduce_sum(q.sum(1, keepdim=True)) / k
        q = q / q.sum(0, keepdim=True) / b
    return (q * b).t()


class DINOLoss(nn.Module):
    """Class-token distillation: the cross-entropy of every student view's
    log-softmax (temperature ``student_temp``) against every teacher view's
    centred softmax (``teacher_temp``), summed over the pairs, each the
    mean over the global batch's rows; the teacher takes no gradient. With
    ``update_center`` the centre moves towards the teacher logits' mean
    over the global batch by ``1 - center_momentum``."""

    def __init__(self, out_dim: int, student_temp: float = 0.1,
                 center_momentum: float = 0.9):
        super().__init__()
        self.student_temp = student_temp
        self.center_momentum = center_momentum
        self.register_buffer("center", torch.zeros(1, out_dim))

    sinkhorn_knopp_teacher = staticmethod(sinkhorn_knopp_teacher)

    def forward(self, student_outputs: Sequence[torch.Tensor],
                teacher_outputs: Sequence[torch.Tensor], teacher_temp: float,
                update_center: bool = True) -> torch.Tensor:
        teacher_sm = [F.softmax((at_least_fp32(t) - self.center) / teacher_temp, dim=-1).detach()
                      for t in teacher_outputs]
        total = 0.0
        for s in student_outputs:
            lsm = F.log_softmax(at_least_fp32(s) / self.student_temp, dim=-1)
            for t in teacher_sm:
                ce, rows = _global_sum_and_count((t * lsm).sum(-1).sum(), s.shape[0])
                total = total - ce / rows
        if update_center:
            with torch.no_grad():
                batch = torch.cat([at_least_fp32(t) for t in teacher_outputs])
                sums = all_reduce_sum(torch.cat([batch.sum(0), batch.new_tensor([len(batch)])]))
                batch_center = (sums[:-1] / sums[-1])[None].to(self.center.dtype)
                self.center.mul_(self.center_momentum).add_(
                    batch_center * (1 - self.center_momentum))
        return total


class iBOTPatchLoss(nn.Module):
    """Masked-patch distillation on padded token logits [B, N, K]: each
    token's cross-entropy of the student against the centred teacher,
    averaged over the sample's masked (predicted) tokens, the count
    clamped at 1 (a sample with none adds 0), then the mean over the global
    batch's samples. With ``update_center`` the centre [1, 1, K] moves
    towards the teacher logits' mean over the global batch's masked tokens
    (the count clamped at 1)."""

    def __init__(self, patch_out_dim: int, student_temp: float = 0.1,
                 center_momentum: float = 0.9):
        super().__init__()
        self.student_temp = student_temp
        self.center_momentum = center_momentum
        self.register_buffer("center", torch.zeros(1, 1, patch_out_dim))

    def forward(self, student_patches: torch.Tensor, teacher_patches: torch.Tensor,
                masks: torch.Tensor, teacher_temp: float,
                update_center: bool = True) -> torch.Tensor:
        teacher = at_least_fp32(teacher_patches)
        t = F.softmax((teacher - self.center) / teacher_temp, dim=-1).detach()
        lsm = F.log_softmax(at_least_fp32(student_patches) / self.student_temp, dim=-1)
        loss_tok = -(t * lsm).sum(-1)  # [B, N]
        w = masks.to(loss_tok.dtype)
        per_sample = (loss_tok * w).sum(-1) / w.sum(-1).clamp(min=1.0)
        total, samples = _global_sum_and_count(per_sample.sum(), per_sample.shape[0])
        if update_center:
            with torch.no_grad():
                sums = all_reduce_sum(torch.cat([(teacher * w[..., None]).sum((0, 1)),
                                                 w.sum()[None]]))
                batch_center = (sums[:-1] / sums[-1].clamp(min=1.0)).view(1, 1, -1)
                self.center.mul_(self.center_momentum).add_(
                    batch_center.to(self.center.dtype) * (1 - self.center_momentum))
        return total / samples
