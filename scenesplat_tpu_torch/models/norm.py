"""Mask-aware normalization layers (counterpart of
``scenesplat_tpu/models/norm.py``).

Both compute in fp32 whatever the input dtype and return the module's
compute dtype. Parameter and buffer names follow torch's BatchNorm1d and
LayerNorm so reference checkpoints load as they are. Both go through
torch's fused norms, which keep one fp32 copy of the input for the
backward (a norm written out op by op keeps three to five, several GB per
norm at the flagship dec0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid points of a [B, N, C] buffer.

    Eval uses the running statistics. Training normalizes with the masked
    batch moments (biased variance) and updates the running statistics
    torch's way: running = (1 - m) * running + m * batch, with the unbiased
    variance (eps 1e-3 and momentum 0.01 as PTv3 sets them)."""

    def __init__(self, features: int, eps: float = 1e-3, momentum: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            # batch moments of the valid points; padding rows come out as
            # zeros (every consumer masks them: attention keys, conv
            # neighbours, pooling's discard bin, the losses)
            valid = F.batch_norm(xf[mask], self.running_mean, self.running_var,
                                 self.weight, self.bias, training=True,
                                 momentum=self.momentum, eps=self.eps)
            self.num_batches_tracked.add_(1)
            y = xf.new_zeros(xf.shape).index_put((mask,), valid)
        else:
            y = F.batch_norm(xf.reshape(-1, xf.shape[-1]), self.running_mean,
                             self.running_var, self.weight, self.bias, training=False,
                             eps=self.eps).view(xf.shape)
        return y.to(self.dtype)


class LayerNorm(nn.Module):
    """Per-point LayerNorm (eps 1e-5); padding-agnostic."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)
