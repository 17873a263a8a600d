"""Mask-aware normalization layers (counterpart of
``scenesplat_tpu/models/norm.py``).

Both compute in fp32 whatever the input dtype (float64 in float64) and
return the module's compute dtype. Parameter and buffer names follow torch's BatchNorm1d and
LayerNorm so reference checkpoints load as they are. Both go through
torch's fused norms, which keep one fp32 copy of the input for the
backward (a norm written out op by op keeps three to five, several GB per
norm at the flagship dec0). Under data parallel the BatchNorm moments are
those of the global batch (``_GlobalMaskedBatchNorm``), as in the JAX
package, whose step spans the whole batch; under tensor or context
parallel, the batch of the layout's points group (``parallel/dist.py``),
whose ranks hold distinct points.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import at_least_fp32
from scenesplat_tpu_torch.parallel.dist import all_reduce_, group_size


class _GlobalMaskedBatchNorm(torch.autograd.Function):
    """Training BatchNorm of the valid rows ``x`` [M, C] (fp32) of this
    process with the moments of every process's valid rows: the count and
    the sum, then the centred squares about the global mean, each summed
    over the processes (the JAX package's two passes, not E[x^2] - E[x]^2).
    Keeps one fp32 copy of the normalized rows for the backward, whose two
    per-channel sums are also summed over the processes (the sum of every
    process's loss copy is differentiated; see ``parallel/dist.py``).
    Returns (y, mean, biased variance, count)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        stats = torch.cat([x.sum(0), x.new_full((1,), x.shape[0])])
        all_reduce_(stats)
        count = stats[-1].clamp(min=1.0)
        mean = stats[:-1] / count
        xc = x - mean
        sq = (xc * xc).sum(0)
        all_reduce_(sq)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        xhat = xc.mul_(invstd)
        ctx.save_for_backward(xhat, invstd, weight, count)
        ctx.mark_non_differentiable(mean, var, count)
        return xhat * weight + bias, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        xhat, invstd, weight, count = ctx.saved_tensors
        dbias = dy.sum(0)
        dweight = (dy * xhat).sum(0)
        sums = torch.cat([dbias * weight, dweight * weight])
        all_reduce_(sums)
        c = weight.shape[0]
        dx = (dy * weight - sums[:c] / count - xhat * (sums[c:] / count)) * invstd
        return dx, dweight, dbias, None


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid points of a [B, N, C] buffer.

    Eval uses the running statistics, with no collective. Training
    normalizes with the masked batch moments (biased variance) and updates
    the running statistics torch's way: running = (1 - m) * running + m *
    batch, with the unbiased variance (eps 1e-3 and momentum 0.01 as PTv3
    sets them). Under data parallel the batch is the global one: the
    moments, the count of the unbiased factor and the gradients' sums span
    every process's rows."""

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
        xf = at_least_fp32(x)
        if self.training:
            # batch moments of the valid points; padding rows come out as
            # zeros (every consumer masks them: attention keys, conv
            # neighbours, pooling's discard bin, the losses)
            if group_size() > 1:
                valid = self._global(xf[mask])
            else:
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

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var, count = _GlobalMaskedBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(unbiased, self.momentum)
        return y


class _PointBatchNormFn(torch.autograd.Function):
    """Training BatchNorm of ``x`` [R, C] (fp32) with the moments of the
    rows where ``m`` [R] (fp32 0/1) is set, summed over the processes as in
    ``_GlobalMaskedBatchNorm``, that normalizes EVERY row (the JAX
    MaskedBatchNorm's arithmetic: a masked row's output is its value
    normalized by the valid rows' moments). Keeps one fp32 copy of the
    normalized rows. In the backward the masked rows' gradient is the
    direct term alone (the moments do not depend on them); the two
    per-channel sums run over every row. Returns (y, mean, biased
    variance, count)."""

    @staticmethod
    def forward(ctx, x, m, weight, bias, eps):
        # tree reductions (torch.sum), not a matrix-vector product: grouped
        # offsets through a linear give columns of mean far above their
        # spread, over millions of rows, where a GEMV's running fp32 sums
        # move the normalized values by 1e-3 between the card and the CPU
        mc = m[:, None]
        stats = torch.cat([(x * mc).sum(0), m.sum()[None]])
        all_reduce_(stats)
        count = stats[-1].clamp(min=1.0)
        mean = stats[:-1] / count
        xc = x - mean
        sq = (xc * xc * mc).sum(0)
        all_reduce_(sq)
        var = sq / count
        invstd = torch.rsqrt(var + eps)
        xhat = xc.mul_(invstd)
        ctx.save_for_backward(xhat, m, invstd, weight, count)
        ctx.mark_non_differentiable(mean, var, count)
        return xhat * weight + bias, mean, var, count

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar, _dcount):
        xhat, m, invstd, weight, count = ctx.saved_tensors
        dbias = dy.sum(0)
        dweight = (dy * xhat).sum(0)
        sums = torch.cat([dbias * weight, dweight * weight])
        all_reduce_(sums)
        c = weight.shape[0]
        centre = (sums[:c] + xhat * sums[c:]) / count
        dx = (dy * weight - m[:, None] * centre) * invstd
        return dx, None, dweight, dbias, None


class PointBatchNorm(MaskedBatchNorm):
    """The JAX MaskedBatchNorm's arithmetic on a [B, N, C] buffer: the
    moments of the valid rows normalize every row, padding included (the
    port's MaskedBatchNorm zeroes padding). Point Transformer V1 and V2
    need it: their grouped tensors keep invalid neighbour slots in the
    attention's softmax denominator, which reads those slots' normalized
    values. Running statistics, data parallel and eval as MaskedBatchNorm."""

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x, mask)
        shape = x.shape
        xf = at_least_fp32(x).reshape(-1, shape[-1])
        y, mean, var, count = _PointBatchNormFn.apply(
            xf, mask.reshape(-1).to(xf.dtype), self.weight, self.bias, self.eps)
        with torch.no_grad():
            unbiased = var * count / (count - 1.0).clamp(min=1.0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(unbiased, self.momentum)
        self.num_batches_tracked.add_(1)
        return y.view(shape).to(self.dtype)


class LayerNorm(nn.Module):
    """Per-point LayerNorm (eps 1e-5); padding-agnostic."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(at_least_fp32(x), (x.shape[-1],), self.weight, self.bias, self.eps)
        return y.to(self.dtype)


def condition_name(condition) -> str:
    """The one dataset condition of a batch: a name, or a sequence of
    names that must all be equal (one condition per batch, as the
    reference's PPT asserts)."""
    if isinstance(condition, str):
        return condition
    names = set(condition)
    if len(names) != 1:
        raise ValueError(f"one condition per batch, got {sorted(names)}")
    return names.pop()


class PDNorm(nn.Module):
    """Prompt-driven (dataset-conditioned) normalization: one LayerNorm or
    MaskedBatchNorm per condition (``decouple``; one shared norm
    otherwise), and with ``adaptive`` a context-conditioned affine,
    ``modulation`` = SiLU + Linear(context_channels, 2 * features), whose
    output splits into (shift, scale): y * (1 + scale) + shift.

    The condition is looked up by NAME in ``conditions`` and only its norm
    runs, so only that norm updates running statistics or gets gradients
    (the reference's PTv3 PDNorm). The JAX package's PDNorm takes an
    integer index into its own ``conditions`` and runs every norm, so the
    inactive BatchNorms absorb the batch's statistics (ROADMAP Queue 3).
    State-dict names are the reference's: ``norm.{c}.*`` (``norm.*`` when
    not decoupled) and ``modulation.1.*``. ``batch_norm`` is the class of
    the "bn" norms (PointBatchNorm for Point Transformer V2)."""

    def __init__(self, features: int, conditions=("ScanNet", "S3DIS", "Structured3D"),
                 norm_type: str = "ln", decouple: bool = True, adaptive: bool = False,
                 context_channels: int = 256, dtype: torch.dtype = torch.float32,
                 batch_norm: type = MaskedBatchNorm):
        super().__init__()
        if norm_type not in ("ln", "bn"):
            raise ValueError(f"norm_type {norm_type!r}: 'ln' or 'bn'")
        from .ptv3 import Linear  # the port's fp32 dense layer

        self.conditions = tuple(conditions)
        self.norm_type, self.decouple, self.adaptive = norm_type, decouple, adaptive
        make = (lambda: LayerNorm(features, dtype=dtype)) if norm_type == "ln" else (
            lambda: batch_norm(features, dtype=dtype))
        self.norm = nn.ModuleList([make() for _ in self.conditions]) if decouple else make()
        self.modulation = (nn.Sequential(nn.SiLU(), Linear(context_channels, 2 * features))
                           if adaptive else None)

    def forward(self, x: torch.Tensor, condition, context=None, mask=None) -> torch.Tensor:
        norm = self.norm
        if self.decouple:
            name = condition_name(condition)
            if name not in self.conditions:
                raise KeyError(f"condition {name!r} is not one of {self.conditions}")
            norm = self.norm[self.conditions.index(name)]
        y = norm(x) if self.norm_type == "ln" else norm(x, mask)
        if self.modulation is not None and context is not None:
            shift, scale = self.modulation(at_least_fp32(context)).chunk(2, dim=-1)
            y = y * (1 + scale[:, None, :]) + shift[:, None, :]
        return y
