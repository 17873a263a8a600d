"""Serialized pooling primitives (counterpart of
``scenesplat_tpu/ops/segops.py``).

Points that share a parent voxel (curve-0 code >> 3 * pooling_depth) are
consecutive along curve 0, so cluster ids are a cumulative sum over "parent
code changed" flags. Outputs live in fixed-capacity buffers; clusters past
the capacity go to a discard bin and are counted in ``n_overflow``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .serialization import SENTINEL, Serialization, sort_codes, take_along_points


@dataclass(frozen=True)
class PoolingPlan:
    """B = batch, N = input capacity, M = output (cluster) capacity.

    ``seg_sorted`` gives each curve-0-sorted input slot a cluster id in
    [0, M] (M is the discard bin for overflow and padding);
    ``cluster_of_point`` maps each input point to its cluster (clamped to
    M-1); ``head_index`` maps each cluster to the index of its first member;
    ``counts`` is members per cluster."""

    order0: torch.Tensor  # [B, N] int64
    seg_sorted: torch.Tensor  # [B, N] int64 in [0, M]
    cluster_of_point: torch.Tensor  # [B, N] int64 in [0, M-1]
    head_index: torch.Tensor  # [B, M] int64
    counts: torch.Tensor  # [B, M] int64
    out_mask: torch.Tensor  # [B, M] bool
    n_clusters: torch.Tensor  # [B] int64, before the capacity clamp
    n_overflow: torch.Tensor  # [B] int64, clusters lost to the capacity


def build_pooling_plan(ser: Serialization, mask: torch.Tensor,
                       out_capacity: int, pooling_depth: int = 1) -> PoolingPlan:
    b, n = mask.shape
    m = out_capacity
    order0, inverse0 = ser.order[0], ser.inverse[0]
    parent = take_along_points(ser.code[0], order0) >> (3 * pooling_depth)
    mask_sorted = take_along_points(mask, order0)

    changed = torch.ones_like(mask_sorted)
    changed[:, 1:] = parent[:, 1:] != parent[:, :-1]
    new_cluster = changed & mask_sorted
    cluster_sorted = torch.cumsum(new_cluster, dim=-1) - 1
    n_clusters = new_cluster.sum(-1)
    n_overflow = (n_clusters - m).clamp(min=0)
    seg_sorted = torch.where(mask_sorted & (cluster_sorted < m), cluster_sorted, m)

    # first sorted position of each cluster (n - 1 for empty clusters)
    pos = torch.arange(n, device=mask.device).expand(b, n)
    head_pos = torch.full((b, m + 1), n - 1, dtype=torch.int64, device=mask.device)
    head_pos.scatter_reduce_(1, seg_sorted, pos, "amin")
    head_index = take_along_points(order0, head_pos[:, :m])

    counts = torch.zeros(b, m + 1, dtype=torch.int64, device=mask.device)
    counts.scatter_add_(1, seg_sorted, mask_sorted.long())
    out_mask = (torch.arange(m, device=mask.device)
                < n_clusters.clamp(max=m).unsqueeze(1))
    cluster_of_point = take_along_points(cluster_sorted.clamp(0, m - 1), inverse0)
    return PoolingPlan(
        order0=order0, seg_sorted=seg_sorted, cluster_of_point=cluster_of_point,
        head_index=head_index, counts=counts[:, :m], out_mask=out_mask,
        n_clusters=n_clusters, n_overflow=n_overflow,
    )


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32, or in float64 if it is that: the dtype that sums,
    norms and softmaxes compute in (a float64 run stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def pool_values(plan: PoolingPlan, values: torch.Tensor,
                reduce: str = "mean") -> torch.Tensor:
    """Reduce per-point values [B, N, C] into cluster buffers [B, M, C].
    Sums accumulate in fp32 (float64 values in float64) and round to the
    values' dtype once."""
    b, n, c = values.shape
    m = plan.head_index.shape[1]
    sorted_vals = at_least_fp32(take_along_points(values, plan.order0))
    idx = plan.seg_sorted.unsqueeze(-1).expand(b, n, c)
    if reduce in ("sum", "mean"):
        out = sorted_vals.new_zeros(b, m + 1, c).scatter_add_(1, idx, sorted_vals)
        if reduce == "mean":
            out[:, :m] /= plan.counts.clamp(min=1).unsqueeze(-1)
    elif reduce in ("max", "min"):
        # out of place: the scatter's backward reads its output (ties share
        # the gradient evenly, as JAX's segment_max gradient does)
        fill = float("-inf") if reduce == "max" else float("inf")
        out = sorted_vals.new_full((b, m + 1, c), fill).scatter_reduce(
            1, idx, sorted_vals, "amax" if reduce == "max" else "amin")
        return torch.where((plan.counts > 0).unsqueeze(-1), out[:, :m], 0.0).to(values.dtype)
    else:
        raise ValueError(f"unknown reduce: {reduce}")
    return out[:, :m].to(values.dtype)


def pool_serialization(plan: PoolingPlan, ser: Serialization,
                       pooling_depth: int = 1) -> Serialization:
    """Per-curve codes and orders of the pooled points: the head codes
    shifted right, re-sorted. Curve 0 needs no sort: clusters are numbered
    along it, the shift keeps its order and padding is a trailing suffix, so
    its order and inverse are the identity."""
    s = ser.code.shape[0]
    code = torch.stack([take_along_points(ser.code[i], plan.head_index)
                        for i in range(s)]) >> (3 * pooling_depth)
    code = torch.where(plan.out_mask, code, SENTINEL)
    iota = torch.arange(code.shape[-1], device=code.device).expand_as(code[:1])
    if s > 1:
        order_rest, inverse_rest = sort_codes(code[1:])
        order = torch.cat([iota, order_rest])
        inverse = torch.cat([iota, inverse_rest])
    else:
        order = inverse = iota.contiguous()
    return Serialization(code=code, order=order, inverse=inverse, perm=ser.perm)


def unpool_values(values_pooled: torch.Tensor,
                  cluster_of_point: torch.Tensor) -> torch.Tensor:
    """Broadcast cluster values [B, M, C] back to points [B, N, C]."""
    return take_along_points(values_pooled, cluster_of_point)


def masked_mean_pool(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over each row's valid points, [B, N, C] -> [B, C], in the
    values' dtype (the valid count too, as the JAX function computes it)."""
    w = mask.unsqueeze(-1).to(values.dtype)
    return (values * w).sum(1) / w.sum(1).clamp(min=1.0)
