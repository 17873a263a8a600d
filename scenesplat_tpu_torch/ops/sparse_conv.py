"""Strided (downsampling) and inverse (upsampling) sparse 3D convolutions
(counterpart of ``scenesplat_tpu/ops/sparse_conv.py``):
spconv.SparseConv3d(kernel=2, stride=2) and SparseInverseConv3d(kernel=2),
as the reference SpUNet uses them.

With kernel 2 and stride 2 every input voxel feeds one output voxel, its
parent (grid_coord >> 1), through the kernel tap its low bits select
(``kernel_tap``). The parent clustering is the serialized pooling plan
(``ops/segops.py:PoolingPlan`` at pooling depth 1), and the inverse conv
shares the downsample's plan as spconv shares its ``indice_key``.

The JAX package runs eight masked full-width matmuls, one a tap, to keep
the TPU's matrix unit busy. Here each parent's children are laid out by
tap, [B, M, 8 * Cin] (a child's features land in its tap's slot; voxels
that share a parent and a tap, which Mix3D's merged rooms can hold, add
up), and one matmul with the [8 * Cin, Cout] kernel gives the parents. The
inverse conv multiplies each parent by all eight taps' kernels at once,
[B, M, 8 * Cout], and each child takes its tap's slot. Both are plain
differentiable torch ops (a scatter-add and a gather)."""

from __future__ import annotations

from typing import Optional

import torch

from .segops import PoolingPlan
from .serialization import take_along_points


def kernel_tap(grid_coord: torch.Tensor) -> torch.Tensor:
    """Kernel position of each voxel in its 2x2x2 parent cell:
    (x & 1) << 2 | (y & 1) << 1 | (z & 1). [B, N, 3] int -> [B, N] int64."""
    g = grid_coord.long()
    return ((g[..., 0] & 1) << 2) | ((g[..., 1] & 1) << 1) | (g[..., 2] & 1)


def strided_conv_apply(feat: torch.Tensor, plan: PoolingPlan, grid_coord: torch.Tensor,
                       kernel: torch.Tensor, bias: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """SparseConv3d(kernel=2, stride=2), children -> parents.

    feat [B, N, Cin]; ``plan`` clusters the points by parent (a pooling
    depth 1 plan over the z-serialization of ``grid_coord``); kernel [8,
    Cin, Cout]. Returns [B, M, Cout] in the plan's cluster layout, zeros
    past each row's clusters. Padding points and clusters past the
    capacity fall into the plan's discard bin."""
    b, n, cin = feat.shape
    m = plan.head_index.shape[1]
    cout = kernel.shape[-1]
    slot = plan.seg_sorted * 8 + take_along_points(kernel_tap(grid_coord), plan.order0)
    children = take_along_points(feat, plan.order0).float()
    cells = children.new_zeros(b, (m + 1) * 8, cin).scatter_add(
        1, slot.unsqueeze(-1).expand(b, n, cin), children)
    out = cells[:, : m * 8].reshape(b, m, 8 * cin).to(feat.dtype) @ kernel.to(
        feat.dtype).reshape(8 * cin, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return torch.where(plan.out_mask.unsqueeze(-1), out, 0.0).to(feat.dtype)


def inverse_conv_apply(feat_parent: torch.Tensor, plan: PoolingPlan,
                       grid_coord: torch.Tensor, kernel: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SparseInverseConv3d(kernel=2) sharing the downsample's plan, parents
    -> children: out[c] = x[parent(c)] @ kernel[tap(c)].

    feat_parent [B, M, Cin]; ``grid_coord`` and ``mask`` are the child
    level's ([B, N, 3], [B, N]); kernel [8, Cin, Cout]. Returns [B, N, Cout],
    zeros where ``mask`` is false."""
    b, m, cin = feat_parent.shape
    cout = kernel.shape[-1]
    dt = feat_parent.dtype
    taps = (feat_parent @ kernel.to(dt).permute(1, 0, 2).reshape(cin, 8 * cout)).reshape(
        b, m * 8, cout)
    out = take_along_points(taps, plan.cluster_of_point * 8 + kernel_tap(grid_coord))
    if bias is not None:
        out = out + bias.to(out.dtype)
    if mask is not None:
        out = torch.where(mask.unsqueeze(-1), out, 0.0)
    return out.to(dt)
