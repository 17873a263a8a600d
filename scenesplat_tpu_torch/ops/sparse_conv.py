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
differentiable torch ops (a scatter-add and a gather).

OctFormer's decoder upsamples with ocnn's OctreeDeconv(kernel 3, stride
2): each child gathers the up to 8 parents ``(c >> 1) + e`` that its
parity lets reach it (``build_corner_lookup``, a ``lookup_voxels`` of the
8 corners) and ``deconv_k3s2_apply`` contracts them, each through the tap
its offset selects, in one chunked im2col matmul (the submanifold conv's)."""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

from .segops import PoolingPlan, at_least_fp32
from .serialization import take_along_points
from .subm_conv import _SubMConv, lookup_voxels


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
    children = at_least_fp32(take_along_points(feat, plan.order0))
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


CORNERS = tuple(itertools.product((0, 1), repeat=3))  # x-major: e = ex * 4 + ey * 2 + ez


def build_corner_lookup(parent_grid: torch.Tensor, parent_mask: torch.Tensor,
                        child_grid: torch.Tensor, child_mask: torch.Tensor, depth: int = 16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each child voxel's 8 corner parents ``(c >> 1) + e``, e in {0, 1}^3
    enumerated x-major, looked up among the parent level's voxels
    (``lookup_voxels``). Returns (corner_index [B, 8, N] into the parent
    layout, corner_found [B, 8, N] bool, false at padding children)."""
    corners = torch.tensor(CORNERS, dtype=torch.int64, device=child_grid.device)
    q = (child_grid.to(torch.int64) >> 1)[:, None, :, :] + corners[None, :, None, :]
    index, found = lookup_voxels(parent_grid, parent_mask, q, depth)
    return index, found & child_mask[:, None, :]


def deconv_k3s2_apply(feat_parent: torch.Tensor, corner_index: torch.Tensor,
                      corner_found: torch.Tensor, child_grid: torch.Tensor,
                      kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Corner-anchored 27-tap stride-2 transposed conv, parents -> children
    (ocnn's OctreeDeconv(kernel=[3], stride=2)):

        out[c] = sum over parents p with c - 2p in (-1..1)^3 of x[p] @ W[c - 2p]

    With c = 2 (c >> 1) + r, the parents are p = (c >> 1) + e for the
    corners e <= r (bitwise), through the tap of offset r - 2e, taps
    enumerated x-major as ``kernel_offsets(3)``. A child's corners reach
    distinct taps, so its row of the im2col holds each found parent at its
    tap and zeros elsewhere; the contraction is the submanifold conv's
    chunked matmul (``_SubMConv``; its backward scatter-adds into the
    parents).

    feat_parent [B, M, Cin]; corner_index / corner_found [B, 8, N] from
    ``build_corner_lookup``; child_grid [B, N, 3]; kernel [27, Cin, Cout].
    Returns [B, N, Cout], zeros where ``mask`` is false."""
    b, m, cin = feat_parent.shape
    n = child_grid.shape[1]
    r = (child_grid.to(torch.int64) & 1)  # [B, N, 3]
    # per corner e: whether it reaches the child (e <= r) and through which tap
    e = torch.tensor(CORNERS, dtype=torch.int64, device=r.device)  # [8, 3]
    delta = r[:, None, :, :] - 2 * e[None, :, None, :]  # [B, 8, N, 3]
    reach = corner_found & (delta >= -1).all(-1)
    dcode = (delta + 1).clamp(0, 2)
    tap = dcode[..., 0] * 9 + dcode[..., 1] * 3 + dcode[..., 2]  # kernel_offsets(3)'s index
    base = torch.arange(b, device=r.device).view(b, 1, 1) * m
    src = torch.where(reach, corner_index + base, b * m)
    # rows of 28 columns: the 27 taps and one that takes the corners that
    # reach no tap; each child's reaching corners land in distinct taps
    idx = torch.full((b, n, 28), b * m, dtype=torch.int64, device=r.device)
    idx.scatter_(2, torch.where(reach, tap, 27).transpose(1, 2), src.transpose(1, 2))
    idx = idx[:, :, :27].reshape(b * n, 27)
    dt = feat_parent.dtype
    out = _SubMConv.apply(feat_parent.reshape(b * m, cin), kernel.to(dt),
                          None if bias is None else bias.to(dt), idx)
    out = out.view(b, n, -1)
    if mask is not None:
        out = torch.where(mask.unsqueeze(-1), out, 0.0)
    return out.to(dt)
