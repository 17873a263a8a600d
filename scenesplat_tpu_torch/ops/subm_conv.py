"""Submanifold sparse 3D convolution (spconv.SubMConv3d stand-in).

Counterpart of ``scenesplat_tpu/ops/subm_conv.py``. Output positions equal
input positions, so a conv is "for each point, gather the features of the up
to K^3 occupied neighbour voxels and contract with per-offset weights". The
neighbour plan is built once per stage and shared by every block of the
stage, like spconv's ``indice_key``.

One plan builder: the voxel keys, with the batch index folded in, are sorted
once (``ops/bitonic_sort.py:sort_int64``, as the serialization sorts) and
every neighbour query is a ``searchsorted`` into them
(``lookup_voxels``, which the transposed conv's and SPVCNN's corner
lookups share). ``subm_dwconv_apply`` is OctFormer's depthwise conv. The JAX
package's merge-join, dense-grid and hash builders, its host-built stem plan
and its staged geometry programs exist for TPU compile limits and have no
counterpart here.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Tuple

import torch

from .bitonic_sort import sort_int64
from .segops import at_least_fp32

_AXIS_BITS = 16  # grid coords are < 2**depth <= 2**16 per axis
_PAD_KEY = (1 << 62) + 1  # never equals a query key


@dataclass(frozen=True)
class SubMConvPlan:
    """neighbor_index [B, K3, N] int64 — index of the neighbour at each
    kernel offset (arbitrary where invalid); neighbor_valid [B, K3, N] bool —
    neighbour voxel occupied and in range."""

    neighbor_index: torch.Tensor
    neighbor_valid: torch.Tensor
    kernel_size: int


def kernel_offsets(kernel_size: int) -> Tuple[Tuple[int, int, int], ...]:
    r = kernel_size // 2
    return tuple(itertools.product(range(-r, r + 1), repeat=3))


def subplan(plan: SubMConvPlan, kernel_size: int) -> SubMConvPlan:
    """The plan of a smaller kernel (k=3 from the k=5 stem plan): its
    offsets are a subset of the larger kernel's."""
    big = kernel_offsets(plan.kernel_size)
    sel = [big.index(off) for off in kernel_offsets(kernel_size)]
    return SubMConvPlan(
        neighbor_index=plan.neighbor_index[:, sel],
        neighbor_valid=plan.neighbor_valid[:, sel],
        kernel_size=kernel_size,
    )


def plan_rows(plan: SubMConvPlan, lo: int, hi: int) -> SubMConvPlan:
    """The plan of query points [lo, hi) alone (its indices still address
    the whole stage): a context-parallel rank's output slots."""
    return SubMConvPlan(neighbor_index=plan.neighbor_index[..., lo:hi],
                        neighbor_valid=plan.neighbor_valid[..., lo:hi],
                        kernel_size=plan.kernel_size)


def _voxel_key(grid: torch.Tensor) -> torch.Tensor:
    """[B, ..., 3] int64 in-range coords -> [B, ...] int64 keys with the
    batch index in the bits above the three coordinate fields."""
    b = grid.shape[0]
    batch = torch.arange(b, device=grid.device).view((b,) + (1,) * (grid.dim() - 2))
    return ((batch << (3 * _AXIS_BITS)) | (grid[..., 0] << (2 * _AXIS_BITS))
            | (grid[..., 1] << _AXIS_BITS) | grid[..., 2])


def lookup_voxels(grid_coord: torch.Tensor, mask: torch.Tensor, query: torch.Tensor,
                  depth: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Find query coordinates among a level's voxels: grid_coord [B, N, 3]
    int and mask [B, N] bool (the level), query [B, ..., 3] int (row b's
    queries look in row b) -> (index [B, ...] int64 into the level's N
    slots, found [B, ...] bool).

    A query is found where a real voxel of its row has its coordinates and
    it lies in [0, 2**depth) on every axis; where several real voxels share
    them, the first in sort order. The index is arbitrary where not found.
    The level's keys, the batch index folded in, are sorted once
    (``sort_int64``) and every query is a ``searchsorted`` into them."""
    if not 0 < depth <= _AXIS_BITS:
        raise ValueError(f"bad depth {depth}")
    b, n = mask.shape
    limit = (1 << depth) - 1
    keys = torch.where(mask, _voxel_key(grid_coord.to(torch.int64).clamp(0, limit)), _PAD_KEY)
    sorted_keys, sort_idx = sort_int64(keys.reshape(-1))
    q = query.to(torch.int64)
    in_range = ((q >= 0) & (q <= limit)).all(-1)
    qkey = _voxel_key(q.clamp(0, limit)).reshape(-1)
    pos = torch.searchsorted(sorted_keys, qkey).clamp_(max=b * n - 1)
    found = (sorted_keys[pos] == qkey).view(in_range.shape) & in_range
    return sort_idx[pos].view(in_range.shape) % n, found


def build_subm_conv_plan(grid_coord: torch.Tensor, mask: torch.Tensor,
                         kernel_size: int = 3, depth: int = 16) -> SubMConvPlan:
    """grid_coord [B, N, 3] int, mask [B, N] bool -> plan.

    A neighbour is valid where the query point is real, the neighbour voxel
    lies in [0, 2**depth) on every axis and a real point occupies it (the
    first in sort order if several do): ``lookup_voxels`` of each point's
    K^3 offsets."""
    if kernel_size % 2 != 1 or not 0 < depth <= _AXIS_BITS:
        raise ValueError(f"bad kernel_size {kernel_size} or depth {depth}")
    offsets = torch.tensor(kernel_offsets(kernel_size), dtype=torch.int64,
                           device=grid_coord.device)
    q = grid_coord.to(torch.int64)[:, None, :, :] + offsets[None, :, None, :]  # [B, K3, N, 3]
    index, found = lookup_voxels(grid_coord, mask, q, depth)
    return SubMConvPlan(
        neighbor_index=index,
        neighbor_valid=found & mask[:, None, :],
        kernel_size=kernel_size,
    )


# bound on the elements of one im2col chunk in subm_conv_apply
_COLS_PER_CHUNK = 1 << 27


class _SubMConv(torch.autograd.Function):
    """Chunked im2col + matmul: output row r contracts the rows idx[r]
    of feat (row len(feat) reads zeros) with the flattened weight; the
    output has as many rows as idx, which a transposed conv makes differ
    from feat's. The backward recomputes each chunk's im2col
    instead of saving it (at the flagship dec0, batch 2, the im2col of one
    conv would be 27 x 768 x 393,216 bf16 values, about 16 GB): dW is the
    sum over chunks of cols^T . dY, and dX the scatter-add of (dY . W^T),
    reshaped to [rows, K3, Cin], into the neighbour rows, invalid neighbours
    dropped. Both accumulate in fp32 and round to their dtype once."""

    @staticmethod
    def forward(ctx, feat, weight, bias, idx):
        cin = feat.shape[1]
        k3, _, cout = weight.shape
        flat = torch.cat([feat, feat.new_zeros(1, cin)])
        w = weight.reshape(k3 * cin, cout)
        rows = max(1, _COLS_PER_CHUNK // (k3 * cin))
        out = torch.empty(idx.shape[0], cout, dtype=feat.dtype, device=feat.device)
        for s in range(0, idx.shape[0], rows):
            cols = flat[idx[s:s + rows]].reshape(-1, k3 * cin)
            if bias is None:
                torch.mm(cols, w, out=out[s:s + rows])
            else:
                torch.addmm(bias, cols, w, out=out[s:s + rows])
        ctx.save_for_backward(feat, weight, idx)
        ctx.has_bias = bias is not None
        return out

    @staticmethod
    def backward(ctx, dout):
        feat, weight, idx = ctx.saved_tensors
        bn, cin = feat.shape
        k3, _, cout = weight.shape
        dout = dout.to(feat.dtype).contiguous()
        need_x, need_w = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        flat = torch.cat([feat, feat.new_zeros(1, cin)])
        w = weight.reshape(k3 * cin, cout)
        rows = max(1, _COLS_PER_CHUNK // (k3 * cin))
        acc = torch.promote_types(feat.dtype, torch.float32)  # a float64 step keeps float64
        dw = torch.zeros(k3 * cin, cout, dtype=acc, device=feat.device)
        dx = torch.zeros(bn + 1, cin, dtype=acc, device=feat.device) if need_x else None
        for s in range(0, idx.shape[0], rows):
            dy = dout[s:s + rows]
            if need_w:
                cols = flat[idx[s:s + rows]].reshape(-1, k3 * cin)
                dw += torch.mm(cols.t(), dy).to(acc)
            if need_x:
                dcols = torch.mm(dy, w.t()).reshape(-1, cin).to(acc)
                dx.index_add_(0, idx[s:s + rows].reshape(-1), dcols)
        dx = dx[:bn].to(feat.dtype) if need_x else None
        dw = dw.view(k3, cin, cout).to(weight.dtype) if need_w else None
        need_b = ctx.has_bias and ctx.needs_input_grad[2]
        db = dout.to(acc).sum(0).to(weight.dtype) if need_b else None
        return dx, dw, db, None


def subm_conv_apply(feat: torch.Tensor, plan: SubMConvPlan, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """feat [B, N, Cin], weight [K3, Cin, Cout] -> [B, M, Cout] at the
    plan's M query points (M = N but for a plan cut to some of a stage's
    points, whose indices still address all N: context parallel).

    Gathers the K3 neighbour rows of each point (zeros where invalid) and
    contracts them with the flattened weight in one matmul per chunk of
    points, so the K3 * Cin products accumulate in fp32 inside the matmul
    and round to the feature dtype once, as the JAX package's fp32-
    accumulated per-offset sum does. Differentiable in feat, weight and
    bias (see ``_SubMConv``)."""
    b, n, cin = feat.shape
    k3, _, cout = weight.shape
    m = plan.neighbor_index.shape[2]
    if k3 != plan.neighbor_index.shape[1]:
        raise ValueError(f"weight has {k3} offsets, plan has "
                         f"{plan.neighbor_index.shape[1]}")
    base = torch.arange(b, device=feat.device).view(b, 1, 1) * n
    idx = torch.where(plan.neighbor_valid, plan.neighbor_index + base, b * n)
    idx = idx.transpose(1, 2).reshape(b * m, k3)  # point-major
    out = _SubMConv.apply(feat.reshape(b * n, cin), weight, bias, idx)
    return out.view(b, m, cout)


class _SubMDWConv(torch.autograd.Function):
    """Chunked depthwise gather-and-sum: out[r] = sum_k feat[idx[r, k]] *
    weight[k] (row len(feat) reads zeros), in fp32 (float64 for float64
    input) and rounded to the feature dtype once. The backward recomputes
    each chunk's gather: dW is the sum over chunks of gathered * dY, and
    dX the scatter-add of dY * W into the neighbour rows."""

    @staticmethod
    def forward(ctx, feat, weight, idx):
        c = feat.shape[1]
        k3 = weight.shape[0]
        flat = torch.cat([feat, feat.new_zeros(1, c)])
        w = at_least_fp32(weight)
        rows = max(1, _COLS_PER_CHUNK // (k3 * c))
        out = torch.empty(idx.shape[0], c, dtype=feat.dtype, device=feat.device)
        for s in range(0, idx.shape[0], rows):
            cols = at_least_fp32(flat[idx[s:s + rows]])  # [rows, K3, C]
            out[s:s + rows] = torch.einsum("rkc,kc->rc", cols, w).to(feat.dtype)
        ctx.save_for_backward(feat, weight, idx)
        return out

    @staticmethod
    def backward(ctx, dout):
        feat, weight, idx = ctx.saved_tensors
        bn, c = feat.shape
        k3 = weight.shape[0]
        acc = torch.promote_types(feat.dtype, torch.float32)
        dout = dout.to(acc).contiguous()
        flat = torch.cat([feat, feat.new_zeros(1, c)])
        w = weight.to(acc)
        rows = max(1, _COLS_PER_CHUNK // (k3 * c))
        dw = torch.zeros(k3, c, dtype=acc, device=feat.device)
        dx = torch.zeros(bn + 1, c, dtype=acc, device=feat.device)
        for s in range(0, idx.shape[0], rows):
            dy = dout[s:s + rows]
            if ctx.needs_input_grad[1]:
                dw += torch.einsum("rkc,rc->kc", flat[idx[s:s + rows]].to(acc), dy)
            if ctx.needs_input_grad[0]:
                dcols = (dy[:, None, :] * w).reshape(-1, c)
                dx.index_add_(0, idx[s:s + rows].reshape(-1), dcols)
        dx = dx[:bn].to(feat.dtype) if ctx.needs_input_grad[0] else None
        dw = dw.to(weight.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def subm_dwconv_apply(feat: torch.Tensor, plan: SubMConvPlan, weight: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise submanifold conv (OctFormer's OctreeDWConv; counterpart of
    ``scenesplat_tpu/ops/subm_conv.py:subm_dwconv_apply``): feat [B, N, C],
    weight [K3, C] -> [B, N, C], each channel the sum over the valid
    neighbours of their value times the offset's weight. Chunked as
    ``subm_conv_apply`` (at OctFormer's first stage the whole gather would
    be about 100k x 27 x 96 values a row). Differentiable in feat, weight
    and bias."""
    b, n, c = feat.shape
    k3 = weight.shape[0]
    if k3 != plan.neighbor_index.shape[1] or weight.shape[1] != c:
        raise ValueError(f"weight {tuple(weight.shape)} for {plan.neighbor_index.shape[1]} "
                         f"offsets and {c} channels")
    base = torch.arange(b, device=feat.device).view(b, 1, 1) * n
    idx = torch.where(plan.neighbor_valid, plan.neighbor_index + base, b * n)
    idx = idx.transpose(1, 2).reshape(b * n, k3)
    out = _SubMDWConv.apply(feat.reshape(b * n, c), weight.to(feat.dtype), idx).view(b, n, c)
    return out if bias is None else out + bias.to(out.dtype)
