"""Context parallel: each row's points over the layout's seq axis
(counterpart of ``scenesplat_tpu/parallel/mesh.py:context_mesh``,
``sequence_sharding`` and ``shard_point_batch``).

A rank holds a contiguous block of each stage's slots (``Part``): the
input's slots as ``shard_point_batch`` cuts them, a pooled stage's clusters
in the pooling plan's order. What is per point runs on that block alone:
the norms, the MLP, the pooled stages' BatchNorms, and the attention's
qkv and proj matmuls with K1 and K2 on the rank's whole windows of the
curve-sorted order (``ops/window_attention.py:rank_windows``; a window
never straddles two ranks). The geometry (coordinates, grid coordinates,
masks) is gathered once at the backbone's entry, so every rank serializes,
sorts and plans each row exactly as one process does. The ops that mix
points (the stem and xCPE convs, the order and inverse permutations,
pooling, unpooling) gather the stage's features over the seq group and
keep the rank's output slots. The JAX package leaves these moves to GSPMD.

Gathers are sums of zero-padded blocks over the seq group (gloo carries no
all_gather of CUDA tensors), whose backward is the same sum of the
cotangents: the convention of ``parallel/dist.py`` under which each rank
holds the global loss. ``GATHERED`` counts the bytes of every buffer so
summed, forward and backward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .dist import Layout, gather_bitwise, layout, local_batch_slice, make_layout, world

# bytes of the buffers summed over seq groups by this process (forward,
# backward), since the caller last set them to 0
GATHERED: Dict[str, int] = {"forward": 0, "backward": 0}


def context_groups(data: int = 1) -> Layout:
    """The (data, seq) grid with seq = world / data, the seq axis minor
    (rank = d * seq + s); every process calls it. Raises unless ``data``
    divides the group's size and leaves a seq axis of at least 2."""
    if data < 1 or world() % data or world() // data < 2:
        raise ValueError(f"context parallel over {world()} processes with data {data}: "
                         "no seq axis of 2 or more")
    return make_layout(data, seq=world() // data)


def _seq_grid() -> Layout:
    grid = layout()
    if grid.seq < 2 or grid.seq_group is None:
        raise RuntimeError("context parallel needs a layout with a seq group of 2 or more "
                           "(context_groups, then dist.set_layout)")
    return grid


def shard_point_batch(batch: Dict) -> Dict:
    """This rank's part of a global batch under the layout: of every array
    [B, N, ...] its rows (``local_batch_slice``) and its block of N / seq
    slots; arrays of one axis keep their rows, anything else passes
    through. N must split evenly over the seq axis; raises without a seq
    axis of 2 or more."""
    grid = layout()
    if grid.seq < 2:
        raise RuntimeError("context parallel needs a layout with a seq axis of 2 or more "
                           "(context_groups, then dist.set_layout)")
    out = {}
    for key, value in batch.items():
        if not hasattr(value, "shape") or len(value.shape) == 0:
            out[key] = value
            continue
        value = value[local_batch_slice(value.shape[0])]
        if len(value.shape) >= 2:
            n = value.shape[1]
            if n % grid.seq:
                raise ValueError(f"{key}: {n} slots do not split over {grid.seq} seq ranks")
            value = value[:, grid.seq_rank * (n // grid.seq):(grid.seq_rank + 1) * (n // grid.seq)]
        out[key] = value
    return out


class _SeqGather(torch.autograd.Function):
    """x [B, hi - lo, ...] -> [B, n, ...]: every rank's block in its place,
    the sum over the seq group of zero-padded blocks; the backward sums the
    cotangents over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx, x, n, lo, hi, group):
        ctx.lo, ctx.hi, ctx.group = lo, hi, group
        pad = [0, 0] * (x.dim() - 2) + [lo, n - hi]
        full = F.pad(x, pad).contiguous()
        GATHERED["forward"] += full.numel() * full.element_size()
        dist.all_reduce(full, group=group)
        return full

    @staticmethod
    def backward(ctx, dfull):
        dfull = dfull.contiguous().clone()
        GATHERED["backward"] += dfull.numel() * dfull.element_size()
        dist.all_reduce(dfull, group=ctx.group)
        return dfull[:, ctx.lo:ctx.hi], None, None, None, None


def seq_gather(x: torch.Tensor, n: int, lo: int, hi: int) -> torch.Tensor:
    """The row-wise gather over the layout's seq group of blocks [lo, hi)
    of ``n`` slots (each rank its own block), differentiable in ``x``."""
    grid = _seq_grid()
    if x.shape[1] != hi - lo:
        raise ValueError(f"a block of {x.shape[1]} slots for [{lo}, {hi})")
    return _SeqGather.apply(x, n, lo, hi, grid.seq_group)


@dataclass(frozen=True)
class Part:
    """This rank's block [lo, hi) of a stage's ``n`` slots."""

    n: int
    lo: int
    hi: int

    @classmethod
    def of(cls, n: int) -> "Part":
        """The rank's block of ``n`` slots, one of seq equal blocks (as the
        draws of ``dist.batch_rand`` cut them). Raises unless the seq axis
        divides ``n``: a stage's capacity is a multiple of its window, so
        a seq axis that divides the windows divides every stage."""
        grid = _seq_grid()
        if n % grid.seq:
            raise ValueError(f"{n} slots do not split over {grid.seq} seq ranks")
        per = n // grid.seq
        return cls(n, grid.seq_rank * per, (grid.seq_rank + 1) * per)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slots of a whole-stage tensor [B, n, ...]."""
        return x[:, self.lo:self.hi]

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's features [B, n, ...] from every rank's block."""
        return seq_gather(x, self.n, self.lo, self.hi)

    def whole_exact(self, x: torch.Tensor) -> torch.Tensor:
        """``whole`` bit for bit, not differentiable (the geometry)."""
        grid = _seq_grid()
        blocks = gather_bitwise(x, grid.seq_rank, grid.seq, grid.seq_group)
        return blocks.movedim(0, 1).reshape((x.shape[0], self.n) + x.shape[2:])
