"""Batched point-cloud serialization.

Counterpart of ``scenesplat_tpu/ops/serialization.py``: the batch is an
explicit leading axis of padded tensors, padding slots carry a sentinel code
above every real code so they sort last, and each curve is one stable sort
over int64 codes through ``ops/bitonic_sort.py:sort_int64``: ``torch.sort``
by default, the hand-written bitonic kernel on the codes' 32-bit halves
with ``SCENESPLAT_BITONIC_SORT=1`` (the same order either way).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from .bitonic_sort import sort_int64
from .curves import encode

# above every real code (codes use at most 48 bits) and above every code
# shifted right by pooling, so padding sorts last at every stage
SENTINEL = 1 << 62


@dataclass(frozen=True)
class Serialization:
    """Per-curve serialization state of a padded batch.

    Shapes use S = number of curve orders, B = batch, N = padded points.
    ``order[s, b, j]`` is the source index of the j-th point along curve s;
    ``inverse`` is the inverse permutation; ``code`` holds the unsorted
    per-point int64 codes (``SENTINEL`` at padding). ``perm`` maps a
    logical curve index to a physical one, so the physical curve 0 stays
    "z" for pooling while training shuffles which curve each block reads
    (``shuffle_orders``); eval never shuffles.
    """

    code: torch.Tensor  # [S, B, N] int64
    order: torch.Tensor  # [S, B, N] int64
    inverse: torch.Tensor  # [S, B, N] int64
    perm: Tuple[int, ...]

    def curve_order(self, index: int) -> torch.Tensor:
        """[B, N] order of logical curve ``index``."""
        return self.order[self.perm[index]]

    def curve_inverse(self, index: int) -> torch.Tensor:
        return self.inverse[self.perm[index]]


def compute_codes(grid_coord: torch.Tensor, mask: torch.Tensor,
                  orders: Sequence[str], depth: int = 16) -> torch.Tensor:
    """grid_coord [B, N, 3] int (non-negative), mask [B, N] bool ->
    [S, B, N] int64 codes with ``SENTINEL`` at padding."""
    return torch.stack([
        torch.where(mask, encode(grid_coord, order, depth), SENTINEL)
        for order in orders
    ])


def invert_order(order: torch.Tensor) -> torch.Tensor:
    """Inverse permutation along the last axis: inverse[order[j]] = j."""
    iota = torch.arange(order.shape[-1], device=order.device)
    return torch.empty_like(order).scatter_(-1, order, iota.expand_as(order))


def sort_codes(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, inverse) permutations along the last axis."""
    order = sort_int64(code)[1]
    return order, invert_order(order)


def serialize(grid_coord: torch.Tensor, mask: torch.Tensor,
              orders: Sequence[str] = ("z",), depth: int = 16) -> Serialization:
    code = compute_codes(grid_coord, mask, orders, depth)
    order, inverse = sort_codes(code)
    return Serialization(code=code, order=order, inverse=inverse,
                         perm=tuple(range(len(orders))))


def shuffle_orders(ser: Serialization, generator: torch.Generator) -> Serialization:
    """Randomly permute the logical curve order through the ``perm``
    indirection, with no data movement: new perm[i] = perm[draw[i]] for a
    permutation ``draw`` from ``generator`` (counterpart of
    ``scenesplat_tpu/ops/serialization.py:shuffle_orders``)."""
    s = len(ser.perm)
    draw = torch.randperm(s, generator=generator, device=generator.device).tolist()
    return dataclasses.replace(ser, perm=tuple(ser.perm[i] for i in draw))


def take_along_points(values: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Gather per-point values [B, N, ...] by per-batch indices [B, M]."""
    b, n = values.shape[:2]
    base = torch.arange(b, device=values.device).unsqueeze(1) * n
    flat = values.reshape((b * n,) + values.shape[2:])
    out = flat[(indices + base).reshape(-1)]
    return out.reshape((b, indices.shape[1]) + values.shape[2:])
