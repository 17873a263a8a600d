"""PointBatch: the padded batched point cloud (counterpart of
``scenesplat_tpu/models/structure.py``). Every scene is padded to one N and
the batch is an explicit leading axis; ``mask`` flags real points."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from scenesplat_tpu_torch.ops.serialization import Serialization, serialize, shuffle_orders


@dataclass(frozen=True)
class PointBatch:
    """coord      [B, N, 3] float — raw coordinates
    feat       [B, N, C] float — per-point features
    grid_coord [B, N, 3] int   — non-negative voxel coordinates
    mask       [B, N]    bool  — True for real points, False for padding
    ser        per-curve serialization state, or None
    plans      the pooling plans of a backbone forward (ops.segops), one per
               pooling stage; empty on inputs
    """

    coord: torch.Tensor
    feat: torch.Tensor
    grid_coord: torch.Tensor
    mask: torch.Tensor
    ser: Optional[Serialization] = None
    plans: Tuple = ()

    @property
    def num_points(self) -> int:
        return self.coord.shape[1]

    def replace(self, **changes) -> "PointBatch":
        return dataclasses.replace(self, **changes)

    def serialized(self, orders: Sequence[str], depth: int = 16,
                   generator: Optional[torch.Generator] = None) -> "PointBatch":
        """Attach the serialization; with ``generator`` and more than one
        order, the logical curve order is shuffled (training)."""
        ser = serialize(self.grid_coord, self.mask, orders=orders, depth=depth)
        if generator is not None and len(orders) > 1:
            ser = shuffle_orders(ser, generator)
        return self.replace(ser=ser)
