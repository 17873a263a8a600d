"""Point queries of Masked Scene Contrast (counterpart of the two functions of
``scenesplat_tpu/ops/pointops.py`` that MSC uses, ``knn`` and
``grid_cluster_plan``): batched, masked neighbour search and the voxel
clustering of a padded cloud.

The JAX ``knn`` is a brute force: a [T, N] tile of squared distances a tile
of queries, then ``top_k``. At MSC's 205,824 slots a view one tile of 512
queries is 0.4 GB and a row 8.5e10 distances. MSC keeps only the partners
closer than its radius among the k nearest, so ``knn_radius`` searches a
hash of cells of that radius (the 27 cells around each query) for the same
set. JAX computes both as plain XLA, no Pallas kernel, so these are plain
PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .segops import PoolingPlan, build_pooling_plan
from .serialization import serialize

_BIG = 1e10
# bound on the candidate (query, neighbour) pairs of one chunk
_PAIRS_PER_CHUNK = 1 << 25
_CELL_BITS = 20  # a cell index per axis, offset by one, in [0, 2^20)


def _cell_key(cell: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """int64 key of a cell [.., 3] (each index >= -1) in batch row ``row``."""
    c = (cell + 1).long()
    return (((row.long() << _CELL_BITS | c[..., 0]) << _CELL_BITS | c[..., 1])
            << _CELL_BITS | c[..., 2])


def knn_radius(coord: torch.Tensor, mask: torch.Tensor, k: int, radius: float,
               query: Optional[torch.Tensor] = None,
               query_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest data points strictly closer than ``radius`` to each
    query: coord [B, N, 3], mask [B, N]; query [B, M, 3] defaults to coord.
    Returns (idx [B, M, k] int64, dist [B, M, k] fp32 true distances) as
    the JAX ``knn`` returns them, nearest first and ties to the lower
    index, with -1 and sqrt(1e10) past the in-radius count.

    These are the in-radius points among the k nearest: when fewer than k
    lie within the radius, both hold all of them; otherwise both hold the k
    nearest. Points sit in cubic cells of side ``radius``; a query's
    candidates are the points of the 27 cells around its own, which hold
    every point within the radius. Distances are the direct sums of
    squared differences (the JAX brute force's matrix-product form loses
    about 1e-3 of a 3 cm distance to cancellation at coordinates of
    metres), so a point within a rounding of the radius may fall on the
    other side of it."""
    if query is None:
        query, query_mask = coord, mask
    if query_mask is None:
        query_mask = torch.ones(query.shape[:2], dtype=torch.bool, device=query.device)
    b, n = mask.shape
    m = query.shape[1]
    dev = coord.device
    coord, query = coord.float(), query.float()
    big = torch.tensor(_BIG, device=dev)
    lo = torch.minimum(torch.where(mask[..., None], coord, big).amin(1),
                       torch.where(query_mask[..., None], query, big).amin(1))  # [B, 3]
    lo = torch.where(lo < _BIG / 2, lo, 0.0)[:, None, :]
    rows = torch.arange(b, device=dev)[:, None]
    cell = torch.floor((coord - lo) / radius).long()
    key = torch.where(mask, _cell_key(cell, rows), torch.iinfo(torch.int64).max)
    key_sorted, order = torch.sort(key.reshape(-1), stable=True)
    qcell = torch.floor((query - lo) / radius).long()
    offsets = torch.stack(torch.meshgrid(*[torch.arange(-1, 2, device=dev)] * 3,
                                         indexing="ij"), -1).reshape(27, 3)
    flat_q = query.reshape(b * m, 3)
    qrow = rows.expand(b, m).reshape(-1)
    qcell = qcell.reshape(b * m, 1, 3) + offsets
    qkey = _cell_key(qcell, qrow[:, None])  # [B M, 27]
    start = torch.searchsorted(key_sorted, qkey)
    count = torch.searchsorted(key_sorted, qkey, right=True) - start
    count = torch.where(query_mask.reshape(-1, 1), count, 0)
    cmax = int(count.max()) if count.numel() else 0
    kk = min(k, n)
    idx = torch.zeros(b * m, kk, dtype=torch.int64, device=dev)
    d2 = torch.full((b * m, kk), _BIG, device=dev)
    if cmax > 0:
        slots = torch.arange(cmax, device=dev)
        chunk = max(1, _PAIRS_PER_CHUNK // (27 * cmax))
        for s in range(0, b * m, chunk):
            pos = start[s:s + chunk, :, None] + slots  # [T, 27, cmax]
            live = slots < count[s:s + chunk, :, None]
            cand = order[pos.clamp(max=b * n - 1)].reshape(pos.shape[0], -1)  # flat data ids
            live = live.reshape(pos.shape[0], -1)
            diff = coord.reshape(b * n, 3)[cand] - flat_q[s:s + chunk, None, :]
            dist2 = (diff * diff).sum(-1)
            dist2 = torch.where(live & (dist2 < radius * radius), dist2, _BIG)
            # nearest first, ties to the lower index: by index, then stably by distance
            cand, by_id = torch.sort(cand, dim=-1)
            dist2 = dist2.gather(-1, by_id)
            val, by_d = torch.sort(dist2, dim=-1, stable=True)
            take = min(kk, val.shape[-1])
            idx[s:s + chunk, :take] = cand.gather(-1, by_d[:, :take]) % n
            d2[s:s + chunk, :take] = val[:, :take]
    idx, d2 = idx.reshape(b, m, kk), d2.reshape(b, m, kk)
    if kk < k:  # scenes smaller than k: the trailing slots invalid
        idx = torch.nn.functional.pad(idx, (0, k - kk))
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=_BIG)
    valid = (d2 < _BIG / 2) & query_mask[..., None]
    return torch.where(valid, idx, -1), torch.where(valid, d2, _BIG).sqrt()


def grid_cluster_plan(coord: torch.Tensor, mask: torch.Tensor, grid_size: float,
                      out_capacity: int) -> PoolingPlan:
    """Voxel-grid clustering (reference torch_geometric.voxel_grid +
    torch.unique): each row's coordinates quantized from its valid
    points' minimum, the clusters read off one z-serialization at depth 16
    (``build_pooling_plan`` at pooling depth 0)."""
    big = torch.tensor(_BIG, dtype=coord.dtype, device=coord.device)
    start = torch.where(mask[..., None], coord, big).amin(1, keepdim=True)
    gc = torch.floor((coord - start) / grid_size).to(torch.int32)
    gc = torch.where(mask[..., None], gc.clamp(min=0), 0).long()
    return build_pooling_plan(serialize(gc, mask, ("z",), 16), mask, out_capacity, 0)
