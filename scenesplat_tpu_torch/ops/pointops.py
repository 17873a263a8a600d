"""Point queries (counterpart of ``scenesplat_tpu/ops/pointops.py``):
batched, masked neighbour search, farthest point sampling, grouping,
interpolation and the voxel clustering of a padded cloud, for Point
Transformer V1/V2 and Masked Scene Contrast.

The JAX ``knn`` is a brute force: a [T, N] tile of squared distances a tile
of queries, then ``top_k``. At 205,824 slots a row one tile of 512 queries
is 0.4 GB and a row 4e10 distances, so both searches here look up a hash of
cubic cells instead. ``knn`` is exact: a query whose k-th nearest
candidate of the 27 cells around its own lies closer than the cell side has
its k nearest, and the others search again at twice the side. With a
radius (MSC keeps only the partners closer than it among the k nearest)
it searches cells of that side once. Distances are direct
sums of squared differences: the JAX form |q|^2 + |x|^2 - 2 q.x loses
about 1e-3 of a 3 cm distance to cancellation at coordinates of metres, so
on lattice-like clouds its sets can differ from the exact ones. JAX
computes every one of these as plain XLA, no Pallas kernel, so these are
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .segops import PoolingPlan, build_pooling_plan
from .serialization import serialize

_BIG = 1e10
# bound on the candidate (query, neighbour) pairs of one chunk
_PAIRS_PER_CHUNK = 1 << 25
_CELL_BITS = 16  # a cell index per axis, offset by one, in [0, 2^16)
_MAX_CELLS = float(1 << 15)  # cells an axis at most: every index within _CELL_BITS
_KEY_MAX = torch.iinfo(torch.int64).max


def _cell_key(cell: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """int64 key of a cell [.., 3] (each index >= -1, below 2^16 - 1) in
    batch row ``row``."""
    c = (cell + 1).long()
    return (((row.long() << _CELL_BITS | c[..., 0]) << _CELL_BITS | c[..., 1]) << _CELL_BITS
            | c[..., 2])


def _neighbour_offsets(device) -> torch.Tensor:
    """The 27 cell offsets [27, 3] of a cell and its neighbours."""
    return torch.stack(torch.meshgrid(*[torch.arange(-1, 2, device=device)] * 3,
                                      indexing="ij"), -1).reshape(27, 3)


def _chunks(width, budget: int):
    """Bounds [(s, e)] of runs of ascending ``width`` (host ints) whose
    rows times their last width stay within ``budget`` (one row at least)."""
    out, s, p = [], 0, len(width)
    while s < p:
        cost = (torch.arange(1, p - s + 1) * width[s:].clamp(min=1))
        e = s + max(1, int((cost <= budget).sum()))
        out.append((s, e))
        s = e
    return out


def knn(coord: torch.Tensor, mask: torch.Tensor, k: int, query: Optional[torch.Tensor] = None,
        query_mask: Optional[torch.Tensor] = None,
        radius: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k nearest valid data points of each query (the JAX ``knn``,
    reference pointops.knn_query): coord [B, N, 3], mask [B, N]; query
    [B, M, 3] defaults to coord. Returns (idx [B, M, k] int64, dist
    [B, M, k] fp32 true distances), nearest first and ties to the lower
    index (as ``jax.lax.top_k`` orders them), with -1 and sqrt(1e10) past
    the row's valid count and on padded queries. With ``radius``, only
    those strictly closer than it (MSC keeps the in-radius part of the k
    nearest): -1 past the in-radius count.

    Each row's points sit in cubic cells of a side s (first the row's
    extent times sqrt(k / valid count), the spacing at which k points of a
    surface fall within s; or the radius). A query's candidates are the
    points of the 27 cells around its own, which hold every point closer
    than s. When its k-th nearest candidate lies closer than s (less a
    rounding margin) it has its k nearest; the other queries search again
    at 2 s, until s exceeds the row's extent and one cell holds everything.
    With a radius one pass settles every query. Candidates are ranked by
    one int64 key, the squared distance's bits above the point's index, so
    the order is total: nearest first, ties to the lower index."""
    if query is None:
        query, query_mask = coord, mask
    if query_mask is None:
        query_mask = torch.ones(query.shape[:2], dtype=torch.bool, device=query.device)
    b, n = mask.shape
    m = query.shape[1]
    dev = coord.device
    kk = min(k, n)
    coord, query = coord.float(), query.float()
    big = torch.tensor(_BIG, device=dev)
    lo = torch.minimum(torch.where(mask[..., None], coord, big).amin(1),
                       torch.where(query_mask[..., None], query, big).amin(1))  # [B, 3]
    hi = torch.maximum(torch.where(mask[..., None], coord, -big).amax(1),
                       torch.where(query_mask[..., None], query, -big).amax(1))
    lo = torch.where(lo < _BIG / 2, lo, 0.0)
    extent = (torch.where(hi > -_BIG / 2, hi, 0.0) - lo).amax(-1).clamp(min=1e-6)  # [B]
    if radius is None:
        side = extent * (kk / mask.sum(1).clamp(min=1).float()).sqrt()
    else:
        side = torch.full_like(extent, radius)
    side = side.maximum(extent / _MAX_CELLS)
    flat_c = coord.reshape(b * n, 3)
    flat_q = query.reshape(b * m, 3)
    drow = torch.arange(b, device=dev).repeat_interleave(n)
    qrow = torch.arange(b, device=dev).repeat_interleave(m)
    offsets = _neighbour_offsets(dev)
    key_out = torch.full((b * m, kk), _KEY_MAX, dtype=torch.int64, device=dev)
    pending = query_mask.reshape(-1).nonzero().squeeze(1)
    while pending.numel() and kk:
        cell = torch.floor((flat_c - lo[drow]) / side[drow, None]).long()
        key = torch.where(mask.reshape(-1), _cell_key(cell, drow), _KEY_MAX)
        key_sorted, order = torch.sort(key)
        prow = qrow[pending]
        qcell = torch.floor((flat_q[pending] - lo[prow]) / side[prow, None]).long()
        qkey = _cell_key(qcell[:, None, :] + offsets, prow[:, None])
        start = torch.searchsorted(key_sorted, qkey)
        count = torch.searchsorted(key_sorted, qkey, right=True) - start  # [P, 27]
        total = count.sum(1)
        total, by_total = torch.sort(total)
        pending, start, count = pending[by_total], start[by_total], count[by_total]
        cum = count.cumsum(1)
        done = torch.zeros(pending.shape[0], dtype=torch.bool, device=dev)
        for s, e in _chunks(total.cpu(), _PAIRS_PER_CHUNK):
            width = int(total[e - 1])
            q = pending[s:e]
            if width == 0:
                top = key_out.new_full((e - s, kk), _KEY_MAX)
            else:
                t = torch.arange(width, device=dev).expand(e - s, width)
                j = torch.searchsorted(cum[s:e], t.contiguous(), right=True).clamp(max=26)
                pos = start[s:e].gather(1, j) + t - (cum[s:e] - count[s:e]).gather(1, j)
                live = t < total[s:e, None]
                cand = order[pos.clamp(0, b * n - 1)]
                d = flat_c[cand] - flat_q[q, None, :]
                # one rounding an operation, as FPS: the card's and the
                # CPU's keys are equal bit for bit
                dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
                if radius is not None:
                    live = live & (dist2 < radius * radius)
                ckey = dist2.view(torch.int32).long() << 32 | (cand % n)
                ckey = torch.where(live, ckey, _KEY_MAX)
                top = torch.topk(ckey, min(kk, width), dim=1, largest=False).values
                if top.shape[1] < kk:
                    top = torch.nn.functional.pad(top, (0, kk - top.shape[1]), value=_KEY_MAX)
            if radius is None:
                row = qrow[q]
                kth = (top[:, -1] >> 32).to(torch.int32).view(torch.float32)
                reach = side[row] * (1.0 - 1e-5)
                ok = ((top[:, -1] != _KEY_MAX) & (kth < reach * reach)) | (
                    side[row] > extent[row])
            else:  # the 27 cells hold every point within the radius
                ok = torch.ones(e - s, dtype=torch.bool, device=dev)
            key_out[q] = torch.where(ok[:, None], top, key_out[q])
            done[s:e] = ok
        pending = pending[~done]
        side = side * 2.0
    found = key_out != _KEY_MAX
    d2 = torch.where(found, (key_out >> 32).to(torch.int32).view(torch.float32), _BIG)
    idx = torch.where(found, key_out & 0xFFFFFFFF, -1).reshape(b, m, kk)
    d2 = d2.reshape(b, m, kk)
    if kk < k:  # scenes smaller than k: the trailing slots invalid
        idx = torch.nn.functional.pad(idx, (0, k - kk), value=-1)
        d2 = torch.nn.functional.pad(d2, (0, k - kk), value=_BIG)
    return idx, d2.sqrt()


def farthest_point_sampling(coord: torch.Tensor, mask: torch.Tensor, num_samples: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FPS (the JAX ``farthest_point_sampling``, reference
    sampling_cuda_kernel.cu semantics): start at each row's first valid
    point, then greedily take the valid point farthest from the set taken
    (ties to the first index, as ``torch.argmax`` documents). Returns (idx
    [B, M] int64, sample_mask [B, M]: i < min(M, valid count)). A host loop
    of M - 1 steps of a few launches each."""
    b, n = mask.shape
    dev = coord.device
    c = coord.float()
    iota = torch.arange(n, device=dev)
    first = torch.where(mask, iota, n - 1).amin(1)
    rows = torch.arange(b, device=dev)
    dists = torch.where(mask, _BIG, -_BIG)
    idx = torch.zeros(b, num_samples, dtype=torch.int64, device=dev)
    idx[:, 0] = first
    last = first
    for i in range(1, num_samples):
        d = c - c[rows, last][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        dists = torch.minimum(dists, torch.where(mask, d2, -_BIG))
        last = dists.argmax(1)
        idx[:, i] = last
    n_valid = mask.sum(1)
    sample_mask = torch.arange(num_samples, device=dev) < n_valid.clamp(max=num_samples)[:, None]
    return idx, sample_mask


def _gather_slots(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, N, C] at idx [B, M, K] (each >= 0) -> [B, M, K, C] by one
    ``index_select`` of the flattened rows, whose backward is an
    ``index_add_`` (a point is the neighbour of about K others: the
    advanced-indexing backward sorts every index first: 2.4 of a 3.2 s
    PT-v2m2 step on an H100 80GB HBM3 at 700 W)."""
    b, n = values.shape[:2]
    rows = (idx + (torch.arange(b, device=idx.device) * n).view(b, 1, 1)).reshape(-1)
    out = values.reshape(b * n, -1).index_select(0, rows)
    return out.view(idx.shape + (out.shape[-1],))


def grouping(idx: torch.Tensor, feat: torch.Tensor, coord: torch.Tensor,
             query_coord: Optional[torch.Tensor] = None, with_xyz: bool = False) -> torch.Tensor:
    """Neighbour features (reference pointops.grouping): idx [B, M, K] (-1
    invalid), feat [B, N, C] -> [B, M, K, C]; ``with_xyz`` puts the
    neighbours' offsets (``grouped_offsets``) before the features. Invalid
    slots are zeros."""
    g = _gather_slots(feat, idx.clamp(min=0))
    g = torch.where((idx >= 0)[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
    if with_xyz:
        g = torch.cat([grouped_offsets(idx, coord, query_coord).to(g.dtype), g], -1)
    return g


def grouped_offsets(idx: torch.Tensor, coord: torch.Tensor,
                    query_coord: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each neighbour's offset from its query, [B, M, K, 3], zeros at
    invalid slots; ``query_coord`` defaults to the first M points of
    ``coord``."""
    m = idx.shape[1]
    if query_coord is None:
        query_coord = coord[:, :m]
    rel = _gather_slots(coord, idx.clamp(min=0)) - query_coord[:, :, None, :]
    return torch.where((idx >= 0)[..., None], rel, torch.zeros((), dtype=rel.dtype,
                                                                device=rel.device))


def interpolation(coord_src: torch.Tensor, mask_src: torch.Tensor, coord_dst: torch.Tensor,
                  mask_dst: torch.Tensor, feat_src: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Inverse-distance-weighted interpolation of ``feat_src`` [B, N, C] from
    each destination point's k nearest sources (reference
    pointops.interpolation); [B, M, C], zeros at padded destinations."""
    idx, dist = knn(coord_src, mask_src, k, query=coord_dst, query_mask=mask_dst)
    ok = idx >= 0
    recip = torch.where(ok, 1.0 / (dist + 1e-8), 0.0)
    w = recip / recip.sum(-1, keepdim=True).clamp(min=1e-12)
    g = _gather_slots(feat_src, idx.clamp(min=0))
    out = (g * w[..., None].to(g.dtype)).sum(2)
    return torch.where(mask_dst[..., None], out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device)).to(feat_src.dtype)


def subtraction(query: torch.Tensor, key_grouped: torch.Tensor) -> torch.Tensor:
    """The vector attention's relation q - k a neighbour (reference
    pointops.subtraction): [B, M, C], [B, M, K, C] -> [B, M, K, C]."""
    return query[:, :, None, :] - key_grouped


def aggregation(value_grouped: torch.Tensor, weight: torch.Tensor, groups: int) -> torch.Tensor:
    """Grouped weighted sum over the neighbours (reference
    pointops.aggregation): value [B, M, K, C], weight [B, M, K, G] -> [B, M,
    C], the C channels in G groups that share a weight."""
    b, m, k, c = value_grouped.shape
    v = value_grouped.reshape(b, m, k, groups, c // groups)
    return torch.einsum("bmkgi,bmkg->bmgi", v, weight.to(v.dtype)).reshape(b, m, c)


def grid_cluster_plan(coord: torch.Tensor, mask: torch.Tensor, grid_size: float,
                      out_capacity: int) -> PoolingPlan:
    """Voxel-grid clustering (reference torch_geometric.voxel_grid +
    torch.unique): each row's coordinates quantized from its valid
    points' minimum, the clusters read off one z-serialization at depth 16
    (``build_pooling_plan`` at pooling depth 0)."""
    big = torch.tensor(_BIG, dtype=coord.dtype, device=coord.device)
    start = torch.where(mask[..., None], coord, big).amin(1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its reciprocal, whose rounding moves lattice points across a cell
    # boundary that the CPU's true division keeps them on
    cell = torch.tensor(grid_size, dtype=coord.dtype, device=coord.device)
    gc = torch.floor((coord - start) / cell).to(torch.int32)
    gc = torch.where(mask[..., None], gc.clamp(min=0), 0).long()
    return build_pooling_plan(serialize(gc, mask, ("z",), 16), mask, out_capacity, 0)
