"""Point queries (counterpart of ``scenesplat_tpu/ops/pointops.py``):
batched, masked neighbour search (k nearest and ball queries), farthest
point sampling, grouping, interpolation, the vector attention's steps and
the voxel clustering of a padded cloud, for Point Transformer V1/V2,
Masked Scene Contrast and the Stratified Transformer.

The JAX ``knn`` is a brute force: a [T, N] tile of squared distances a tile
of queries, then ``top_k``. At 205,824 slots a row one tile of 512 queries
is 0.4 GB and a row 4e10 distances, so both searches here look up a hash of
cubic cells instead. ``knn`` is exact: a query whose k-th nearest
candidate of the 27 cells around its own lies closer than the cell side has
its k nearest, and the others search again at twice the side. With a
radius (MSC keeps only the partners closer than it among the k nearest)
it searches cells of that side once, as the ball queries do. Distances
are direct sums of squared differences: the JAX form |q|^2 + |x|^2 - 2 q.x
loses about 1e-3 of a 3 cm distance to cancellation at coordinates of
metres, so on lattice-like clouds its sets can differ from the exact ones,
and a ball's band can take or drop a point near its radius. JAX computes
every one of these as plain XLA, no Pallas kernel, so these are plain
PyTorch, but for FPS on the card: its M dependent steps are one launch of
``csrc/farthest_point_sampling.cu`` (``ops/fps.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import fps
from .segops import PoolingPlan, build_pooling_plan
from .serialization import serialize, take_along_points

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


def _bounds(coord, mask, query, query_mask):
    """Each row's smallest corner [B, 3] and largest extent [B] over its
    valid data points and queries."""
    big = torch.tensor(_BIG, device=coord.device)
    lo = torch.minimum(torch.where(mask[..., None], coord, big).amin(1),
                       torch.where(query_mask[..., None], query, big).amin(1))  # [B, 3]
    hi = torch.maximum(torch.where(mask[..., None], coord, -big).amax(1),
                       torch.where(query_mask[..., None], query, -big).amax(1))
    lo = torch.where(lo < _BIG / 2, lo, 0.0)
    extent = (torch.where(hi > -_BIG / 2, hi, 0.0) - lo).amax(-1).clamp(min=1e-6)  # [B]
    return lo, extent


def _cell_candidates(flat_c, flat_mask, flat_q, pending, lo, side, n, m):
    """The candidates of each pending query (an index into the B * M
    flattened queries): the valid data points of the 27 cells of ``side``
    [B] around its own. Returns the pending queries ordered by their
    candidate count and a generator of chunks ``(s, e, cand, dist2, live)``
    over them: ``cand`` [e - s, W] global data indices (W the chunk's
    largest count), ``dist2`` their squared distances as direct sums of
    squared differences, one rounding an operation (the card's and the
    CPU's bits agree), ``live`` the real candidates."""
    dev = flat_c.device
    b = side.shape[0]
    drow = torch.arange(b, device=dev).repeat_interleave(n)
    qrow = torch.arange(b, device=dev).repeat_interleave(m)
    cell = torch.floor((flat_c - lo[drow]) / side[drow, None]).long()
    key = torch.where(flat_mask, _cell_key(cell, drow), _KEY_MAX)
    key_sorted, order = torch.sort(key)
    prow = qrow[pending]
    qcell = torch.floor((flat_q[pending] - lo[prow]) / side[prow, None]).long()
    qkey = _cell_key(qcell[:, None, :] + _neighbour_offsets(dev), prow[:, None])
    start = torch.searchsorted(key_sorted, qkey)
    count = torch.searchsorted(key_sorted, qkey, right=True) - start  # [P, 27]
    total, by_total = torch.sort(count.sum(1))
    pending, start, count = pending[by_total], start[by_total], count[by_total]
    cum = count.cumsum(1)

    def chunks():
        for s, e in _chunks(total.cpu(), _PAIRS_PER_CHUNK):
            width = int(total[e - 1])
            t = torch.arange(width, device=dev).expand(e - s, width)
            j = torch.searchsorted(cum[s:e], t.contiguous(), right=True).clamp(max=26)
            pos = start[s:e].gather(1, j) + t - (cum[s:e] - count[s:e]).gather(1, j)
            cand = order[pos.clamp(0, b * n - 1)]
            d = flat_c[cand] - flat_q[pending[s:e], None, :]
            dist2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
            yield s, e, cand, dist2, t < total[s:e, None]

    return pending, chunks()


def _smallest(key: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` smallest int64 keys of each row, ascending, padded with
    _KEY_MAX where a row has fewer (by concatenation: ``F.pad`` passes its
    fill through a float, which turns _KEY_MAX into the int64 minimum)."""
    top = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False).values
    if top.shape[1] < k:
        top = torch.cat([top, top.new_full((top.shape[0], k - top.shape[1]), _KEY_MAX)], 1)
    return top


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
    lo, extent = _bounds(coord, mask, query, query_mask)
    if radius is None:
        side = extent * (kk / mask.sum(1).clamp(min=1).float()).sqrt()
    else:
        side = torch.full_like(extent, radius)
    side = side.maximum(extent / _MAX_CELLS)
    flat_c, flat_q, flat_mask = coord.reshape(b * n, 3), query.reshape(b * m, 3), mask.reshape(-1)
    qrow = torch.arange(b, device=dev).repeat_interleave(m)
    key_out = torch.full((b * m, kk), _KEY_MAX, dtype=torch.int64, device=dev)
    pending = query_mask.reshape(-1).nonzero().squeeze(1)
    while pending.numel() and kk:
        pending, chunks = _cell_candidates(flat_c, flat_mask, flat_q, pending, lo, side, n, m)
        done = torch.zeros(pending.shape[0], dtype=torch.bool, device=dev)
        for s, e, cand, dist2, live in chunks:
            q = pending[s:e]
            if radius is not None:
                live = live & (dist2 < radius * radius)
            ckey = dist2.view(torch.int32).long() << 32 | (cand % n)
            top = _smallest(torch.where(live, ckey, _KEY_MAX), kk)
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


def _priority_ball_query(coord: torch.Tensor, mask: torch.Tensor, nsample: int,
                         max_radius: float, min_radius: float, priority: torch.Tensor,
                         query: Optional[torch.Tensor], query_mask: Optional[torch.Tensor],
                         pad_mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``nsample`` valid points of lowest ``priority`` [B, N] (distinct
    non-negative int64 ranks within a row) whose squared distance from the
    query lies in [min_radius^2, max_radius^2], in that order: the JAX
    ``_priority_ball_query``, over the cells of ``knn`` (cells of the
    radius, one pass) with distances as direct differences."""
    if pad_mode not in ("first", "shadow"):
        raise ValueError(f"pad_mode is 'first' or 'shadow', got {pad_mode!r}")
    if query is None:
        query, query_mask = coord, mask
    if query_mask is None:
        query_mask = torch.ones(query.shape[:2], dtype=torch.bool, device=query.device)
    b, n = mask.shape
    m = query.shape[1]
    dev = coord.device
    ns = min(nsample, n)
    coord, query = coord.float(), query.float()
    lo, extent = _bounds(coord, mask, query, query_mask)
    # a margin over the radius: a point at the radius lies in a
    # neighbouring cell whatever the rounding of its cell index
    side = torch.full_like(extent, max_radius * (1.0 + 1e-4)).maximum(extent / _MAX_CELLS)
    lo2, hi2 = min_radius * min_radius, max_radius * max_radius
    flat_c, flat_q, flat_mask = coord.reshape(b * n, 3), query.reshape(b * m, 3), mask.reshape(-1)
    flat_prio = priority.reshape(-1).long()
    key_out = torch.full((b * m, ns), _KEY_MAX, dtype=torch.int64, device=dev)
    pending = query_mask.reshape(-1).nonzero().squeeze(1)
    if pending.numel() and ns:
        pending, chunks = _cell_candidates(flat_c, flat_mask, flat_q, pending, lo, side, n, m)
        for s, e, cand, dist2, live in chunks:
            live = live & (dist2 >= lo2) & (dist2 <= hi2)
            key = torch.where(live, flat_prio[cand] << 32 | (cand % n), _KEY_MAX)
            key_out[pending[s:e]] = _smallest(key, ns)
    found = (key_out != _KEY_MAX).reshape(b, m, ns)
    idx = torch.where(found, key_out.reshape(b, m, ns) & 0xFFFFFFFF, 0)
    d = take_along_points(coord, idx.reshape(b, -1)).reshape(b, m, ns, 3) - query[:, :, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    if ns < nsample:
        pad = (0, nsample - ns)
        idx = torch.nn.functional.pad(idx, pad, value=0)
        found = torch.nn.functional.pad(found, pad, value=False)
        d2 = torch.nn.functional.pad(d2, pad, value=_BIG)
    if pad_mode == "shadow":
        return torch.where(found, idx, -1), torch.where(found, d2, _BIG)
    # the reference's CUDA query repeats the first found neighbour
    any_found = found[..., :1]
    idx = torch.where(found, idx, torch.where(any_found, idx[..., :1], -1))
    d2 = torch.where(found, d2, torch.where(any_found, d2[..., :1], _BIG))
    return idx, d2


def ball_query(coord: torch.Tensor, mask: torch.Tensor, nsample: int, max_radius: float,
               min_radius: float = 0.0, query: Optional[torch.Tensor] = None,
               query_mask: Optional[torch.Tensor] = None, pad_mode: str = "first"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The lowest-index ``nsample`` valid points whose distance from each
    query lies in [min_radius, max_radius] (both ends inclusive; the JAX
    ``ball_query``, reference pointops.ball_query), ascending. Returns (idx
    [B, M, nsample] int64, dist2 [B, M, nsample] fp32). ``pad_mode``
    "first" repeats the first found neighbour into the unfound slots (the
    reference's CUDA convention; -1 where none is found), "shadow" leaves
    them -1 (torch_points_kernels' partial_dense: KPConv reads a -1 as a
    neighbour that contributes nothing). Squared distances are direct sums
    of squared differences: the JAX expansion form rounds by up to a few
    ulps of |q|^2 + |x|^2, so its band can take or drop a point within that
    of a radius."""
    prio = torch.arange(coord.shape[1], device=coord.device).expand(coord.shape[:2])
    return _priority_ball_query(coord, mask, nsample, max_radius, min_radius, prio, query,
                                query_mask, pad_mode)


def random_ball_query(generator: Optional[torch.Generator], coord: torch.Tensor,
                      mask: torch.Tensor, nsample: int, max_radius: float,
                      min_radius: float = 0.0, query: Optional[torch.Tensor] = None,
                      query_mask: Optional[torch.Tensor] = None, pad_mode: str = "first",
                      priority: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ball_query`` taking random in-band points (the JAX
    ``random_ball_query``, reference pointops.random_ball_query): each row's
    points ranked by a random permutation drawn from ``generator`` (on the
    tensors' device), or by ``priority`` [B, N] (distinct non-negative
    ranks, lower first) when given; the found points in that order."""
    if priority is None:
        shape = coord.shape[:2]
        draw = torch.rand(shape, generator=generator, device=coord.device)
        priority = torch.argsort(torch.argsort(draw, dim=1), dim=1)
    return _priority_ball_query(coord, mask, nsample, max_radius, min_radius, priority, query,
                                query_mask, pad_mode)


def farthest_point_sampling(coord: torch.Tensor, mask: torch.Tensor, num_samples: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched FPS (the JAX ``farthest_point_sampling``, reference
    sampling_cuda_kernel.cu semantics): start at each row's first valid
    point, then greedily take the valid point farthest from the set taken
    (ties to the first index). Returns (idx [B, M] int64, sample_mask
    [B, M]: i < min(M, valid count)). CUDA tensors go through the kernel
    (``ops/fps.py``, one launch), CPU tensors through the plain loop
    ``farthest_point_sampling_reference``; their ids are equal bit for
    bit."""
    if coord.is_cuda:
        idx = fps.farthest_point_sampling_cuda(coord, mask, num_samples)
    else:
        idx = farthest_point_sampling_reference(coord, mask, num_samples)
    return idx, _sample_mask(mask, num_samples)


def _sample_mask(mask: torch.Tensor, num_samples: int) -> torch.Tensor:
    n_valid = mask.sum(1)
    return (torch.arange(num_samples, device=mask.device)
            < n_valid.clamp(max=num_samples)[:, None])


def farthest_point_sampling_reference(coord: torch.Tensor, mask: torch.Tensor,
                                      num_samples: int) -> torch.Tensor:
    """The plain version: the ids [B, M] int64 by a host loop of M - 1
    steps of a few launches each (ties to the first index, as
    ``torch.argmax`` documents; squared distances as (dx dx + dy dy) + dz
    dz, one rounding an operation)."""
    b, n = mask.shape
    dev = coord.device
    c = coord.float()
    iota = torch.arange(n, device=dev)
    first = torch.where(mask, iota, n - 1).amin(1)
    rows = torch.arange(b, device=dev)
    # a padded point keeps -1e10, below every squared distance
    dists = torch.where(mask, _BIG, -_BIG)
    ids, last = [first], first
    for _ in range(1, num_samples):
        d = c - c[rows, last][:, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        dists = torch.minimum(dists, d2)
        last = dists.argmax(1)
        ids.append(last)
    return torch.stack(ids, 1)


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


def attention_relation_step(query: torch.Tensor, key_grouped: torch.Tensor,
                            weight: torch.Tensor) -> torch.Tensor:
    """The channel-weighted q.k of each neighbour slot (reference
    pointops.attention_relation_step): query [B, M, G, C], key_grouped
    [B, M, K, G, C], weight [C] -> [B, M, K, G]."""
    return torch.einsum("bmgc,bmkgc,c->bmkg", query, key_grouped, weight.to(query.dtype))


def attention_fusion_step(weight: torch.Tensor, value_grouped: torch.Tensor) -> torch.Tensor:
    """The weighted sum of the neighbour slots' values (reference
    pointops.attention_fusion_step, whose scatter over shared targets is
    the sum over K here): weight [B, M, K, G], value_grouped [B, M, K, G, C]
    -> [B, M, G, C]."""
    return torch.einsum("bmkg,bmkgc->bmgc", weight.to(value_grouped.dtype), value_grouped)


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
