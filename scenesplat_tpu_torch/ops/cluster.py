"""PointGroup's proposal clustering (the port's counterpart of
``scenesplat_tpu/native/__init__.py:pointgroup_cluster`` and its C++ op,
``native/host_ops.cpp``): connected components of the same-label radius
graph over the bias-shifted centres, in voxel units.

One implementation in torch, on the tensors' device. The points are sorted
by (label, cell), cells of ``radius`` on a side, as the C++ op's grid hash
buckets them; each point's candidates are the points after it in its own
cell and all the points of the 13 neighbour cells of one half of the
neighbourhood (each unordered pair once), found by ``searchsorted``. The
candidate pairs are enumerated in chunks of a bounded size: shifted centres
pile up by design, and a pile of P points in one cell gives P^2 / 2 pairs.
A pair is an edge where the squared distance, summed in float32 as the C++
op sums it, is at most radius^2. Each chunk's edges hook the larger of the
two current roots under the smaller (a scatter of minima) and pointer
jumping flattens the forest, until the chunk's edges join no two roots, so
each component's root is its lowest index. Components of fewer than
``min_points`` points get -1; the others are numbered in the order of
their lowest index, which is the C++ op's order.

The reference also caps each point's neighbours at ``cluster_closed_points``
(pointgroup_ops' ball query); the JAX op does not, nor does this one
(ROADMAP Queue 3)."""

from __future__ import annotations

import itertools
from typing import Tuple

import torch

# the 13 cell offsets lexicographically above (0, 0, 0): with the pairs
# inside a cell, each unordered pair of points in adjacent cells once
_HALF_OFFSETS = tuple(o for o in itertools.product((-1, 0, 1), repeat=3) if o > (0, 0, 0))
PAIRS_PER_CHUNK = 1 << 23


def _flatten(parent: torch.Tensor) -> torch.Tensor:
    """Pointer jumping until every node points at its root."""
    while True:
        nxt = parent[parent]
        if torch.equal(nxt, parent):
            return parent
        parent = nxt


def _join(parent: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge the components of the edges (a, b) into ``parent`` (flat: every
    node points at its root, the lowest index of its component so far)."""
    while a.numel():
        ra, rb = parent[a], parent[b]
        apart = ra != rb
        if not apart.any():
            break
        a, b, ra, rb = a[apart], b[apart], ra[apart], rb[apart]
        parent = parent.scatter_reduce(0, torch.maximum(ra, rb), torch.minimum(ra, rb), "amin")
        parent = _flatten(parent)
    return parent


def pointgroup_cluster(coord: torch.Tensor, labels: torch.Tensor, radius: float,
                       min_points: int) -> Tuple[torch.Tensor, int]:
    """coord [n, 3] (float32 centres, voxel units), labels [n] int ->
    (cluster id [n] int64, -1 where unclustered; the number of clusters)."""
    n = coord.shape[0]
    dev = coord.device
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev), 0
    coord = coord.float().contiguous()
    # the C++ op's cells: floor(coord / radius) in float32
    cell = torch.floor(coord / torch.full_like(coord, radius)).long()
    cell = cell - cell.min(0).values + 1  # neighbours stay inside [0, dims)
    dims = (cell.max(0).values + 2).tolist()
    _, lab = torch.unique(labels, return_inverse=True)
    n_lab = int(lab.max()) + 1
    if n_lab * dims[0] * dims[1] * dims[2] >= 1 << 62:
        raise ValueError(f"centres span {dims} cells of {radius}: too wide to key")
    key = ((lab * dims[0] + cell[:, 0]) * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    skey, order = torch.sort(key, stable=True)
    scoord = coord[order]

    # candidate ranges [start, end) of sorted positions: one row per point
    # and offset, the own cell's first (the points after it in the cell)
    pos = torch.arange(n, device=dev)
    starts = [pos + 1]
    ends = [torch.searchsorted(skey, skey, right=True)]
    for dx, dy, dz in _HALF_OFFSETS:
        nkey = skey + (dx * dims[1] + dy) * dims[2] + dz
        starts.append(torch.searchsorted(skey, nkey))
        ends.append(torch.searchsorted(skey, nkey, right=True))
    starts = torch.stack(starts, 1).reshape(-1)  # row = point * 14 + offset
    counts = (torch.stack(ends, 1).reshape(-1) - starts).clamp_(min=0)
    cum = torch.cumsum(counts, 0)
    total = int(cum[-1])

    parent = torch.arange(n, device=dev)
    if total:
        # chunks of whole rows, each under 2 * chunk pairs (a row holds at
        # most n); chunk k ends at the last row whose pairs end by k * chunk
        chunk = max(PAIRS_PER_CHUNK, n)
        targets = torch.arange(1, -(-total // chunk) + 1, device=dev) * chunk
        bounds = [0] + torch.searchsorted(cum, targets, right=True).tolist()
        done = [0] + cum[torch.tensor(bounds[1:], device=dev) - 1].tolist()
        r = torch.tensor(radius, dtype=torch.float32, device=dev)
        r2 = r * r  # float32, as the C++ op's radius * radius
        for r0, r1, p0, p1 in zip(bounds[:-1], bounds[1:], done[:-1], done[1:]):
            if p1 == p0:
                continue
            cnt = counts[r0:r1]
            row = torch.repeat_interleave(torch.arange(r0, r1, device=dev), cnt,
                                          output_size=p1 - p0)
            first = cum[r0:r1] - cnt - p0  # each row's first pair in the chunk
            q = starts[row] + (torch.arange(p1 - p0, device=dev) - first[row - r0])
            p = row // (1 + len(_HALF_OFFSETS))
            d = scoord[q] - scoord[p]
            d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
            edge = d2 <= r2
            parent = _join(parent, order[p[edge]], order[q[edge]])

    size = torch.bincount(parent, minlength=n)
    kept = (size >= min_points) & (parent == torch.arange(n, device=dev))  # roots
    ids = torch.cumsum(kept, 0) - 1
    cluster = torch.where(kept[parent], ids[parent], -1)
    return cluster, int(kept.sum())
