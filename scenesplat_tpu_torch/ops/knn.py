"""k nearest neighbours of 3-D points, for the evaluation's neighbour voting
(in place of the JAX package's host C++ grid search ``native.knn`` and its
cKDTree fallback; the JAX package computes this on the host, outside any
Pallas kernel, so this is plain PyTorch).

On a CUDA device: brute force, the squared distances of a chunk of queries
to all data points, then ``topk``. The distances are sums of squared
coordinate differences, not the matrix-product form |a|^2 + |b|^2 - 2ab
(``torch.cdist``'s fast path), whose fp32 cancellation at coordinates of
metres and neighbour distances of centimetres would reorder near
neighbours; ``torch.cdist``'s own direct mode is an order of magnitude
slower than these three broadcast passes. On the CPU:
``scipy.spatial.cKDTree``. Both return each query's neighbours nearest
first; they pick the same sets where distances do not tie."""

from __future__ import annotations

import numpy as np
import torch

# bound on the elements of one chunk's distance matrix (1 GiB in fp32)
_PAIRS_PER_CHUNK = 1 << 28


def knn(data: np.ndarray, query: np.ndarray, k: int, device="cpu") -> np.ndarray:
    """Indices [m, k] (int64) into ``data`` [n, 3] of the k nearest points
    of each ``query`` [m, 3] row; k is cut to n."""
    k = min(k, data.shape[0])
    device = torch.device(device)
    if device.type == "cpu":
        from scipy.spatial import cKDTree

        _, idx = cKDTree(data).query(query, k=k, workers=-1)
        return np.asarray(idx, np.int64).reshape(query.shape[0], k)
    d = torch.from_numpy(np.ascontiguousarray(data, np.float32).T.copy()).to(device)  # [3, n]
    q = torch.from_numpy(np.ascontiguousarray(query, np.float32)).to(device)
    rows = max(1, _PAIRS_PER_CHUNK // d.shape[1])
    out = torch.empty(q.shape[0], k, dtype=torch.int64, device=device)
    for s in range(0, q.shape[0], rows):
        chunk = q[s:s + rows]
        dist2 = (chunk[:, 0:1] - d[0]).square_()
        for axis in (1, 2):
            dist2.add_((chunk[:, axis:axis + 1] - d[axis]).square_())
        out[s:s + rows] = dist2.topk(k, dim=1, largest=False).indices
    return out.cpu().numpy()
