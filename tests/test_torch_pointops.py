"""Port parity, Masked Scene Contrast's point queries: ``knn_radius`` (the
in-radius part of the JAX brute-force ``knn``, from a cell hash) and
``grid_cluster_plan`` against ``scenesplat_tpu/ops/pointops.py`` on the
same padded numpy clouds.

``knn_radius`` computes direct differences and is held to a float64 brute
force exactly (indices) and to 1e-6 (distances), and to the JAX ``knn``'s
in-radius sets where no distance lies within rounding of the radius: the
JAX matrix-product form |q|^2 + |x|^2 - 2 q.x loses up to a few fp32 ulps
of |q|^2 + |x|^2 to cancellation (8 ulps of that scale are allowed). The
clusterings are integer plans: equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

ULPS = 8


def _cloud(seed, b=2, n=300, m=250, extent=2.0):
    """Data [b, n, 3] and queries [b, m, 3] in an ``extent`` cube (queries
    are data points moved by a few cm, the last 20 far away), with padding
    tails of 37 data and 23 query slots on row 1."""
    rng = np.random.default_rng(seed)
    data = rng.uniform(0, extent, (b, n, 3)).astype(np.float32)
    query = data[:, :m] + rng.normal(0, 0.02, (b, m, 3)).astype(np.float32)
    query[:, -20:] += 10.0  # no neighbour within any small radius
    mask = np.ones((b, n), bool)
    qmask = np.ones((b, m), bool)
    mask[1, n - 37:] = False
    qmask[1, m - 23:] = False
    return data, mask, query, qmask


def _tol(data, query):
    """8 fp32 ulps of each query's |q|^2 + max |x|^2, [b, m, 1]."""
    scale = np.square(query).sum(-1)[..., None] + np.square(data).sum(-1).max()
    return ULPS * np.finfo(np.float32).eps * scale


def _brute64(data, mask, query, qmask, k, radius):
    """float64 reference of knn_radius: nearest first, ties to the lower
    index, strictly inside ``radius``."""
    b, m = qmask.shape
    idx = np.full((b, m, k), -1)
    dist = np.full((b, m, k), np.sqrt(1e10))
    for r in range(b):
        d2 = np.square(query[r, :, None].astype(np.float64) - data[r, None]).sum(-1)
        d2[:, ~mask[r]] = np.inf
        for q in np.nonzero(qmask[r])[0]:
            order = np.lexsort((np.arange(d2.shape[1]), d2[q]))
            inside = [j for j in order[:k] if d2[q, j] < radius ** 2]
            idx[r, q, :len(inside)] = inside
            dist[r, q, :len(inside)] = np.sqrt(d2[q, inside])
    return idx, dist


@pytest.mark.parametrize("radius", [0.03, 0.12])
def test_knn_radius_is_the_in_radius_knn(radius):
    """MSC's matching (8 nearest, then the partners closer than the radius):
    the float64 brute force exactly, and the JAX brute force's in-radius
    sets where no distance lies within rounding of the radius; queries far
    from every point (no neighbour) and padded queries give -1 rows."""
    from scenesplat_tpu.ops.pointops import knn as jknn
    from scenesplat_tpu_torch.ops.pointops import knn_radius

    data, mask, query, qmask = _cloud(1, n=600, m=500, extent=0.6)
    got = knn_radius(*map(torch.from_numpy, (data, mask)), 8, radius,
                     query=torch.from_numpy(query), query_mask=torch.from_numpy(qmask))
    gi, gd = (t.numpy() for t in got)
    wi, wd = _brute64(data, mask, query, qmask, 8, radius)
    assert np.array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-7)
    assert (gi[:, -20:] == -1).all() and (gi[1, ~qmask[1]] == -1).all()
    assert 0 < (gi >= 0).sum(-1).mean() < 8

    ji, jd = jknn(jnp.asarray(data), jnp.asarray(mask), 8, query=jnp.asarray(query),
                  query_mask=jnp.asarray(qmask))
    ji, jd = np.asarray(ji), np.asarray(jd)
    tol = _tol(data, query)
    clear = (np.abs(wd.astype(np.float64) ** 2 - radius ** 2) > tol).all(-1) & (
        np.abs(jd.astype(np.float64) ** 2 - radius ** 2) > tol).all(-1)
    assert clear.mean() > 0.9
    for r, q in zip(*np.nonzero(clear)):
        want = set(ji[r, q][(ji[r, q] >= 0) & (jd[r, q] < radius)].tolist())
        assert set(gi[r, q][gi[r, q] >= 0].tolist()) == want


def test_knn_radius_of_a_scene_smaller_than_k():
    """Self-query (the query defaults to the data) of rows of 5 points, one
    padded, k = 8 and every point inside the radius: the trailing slots -1,
    the rest the JAX ``knn``'s neighbours in its order."""
    from scenesplat_tpu.ops.pointops import knn as jknn
    from scenesplat_tpu_torch.ops.pointops import knn_radius

    rng = np.random.default_rng(3)
    data = rng.uniform(0, 0.1, (2, 5, 3)).astype(np.float32)
    mask = np.ones((2, 5), bool)
    mask[1, 4] = False
    gi, gd = (t.numpy() for t in knn_radius(*map(torch.from_numpy, (data, mask)), 8, 1.0))
    ji, jd = (np.asarray(t) for t in jknn(*map(jnp.asarray, (data, mask)), 8))
    assert np.array_equal(gi, ji)
    np.testing.assert_allclose(gd, jd, atol=1e-4)
    assert (gi[..., 5:] == -1).all() and (gi[1, :, 4:] == -1).all() and (gi[1, 4] == -1).all()


def test_grid_cluster_plan_matches_jax():
    """The union-cloud clustering of MSC's cross masks, padded rows included:
    every field of the plan equal but the head of a cluster, which on both
    sides is one of its members (MSC reads only the point-to-cluster map;
    the JAX sort orders equal codes otherwise)."""
    from scenesplat_tpu.ops.pointops import grid_cluster_plan as jplan
    from scenesplat_tpu_torch.ops.pointops import grid_cluster_plan

    data, mask, _, _ = _cloud(2, n=400)
    data = data - 0.7  # negative coordinates: quantized from each row's minimum
    want = jplan(jnp.asarray(data), jnp.asarray(mask), 0.1, 400)
    got = grid_cluster_plan(torch.from_numpy(data), torch.from_numpy(mask), 0.1, 400)
    live = got.out_mask.numpy()
    for field in ("seg_sorted", "cluster_of_point", "counts", "out_mask", "n_clusters"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert np.array_equal(g, w.astype(g.dtype)), field
    cluster = got.cluster_of_point.numpy()
    ids = np.broadcast_to(np.arange(live.shape[1]), live.shape)
    for head in (got.head_index.numpy(), np.asarray(want.head_index)):
        assert np.array_equal(np.take_along_axis(cluster, head, 1)[live], ids[live])
    assert int(got.n_overflow.max()) == 0 and 10 < int(got.n_clusters.min()) < 400
