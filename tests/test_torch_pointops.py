"""Port parity, Masked Scene Contrast's point queries: ``knn`` with a
radius (the in-radius part of the JAX brute-force ``knn``) and
``grid_cluster_plan`` against ``scenesplat_tpu/ops/pointops.py`` on the
same padded numpy clouds.

The port's ``knn`` computes direct differences and is held to a float64 brute
force exactly (indices) and to 1e-6 (distances), and to the JAX ``knn``'s
in-radius sets where no distance lies within rounding of the radius: the
JAX matrix-product form |q|^2 + |x|^2 - 2 q.x loses up to a few fp32 ulps
of |q|^2 + |x|^2 to cancellation (8 ulps of that scale are allowed). The
clusterings are integer plans: equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
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
    """float64 reference of knn with a radius: nearest first, ties to the lower
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
    from scenesplat_tpu_torch.ops.pointops import knn

    data, mask, query, qmask = _cloud(1, n=600, m=500, extent=0.6)
    got = knn(*map(torch.from_numpy, (data, mask)), 8, query=torch.from_numpy(query),
              query_mask=torch.from_numpy(qmask), radius=radius)
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
    from scenesplat_tpu_torch.ops.pointops import knn

    rng = np.random.default_rng(3)
    data = rng.uniform(0, 0.1, (2, 5, 3)).astype(np.float32)
    mask = np.ones((2, 5), bool)
    mask[1, 4] = False
    gi, gd = (t.numpy() for t in knn(*map(torch.from_numpy, (data, mask)), 8, radius=1.0))
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


# ---- Point Transformer V1/V2's point queries ----------------------------------------


def _brute_knn64(data, mask, query, qmask, k):
    """float64 reference of knn: the k nearest valid points, nearest first,
    ties to the lower index; -1 past the valid count and on padded
    queries."""
    b, m = qmask.shape
    idx = np.full((b, m, k), -1)
    dist = np.full((b, m, k), np.sqrt(1e10))
    for r in range(b):
        d2 = np.square(query[r, :, None].astype(np.float64) - data[r, None]).sum(-1)
        for q in np.nonzero(qmask[r])[0]:
            order = [j for j in np.lexsort((np.arange(d2.shape[1]), d2[q])) if mask[r, j]][:k]
            idx[r, q, :len(order)] = order
            dist[r, q, :len(order)] = np.sqrt(d2[q, order])
    return idx, dist


@pytest.mark.parametrize("k", [3, 8, 16])
def test_knn_with_a_query_set_equals_jax(k):
    """A separate query set (queries inside and around the data, a padded
    tail) and a row of 12 valid points (fewer than 16): JAX's indices
    exactly, and the float64 brute force's; distances to 1e-6 of the
    brute force's and to JAX's within its matrix-product rounding (8 fp32
    ulps of |q|^2 + |x|^2 in the squared distance)."""
    from scenesplat_tpu.ops.pointops import knn as jknn
    from scenesplat_tpu_torch.ops.pointops import knn

    data, mask, query, qmask = _cloud(5, n=300, m=250, extent=1.0)
    query[:, -20:] -= 10.5  # far outside the data: still the k nearest
    mask[0, 12:] = False  # 12 valid points
    got = knn(*map(torch.from_numpy, (data, mask)), k, query=torch.from_numpy(query),
              query_mask=torch.from_numpy(qmask))
    gi, gd = (t.numpy() for t in got)
    ji, jd = (np.asarray(t) for t in jknn(*map(jnp.asarray, (data, mask)), k,
                                          query=jnp.asarray(query), query_mask=jnp.asarray(qmask)))
    wi, wd = _brute_knn64(data, mask, query, qmask, k)
    assert np.array_equal(gi, ji) and np.array_equal(gi, wi)
    np.testing.assert_allclose(gd, wd, rtol=1e-6, atol=1e-7)
    ok = gi >= 0
    tol = _tol(data, query)
    assert (np.abs(gd.astype(np.float64) ** 2 - jd.astype(np.float64) ** 2)[ok]
            <= np.broadcast_to(tol, gd.shape)[ok]).all()
    if k > 12:
        assert (gi[0, :, 12:] == -1).all()


def test_knn_self_query_equals_jax():
    """The query defaults to the data (PTv2's BlockSequence), on clouds of
    3 densities in one batch: the float64 brute force's indices in its
    order, and JAX's sets (3 of its 1,500 rows order two neighbours whose
    squared distances differ by less than its rounding the other way)."""
    from scenesplat_tpu.ops.pointops import knn as jknn
    from scenesplat_tpu_torch.ops.pointops import knn

    rng = np.random.default_rng(8)
    data = np.stack([rng.uniform(0, e, (500, 3)) for e in (0.3, 0.6, 1.0)]).astype(np.float32)
    mask = np.ones((3, 500), bool)
    mask[2, 450:] = False
    gi = knn(torch.from_numpy(data), torch.from_numpy(mask), 16)[0].numpy()
    ji = np.asarray(jknn(jnp.asarray(data), jnp.asarray(mask), 16)[0])
    assert np.array_equal(gi, _brute_knn64(data, mask, data, mask, 16)[0])
    assert np.array_equal(np.sort(gi, -1), np.sort(ji, -1))


def test_knn_matrix_product_form_differs_on_a_lattice():
    """On a metre-scale lattice (2 cm spacing, 5 m from the origin) the
    distances of the fp32 coordinates nearly tie (by a few 1e-5 of
    themselves); the port's direct differences order them as the float64
    brute force does, while the JAX form |q|^2 + |x|^2 - 2 q.x rounds
    |q|^2 ~ 75 m^2 by about 5e-6 m^2, 1% of a squared 2 cm, and picks
    other neighbours (ROADMAP Queue 3: a fault of the JAX package that the
    port avoids)."""
    from scenesplat_tpu.ops.pointops import knn as jknn
    from scenesplat_tpu_torch.ops.pointops import knn

    g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
    data = (5.0 + g * 0.02).astype(np.float32)[None]
    mask = np.ones(data.shape[:2], bool)
    gi = knn(torch.from_numpy(data), torch.from_numpy(mask), 8)[0].numpy()
    wi, _ = _brute_knn64(data, mask, data, mask, 8)
    ji = np.asarray(jknn(jnp.asarray(data), jnp.asarray(mask), 8)[0])
    assert np.array_equal(gi, wi)
    differ = (np.sort(ji, -1) != np.sort(wi, -1)).any(-1)
    assert differ.mean() > 0.1, differ.mean()


def test_farthest_point_sampling_equals_jax():
    """Rows of 400, 250 and 60 valid slots (the last fewer than the 100
    samples): JAX's indices and sample mask exactly."""
    from scenesplat_tpu.ops.pointops import farthest_point_sampling as jfps
    from scenesplat_tpu_torch.ops.pointops import farthest_point_sampling

    rng = np.random.default_rng(6)
    data = rng.uniform(0, 2, (3, 400, 3)).astype(np.float32)
    mask = np.arange(400) < np.array([400, 250, 60])[:, None]
    mask[1, :5] = False  # the first valid point is not slot 0
    gi, gm = (t.numpy() for t in farthest_point_sampling(
        torch.from_numpy(data), torch.from_numpy(mask), 100))
    ji, jm = (np.asarray(t) for t in jfps(jnp.asarray(data), jnp.asarray(mask), 100))
    assert np.array_equal(gi, ji) and np.array_equal(gm, jm)
    assert gi[1, 0] == 5 and gm[2].sum() == 60


@pytest.mark.parametrize("points_of_blocks,extra,blocks,spill", [
    (1, 0, 1, False), (1, 1, 2, False), (2, 0, 2, False), (2, 1, 4, False),
    (4, 0, 4, False), (4, 1, 8, False), (8, 0, 8, False), (8, 1, 16, False),
    (16, 0, 16, False), (16, 1, 16, True), (40, 0, 16, True),
])
def test_fps_blocks_per_row_at_each_edge(points_of_blocks, extra, blocks, spill):
    """The FPS kernel's blocks a row: the fewest of 1, 2, 4, 8, 16 whose
    shared memory holds the row (``BLOCK_POINTS`` a block), 16 with the
    rest in the scratch row past that; at each count's capacity and one
    point more."""
    from scenesplat_tpu_torch.ops import fps

    n = points_of_blocks * fps.BLOCK_POINTS + extra
    assert (fps.blocks_per_row(n), fps.spills(n)) == (blocks, spill)


def test_fps_blocks_per_row_on_the_model_rows():
    """ST's five levels of the train rows (205,824 slots), PTv1's 4,096 and
    PartSeg's 2,048: the stem's row whole in 16 blocks, the next level's in
    4, every other row in one block; no row spills. The wrapper takes CUDA
    tensors only."""
    from scenesplat_tpu_torch.ops import fps

    st = [205824, 51457, 12865, 3217, 805]
    assert [fps.blocks_per_row(n) for n in st] == [16, 4, 1, 1, 1]
    assert [fps.blocks_per_row(n) for n in (4096, 1024, 2048, 512, 1)] == [1] * 5
    assert not any(fps.spills(n) for n in st + [4096, 2048])
    with pytest.raises(ValueError, match="CUDA"):
        fps.farthest_point_sampling_cuda(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=torch.bool),
                                         2)


def _idw64(src, dst, feat, idx):
    """float64 inverse-distance interpolation over given neighbours."""
    b, m, k = idx.shape
    out = np.zeros((b, m, feat.shape[-1]))
    for r in range(b):
        for q in range(m):
            j = idx[r, q][idx[r, q] >= 0]
            if not len(j):
                continue
            w = 1.0 / (np.linalg.norm(src[r, j].astype(np.float64) - dst[r, q], axis=-1) + 1e-8)
            out[r, q] = (w[:, None] * feat[r, j]).sum(0) / w.sum()
    return out


def test_grouping_interpolation_aggregation_equal_jax():
    """grouping with and without the offsets (invalid slots zero), the
    grouped aggregation and subtraction to 1e-6 of JAX's on kNN indices
    equal to JAX's; interpolation from a coarse set onto a fine one
    (padded destinations zero) on JAX's neighbours, to 1e-6 of a float64
    interpolation over them (JAX's own weights read its matrix-product
    distances, see test_knn_matrix_product_form_misses_near_distances)."""
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    data, mask, query, qmask = _cloud(7, n=200, m=120, extent=1.0)
    rng = np.random.default_rng(9)
    feat = rng.normal(size=(2, 200, 8)).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in dict(d=data, m=mask, q=query, qm=qmask, f=feat).items()}
    idx = po.knn(t["d"], t["m"], 8, query=t["q"], query_mask=t["qm"])[0]
    jidx = jpo.knn(jnp.asarray(data), jnp.asarray(mask), 8, query=jnp.asarray(query),
                   query_mask=jnp.asarray(qmask))[0]
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    for with_xyz in (False, True):
        got = po.grouping(idx, t["f"], t["d"], query_coord=t["q"], with_xyz=with_xyz).numpy()
        want = np.asarray(jpo.grouping(jidx, jnp.asarray(feat), jnp.asarray(data),
                                       query_coord=jnp.asarray(query), with_xyz=with_xyz))
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert (got[idx.numpy() < 0] == 0).all()
    got = po.interpolation(t["q"], t["qm"], t["d"], t["m"], t["f"][:, :120]).numpy()
    nbr = po.knn(t["q"], t["qm"], 3, query=t["d"], query_mask=t["m"])[0].numpy()
    jnbr = np.asarray(jpo.knn(jnp.asarray(query), jnp.asarray(qmask), 3, query=jnp.asarray(data),
                              query_mask=jnp.asarray(mask))[0])
    assert np.array_equal(nbr, jnbr)
    want = _idw64(query, data, feat[:, :120], jnbr)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max())
    assert (got[~mask] == 0).all()
    vg = rng.normal(size=(2, 120, 8, 12)).astype(np.float32)
    w = rng.normal(size=(2, 120, 8, 3)).astype(np.float32)
    np.testing.assert_allclose(
        po.aggregation(torch.from_numpy(vg), torch.from_numpy(w), 3).numpy(),
        np.asarray(jpo.aggregation(jnp.asarray(vg), jnp.asarray(w), 3)), atol=1e-6)
    q = rng.normal(size=(2, 120, 12)).astype(np.float32)
    np.testing.assert_array_equal(po.subtraction(torch.from_numpy(q), torch.from_numpy(vg)).numpy(),
                                  np.asarray(jpo.subtraction(jnp.asarray(q), jnp.asarray(vg))))


def test_knn_matrix_product_form_misses_near_distances():
    """Destinations 2 mm from a source, at coordinates of metres (a point
    beside its cluster's mean, as PTv2's interp unpooling meets them): the
    port's distances are the float64 ones to 1e-6 of themselves, so its
    interpolation weights are; the JAX form's err by more than 1e-2 of
    themselves for some (ROADMAP Queue 3)."""
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    rng = np.random.default_rng(4)
    src = rng.uniform(1, 3, (1, 200, 3)).astype(np.float32)
    dst = (src[:, :50] + rng.normal(0, 0.002, (1, 50, 3))).astype(np.float32)
    ones = np.ones((1, 200), bool)
    got = po.knn(torch.from_numpy(src), torch.from_numpy(ones), 1, query=torch.from_numpy(dst))
    jd = np.asarray(jpo.knn(jnp.asarray(src), jnp.asarray(ones), 1, query=jnp.asarray(dst))[1])
    assert np.array_equal(got[0].numpy()[0, :, 0], np.arange(50))
    want = np.linalg.norm(src[0, :50].astype(np.float64) - dst[0], axis=-1)
    np.testing.assert_allclose(got[1].numpy()[0, :, 0], want, rtol=1e-6)
    assert (np.abs(jd[0, :, 0] - want) / want).max() > 1e-2
