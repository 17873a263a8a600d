"""Port parity, the Stratified Transformer's point queries: ``ball_query``
(both pad modes, with and without a lower radius) and ``random_ball_query``
against ``scenesplat_tpu/ops/pointops.py`` and a float64 brute force, the
expansion form's fault at a radius on a lattice, ``knn`` where a query's
cells hold fewer than k points, and the relation and fusion steps.

The port's squared distances are direct sums of squared differences; the
JAX package's are |q|^2 + |x|^2 - 2 q.x, which rounds by up to a few fp32
ulps of |q|^2 + |x|^2. On random clouds a query's neighbours are held to
the float64 band exactly, and to JAX's, except for queries with a
candidate whose exact squared distance lies within 8 such ulps of a
radius's square (``_uncertain``): there either side may keep or drop it.
The relation and fusion steps (einsums) to 1e-6 of their scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

ULPS = 8


def _cloud(seed, b=2, n=300, m=120, extent=1.0):
    """Data [b, n, 3] in an ``extent`` cube shifted 3 m from the origin
    (coordinates of metres, as a room's) and queries [b, m, 3] near data
    points (the last 10 far away), padding tails of 37 data and 23 query
    slots on row 1."""
    rng = np.random.default_rng(seed)
    data = (3.0 + rng.uniform(0, extent, (b, n, 3))).astype(np.float32)
    query = (data[:, :m] + rng.normal(0, 0.05, (b, m, 3))).astype(np.float32)
    query[:, -10:] += 10.0
    mask = np.ones((b, n), bool)
    qmask = np.ones((b, m), bool)
    mask[1, n - 37:] = False
    qmask[1, m - 23:] = False
    return data, mask, query, qmask


def _ball64(data, mask, query, qmask, nsample, rmax, rmin):
    """float64 brute force: each query's valid points with rmin^2 <= d^2 <=
    rmax^2, the lowest ``nsample`` indices ascending; and whether a
    candidate's d^2 lies within ULPS ulps of |q|^2 + |x|^2 of a bound."""
    b, m = qmask.shape
    found = [[[] for _ in range(m)] for _ in range(b)]
    uncertain = np.zeros((b, m), bool)
    eps = ULPS * np.finfo(np.float32).eps
    for r in range(b):
        q64, x64 = query[r].astype(np.float64), data[r].astype(np.float64)
        d2 = np.square(q64[:, None] - x64[None]).sum(-1)
        tol = eps * (np.square(q64).sum(-1)[:, None] + np.square(x64).sum(-1)[None])
        near = np.abs(d2 - rmax ** 2) <= tol
        if rmin > 0:  # a squared distance of 0 is in a band from 0 whatever its rounding
            near |= np.abs(d2 - rmin ** 2) <= tol
        near &= mask[r]
        uncertain[r] = near.any(1)
        band = (d2 >= rmin ** 2) & (d2 <= rmax ** 2) & mask[r]
        for q in np.nonzero(qmask[r])[0]:
            found[r][q] = list(np.nonzero(band[q])[0][:nsample])
    return found, uncertain


def _check_layout(idx, d2, found, qmask, pad_mode, data, query):
    """The slots of each valid query: its found points in order, then -1
    ("shadow") or the first one again ("first"; -1 when none), with their
    squared distances (1e10 where -1); a padded query's all -1."""
    b, m, ns = idx.shape
    for r in range(b):
        for q in range(m):
            f = found[r][q] if qmask[r, q] else []
            want = f + ([-1] if pad_mode == "shadow" or not f else [f[0]]) * (ns - len(f))
            assert list(idx[r, q]) == want, (pad_mode, r, q)
            ok = idx[r, q] >= 0
            exact = np.square(data[r, idx[r, q][ok]].astype(np.float64) - query[r, q]).sum(-1)
            np.testing.assert_allclose(d2[r, q][ok], exact, rtol=1e-5, atol=1e-7)
            assert (d2[r, q][~ok] == 1e10).all()


@pytest.mark.parametrize("pad_mode", ["first", "shadow"])
@pytest.mark.parametrize("rmin", [0.0, 0.1])
def test_ball_query_matches_jax(pad_mode, rmin):
    """A separate query set and the data itself (its points at distance 0
    kept when rmin is 0): the port's slots equal the float64 band's, and
    JAX's except at queries with a candidate within rounding of a radius."""
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    data, mask, query, qmask = _cloud(11 if rmin else 12)
    counts = []
    for q, qm in ((query, qmask), (data, mask)):
        idx, d2 = po.ball_query(torch.from_numpy(data), torch.from_numpy(mask), 12, 0.3,
                                min_radius=rmin, query=torch.from_numpy(q),
                                query_mask=torch.from_numpy(qm), pad_mode=pad_mode)
        jidx, _ = jax.jit(lambda d, m, qq, qqm: jpo.ball_query(
            d, m, 12, 0.3, min_radius=rmin, query=qq, query_mask=qqm, tile=64,
            pad_mode=pad_mode))(jnp.asarray(data), jnp.asarray(mask), jnp.asarray(q),
                                jnp.asarray(qm))
        found, uncertain = _ball64(data, mask, q, qm, 12, 0.3, rmin)
        _check_layout(idx.numpy(), d2.numpy(), found, qm, pad_mode, data, q)
        same = (np.asarray(jidx) == idx.numpy()).all(-1)
        assert same[~uncertain].all()
        assert (~uncertain).mean() > 0.8
        counts += [len(f) for row in found for f in row]
    # full tables, and short ones (the padded slots' path)
    assert 12 in counts and any(0 < c < 12 for c in counts)


def test_ball_query_expansion_form_moves_edge_members():
    """Around each of 20 queries at 4 to 5 m from the origin, 12 points at
    0.999 of a 2 cm radius, 12 at 1.001 of it (squared: 0.2% of the radius's
    square, 8e-7 m^2, inside or outside) and 20 well inside, as the
    near-ties of a lattice place them: the port's band is the float64 one
    exactly (its direct differences round by about 1e-7 of themselves),
    while the JAX form rounds |q|^2 ~ 50 m^2 by a few 1e-6 m^2 and takes or
    drops some of the edge points (ROADMAP Queue 3: a fault of the JAX
    package that the port avoids)."""
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    rng = np.random.default_rng(5)
    r = 0.02

    def around(c, k, scale):
        u = rng.normal(size=(k, 3))
        return c + r * scale[:, None] * u / np.linalg.norm(u, axis=1, keepdims=True)

    centres = rng.uniform(4, 5, (20, 3))
    rings = [np.concatenate([around(c, 12, np.full(12, 0.999)), around(c, 12, np.full(12, 1.001)),
                             around(c, 20, rng.uniform(0, 0.8, 20))]) for c in centres]
    data = np.concatenate([centres] + rings).astype(np.float32)[None]
    query = data[:, :20]
    mask, qmask = np.ones(data.shape[:2], bool), np.ones((1, 20), bool)
    ns = 64
    idx, d2 = po.ball_query(torch.from_numpy(data), torch.from_numpy(mask), ns, r,
                            query=torch.from_numpy(query), pad_mode="shadow")
    found, uncertain = _ball64(data, mask, query, qmask, ns, r, 0.0)
    _check_layout(idx.numpy(), d2.numpy(), found, qmask, "shadow", data, query)
    assert uncertain.all()  # every query has edge points within the JAX form's rounding
    jidx = np.asarray(jpo.ball_query(jnp.asarray(data), jnp.asarray(mask), ns, r,
                                     query=jnp.asarray(query), pad_mode="shadow")[0])
    differ = (jidx != idx.numpy()).any(-1)
    assert differ.mean() > 0.2, differ.mean()


def test_random_ball_query_in_band_without_repeats():
    """In the band, no point twice, the same draw from the same generator
    seed (and another from another), and with index priority it is
    ball_query."""
    from scenesplat_tpu_torch.ops import pointops as po

    data, mask, query, qmask = _cloud(13)
    t = {k: torch.from_numpy(v) for k, v in dict(d=data, m=mask, q=query, qm=qmask).items()}

    def draw(seed):
        return po.random_ball_query(torch.Generator().manual_seed(seed), t["d"], t["m"], 8, 0.4,
                                    min_radius=0.05, query=t["q"], query_mask=t["qm"],
                                    pad_mode="shadow")

    idx, d2 = draw(0)
    idx, d2 = idx.numpy(), d2.numpy()
    ok = idx >= 0
    assert ok.any() and ((d2[ok] >= 0.05 ** 2 * (1 - 1e-6)) & (d2[ok] <= 0.16 * (1 + 1e-6))).all()
    for r, q in zip(*np.nonzero(qmask)):
        row = idx[r, q][ok[r, q]]
        assert len(set(row)) == len(row) and mask[r, row].all()
    found, _ = _ball64(data, mask, query, qmask, 10 ** 6, 0.4, 0.05)
    counts = np.array([[min(len(f), 8) for f in fr] for fr in found])
    assert np.array_equal(ok.sum(-1), np.where(qmask, counts, 0))
    assert np.array_equal(draw(0)[0].numpy(), idx)
    assert not np.array_equal(draw(1)[0].numpy(), idx)
    prio = torch.arange(data.shape[1]).expand(mask.shape)
    for pad_mode in ("first", "shadow"):
        got = po.random_ball_query(None, t["d"], t["m"], 8, 0.4, min_radius=0.05, query=t["q"],
                                   query_mask=t["qm"], pad_mode=pad_mode, priority=prio)
        want = po.ball_query(t["d"], t["m"], 8, 0.4, min_radius=0.05, query=t["q"],
                             query_mask=t["qm"], pad_mode=pad_mode)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_knn_with_fewer_candidates_than_k_in_its_cells():
    """A query whose 27 cells hold fewer than k points (two points 5 m from
    a dense cube) gets its k nearest, as the float64 brute force: the
    first pass had filled the missing slots with the int64 minimum, read as
    index 0 at distance -0 and taken as settled."""
    from scenesplat_tpu_torch.ops import pointops as po

    rng = np.random.default_rng(3)
    data = np.concatenate([rng.uniform(0, 1, (1, 100, 3)),
                           [[[5.0, 5.0, 5.0], [5.01, 5.0, 5.0]]]], 1).astype(np.float32)
    mask = np.ones(data.shape[:2], bool)
    idx, dist = po.knn(torch.from_numpy(data), torch.from_numpy(mask), 4)
    d64 = np.sqrt(np.square(data[0, :, None].astype(np.float64) - data[0, None]).sum(-1))
    for q in (100, 101):
        want = np.lexsort((np.arange(102), d64[q]))[:4]
        assert list(idx[0, q].numpy()) == list(want)
        np.testing.assert_allclose(dist[0, q].numpy(), d64[q, want], rtol=1e-6)


def test_relation_and_fusion_steps_equal_jax():
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 10, 4, 8)).astype(np.float32)
    kg = rng.normal(size=(2, 10, 6, 4, 8)).astype(np.float32)
    w = rng.normal(size=(8,)).astype(np.float32)
    rel = po.attention_relation_step(torch.from_numpy(q), torch.from_numpy(kg),
                                     torch.from_numpy(w)).numpy()
    want = np.asarray(jpo.attention_relation_step(jnp.asarray(q), jnp.asarray(kg), jnp.asarray(w)))
    np.testing.assert_allclose(rel, want, atol=1e-6 * np.abs(want).max())
    fused = po.attention_fusion_step(torch.from_numpy(rel), torch.from_numpy(kg)).numpy()
    want = np.asarray(jpo.attention_fusion_step(jnp.asarray(rel), jnp.asarray(kg)))
    np.testing.assert_allclose(fused, want, atol=1e-6 * np.abs(want).max())
