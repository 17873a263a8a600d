"""Port parity, the sparse-conv backbones' shared ops: ``lookup_voxels``
(one search that the submanifold plans, the transposed conv's corner
lookup and SPVCNN's devoxelization share), ``build_subm_conv_plan`` over it
equal to the plan builder it replaced, OctFormer's depthwise conv
``subm_dwconv_apply``, ``build_corner_lookup`` and ``deconv_k3s2_apply``
against the JAX package (values and gradients, fp32, 1e-5 of the largest
magnitude), and the weights round trip of all 15 MinkUNet variants, SPVCNN,
OACNNs and OctFormer through the JAX converters."""

import copy
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_mink_unet import (  # noqa: E402,F401
    close,
    fill,
    jax_geometry,
    jax_point,
    scene,
    torch_model,
)

RTOL = 1e-5


def _level(seed=0, b=2, n=300, extent=12, pad=(50, 100)):
    """Rows of unique voxels in an ``extent`` cube and a padding tail of
    ``pad[i]`` slots (zeros), numpy [b, n, 3] int32 and [b, n] bool."""
    rng = np.random.default_rng(seed)
    grid = np.zeros((b, n, 3), np.int32)
    mask = np.zeros((b, n), bool)
    for i in range(b):
        cells = np.unique(rng.integers(0, extent, (4 * n, 3)), axis=0)
        cells = cells[rng.permutation(len(cells))][: n - pad[i]]
        grid[i, : len(cells)] = cells
        mask[i, : len(cells)] = True
    return grid, mask


def _previous_plan(grid_coord, mask, kernel_size=3, depth=16):
    """``build_subm_conv_plan`` as it was before ``lookup_voxels`` took its
    search: the same keys, one sort, one searchsorted."""
    from scenesplat_tpu_torch.ops.subm_conv import _PAD_KEY, _voxel_key, kernel_offsets
    from scenesplat_tpu_torch.ops.bitonic_sort import sort_int64

    b, n = mask.shape
    limit = (1 << depth) - 1
    grid = grid_coord.to(torch.int64)
    keys = torch.where(mask, _voxel_key(grid.clamp(0, limit)), _PAD_KEY)
    sorted_keys, sort_idx = sort_int64(keys.reshape(-1))
    offsets = torch.tensor(kernel_offsets(kernel_size), dtype=torch.int64)
    q = grid[:, None, :, :] + offsets[None, :, None, :]
    in_range = ((q >= 0) & (q <= limit)).all(-1) & mask[:, None, :]
    qkey = _voxel_key(q.clamp(0, limit))
    pos = torch.searchsorted(sorted_keys, qkey.reshape(-1)).clamp_(max=b * n - 1)
    found = (sorted_keys[pos] == qkey.reshape(-1)).view(qkey.shape) & in_range
    return sort_idx[pos].view(qkey.shape) % n, found


@pytest.mark.parametrize("kernel_size,depth,duplicates,extent", [
    (3, 16, 0, 12), (5, 16, 0, 12), (3, 16, 30, 12), (3, 4, 0, 20), (5, 10, 20, 12)])
def test_subm_plan_equals_the_previous_builder(kernel_size, depth, duplicates, extent):
    """Bit for bit, with padding, duplicate voxels (Mix3D's merged rooms) and
    coordinates past 2**depth."""
    from scenesplat_tpu_torch.ops.subm_conv import build_subm_conv_plan

    grid, mask = _level(1, extent=extent)
    if duplicates:
        grid[:, 200:200 + duplicates] = grid[:, :duplicates]
    g, m = torch.from_numpy(grid).long(), torch.from_numpy(mask)
    plan = build_subm_conv_plan(g, m, kernel_size, depth)
    index, found = _previous_plan(g, m, kernel_size, depth)
    assert torch.equal(plan.neighbor_valid, found)
    assert torch.equal(plan.neighbor_index, index)


def test_lookup_voxels_finds_each_query():
    """Against a dictionary of each row's voxels: found exactly where a real
    voxel of the row has the coordinates, the index pointing at one."""
    from scenesplat_tpu_torch.ops.subm_conv import lookup_voxels

    grid, mask = _level(2)
    rng = np.random.default_rng(3)
    query = rng.integers(-2, 14, (2, 4, 500, 3))
    index, found = lookup_voxels(torch.from_numpy(grid), torch.from_numpy(mask),
                                 torch.from_numpy(query), depth=16)
    for b in range(2):
        cells = {tuple(c) for c in grid[b][mask[b]]}
        want = np.array([tuple(q) in cells for q in query[b].reshape(-1, 3)])
        assert np.array_equal(found[b].numpy().reshape(-1), want)
        hit = found[b].numpy()
        assert np.array_equal(grid[b][index[b].numpy()[hit]], query[b][hit])
        assert mask[b][index[b].numpy()[hit]].all()


def _jax_plan(grid, mask, kernel_size=3):
    from scenesplat_tpu.ops.subm_conv import build_subm_conv_plan

    return jax.jit(lambda g, m: build_subm_conv_plan(g, m, kernel_size, 16))(
        jnp.asarray(grid), jnp.asarray(mask))


@pytest.mark.parametrize("chunk", [None, 1000], ids=["one_chunk", "chunks"])
def test_subm_dwconv_matches_jax(chunk, monkeypatch):
    """Values and gradients (features, weight, bias); ``chunks``: the
    gather in chunks of 1,000 elements."""
    from scenesplat_tpu.ops.subm_conv import subm_dwconv_apply as jdw
    from scenesplat_tpu_torch.ops import subm_conv
    from scenesplat_tpu_torch.ops.subm_conv import build_subm_conv_plan, subm_dwconv_apply

    if chunk:
        monkeypatch.setattr(subm_conv, "_COLS_PER_CHUNK", chunk)
    grid, mask = _level(4)
    rng = np.random.default_rng(5)
    feat = rng.normal(size=grid.shape[:2] + (6,)).astype(np.float32)
    w = rng.normal(size=(27, 6)).astype(np.float32)
    bias = rng.normal(size=(6,)).astype(np.float32)
    cot = rng.normal(size=feat.shape).astype(np.float32) * mask[..., None]
    jp = _jax_plan(grid, mask)

    def jax_fn(x, w, b):
        out = jdw(x, jp, w, b)
        return (out * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (feat, w, bias)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, w, bias)]
    plan = build_subm_conv_plan(torch.from_numpy(grid).long(), torch.from_numpy(mask))
    out = subm_dwconv_apply(leaves[0], plan, leaves[1], leaves[2])
    (out * torch.from_numpy(cot)).sum().backward()
    m = mask[..., None]
    close(out.detach().numpy() * m, np.asarray(jout) * m, "depthwise conv", RTOL)
    for name, leaf, want in zip(("features", "weight", "bias"), leaves, jgrads):
        close(leaf.grad, want, f"gradient of the {name}", RTOL)


def _parent_level(grid, mask, seed=6, drop=5):
    """Each row's parents (grid >> 1), unique, ``drop`` of them left out (so
    some corners are missing), shuffled, with a padding tail."""
    rng = np.random.default_rng(seed)
    pg, pm = np.zeros_like(grid), np.zeros_like(mask)
    for i in range(grid.shape[0]):
        cells = np.unique(grid[i][mask[i]] >> 1, axis=0)
        cells = cells[rng.permutation(len(cells))][: len(cells) - drop]
        pg[i, : len(cells)], pm[i, : len(cells)] = cells, True
    return pg, pm


def _jax_corners(pg, pm, grid, mask):
    from scenesplat_tpu.ops.serialization import serialize
    from scenesplat_tpu.ops.sparse_conv import build_corner_lookup

    def fn(pg, pm, g, m):
        ser = serialize(pg, pm, ("z",), 16)
        return build_corner_lookup((ser.code_hi[0], ser.code_lo[0], ser.order[0]), g, m, 16)

    return jax.jit(fn)(*map(jnp.asarray, (pg, pm, grid, mask)))


def test_corner_lookup_matches_jax():
    """The 8 corners (c >> 1) + e, x-major: found where JAX finds them, the
    same parent."""
    from scenesplat_tpu_torch.ops.sparse_conv import CORNERS, build_corner_lookup

    assert CORNERS == tuple(itertools.product((0, 1), repeat=3))
    grid, mask = _level(7)
    pg, pm = _parent_level(grid, mask)
    jidx, jfound = _jax_corners(pg, pm, grid, mask)
    idx, found = build_corner_lookup(*(torch.from_numpy(a) for a in (pg, pm, grid, mask)))
    assert np.array_equal(found.numpy(), np.asarray(jfound))
    assert 0 < found.float().mean() < 1
    hit = found.numpy()
    assert np.array_equal(idx.numpy()[hit], np.asarray(jidx)[hit])


@pytest.mark.parametrize("chunk", [None, 1000], ids=["one_chunk", "chunks"])
def test_deconv_k3s2_matches_jax(chunk, monkeypatch):
    """Values and gradients (parent features, kernel) of the corner-anchored
    27-tap transposed conv, zeros at padding children."""
    from scenesplat_tpu.ops.sparse_conv import deconv_k3s2_apply as jdeconv
    from scenesplat_tpu_torch.ops import subm_conv
    from scenesplat_tpu_torch.ops.sparse_conv import build_corner_lookup, deconv_k3s2_apply

    if chunk:
        monkeypatch.setattr(subm_conv, "_COLS_PER_CHUNK", chunk)
    grid, mask = _level(8)
    pg, pm = _parent_level(grid, mask, seed=9)
    rng = np.random.default_rng(10)
    fp = rng.normal(size=pg.shape[:2] + (5,)).astype(np.float32)
    k = rng.normal(size=(27, 5, 4)).astype(np.float32)
    cot = rng.normal(size=grid.shape[:2] + (4,)).astype(np.float32)
    jidx, jfound = _jax_corners(pg, pm, grid, mask)

    def jax_fn(x, k):
        out = jdeconv(x, jidx, jfound, jnp.asarray(grid), k, mask=jnp.asarray(mask))
        return (out * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(fp), jnp.asarray(k))
    t = [torch.from_numpy(a) for a in (pg, pm, grid, mask)]
    idx, found = build_corner_lookup(*t)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (fp, k)]
    out = deconv_k3s2_apply(leaves[0], idx, found, t[2], leaves[1], mask=t[3])
    (out * torch.from_numpy(cot)).sum().backward()
    close(out.detach(), jout, "transposed conv", RTOL)
    assert (out.detach().numpy()[~mask] == 0).all()
    for name, leaf, want in zip(("parent features", "kernel"), leaves, jgrads):
        close(leaf.grad, want, f"gradient of the {name}", RTOL)


# ---- the weights round trip ------------------------------------------------------------

def _variants():
    from scenesplat_tpu.models.mink_unet import _VARIANTS

    return sorted(_VARIANTS)


def _published_over_16(name):
    """``name`` at its published planes and init width over 16: the same
    keys (every width comparison that adds a shortcut holds under one
    scale), small tensors."""
    from scenesplat_tpu.models import MODELS

    planes = MODELS.get(name).planes
    return dict(type=name, in_channels=6, out_channels=5, planes=tuple(p // 16 for p in planes),
                init_dim=2)


ROUND_TRIP = {
    **{name: (_published_over_16(name), "convert_mink_checkpoint") for name in _variants()},
    "SPVCNN": (dict(type="SPVCNN", in_channels=6, out_channels=5, base_channels=8,
                    channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8),
               "convert_spvcnn_checkpoint"),
    "OACNNs": (dict(type="OACNNs", in_channels=6, num_classes=5, embed_channels=8,
                    enc_channels=(8, 16), enc_depth=(1, 1), dec_channels=(8, 16),
                    point_grid_size=((2, 4), (2, 4, 8))), "convert_oacnns_checkpoint"),
    "OctFormer-v1m1": (dict(type="OctFormer-v1m1", in_channels=6, num_classes=5,
                            fpn_channels=8, channels=(8, 16), num_blocks=(2, 1),
                            num_heads=(2, 2), patch_size=8, dilation=2, drop_path=0.0,
                            octree_scale_factor=2.56, octree_depth=8,
                            serialization_depth=10), "convert_octformer_checkpoint"),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_weights_round_trip_through_the_jax_converters(name):
    """JAX-initialized variables -> the port's state dict -> loaded with
    strict=True -> back through the matching JAX converter into zero
    templates: equal to the originals, every key used and every leaf filled
    (from the abstract init, no forward; the MinkUNet variants at their
    published layers)."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.utils import ckpt_bridge
    from scenesplat_tpu_torch.models import build_model

    cfg, converter = ROUND_TRIP[name]
    s = scene(0, rows=1, pad=0) if name == "OACNNs" else scene(0, rows=1)
    shapes = jax.eval_shape(lambda p: jbuild(copy.deepcopy(cfg)).init(
        jax.random.PRNGKey(0), p, train=False), jax_point(s))
    v = fill(shapes, np.random.default_rng(7))
    model = torch_model(cfg, v)
    state = {k: t.numpy() for k, t in model.state_dict().items()}
    assert sorted(state) == sorted(build_model(copy.deepcopy(cfg)).state_dict())
    zeros = jax.tree_util.tree_map(np.zeros_like, v)  # templates that prove nothing
    params, stats, report = getattr(ckpt_bridge, converter)(
        state, zeros["params"], zeros["batch_stats"], backbone_prefix="")
    assert report["unused_torch_keys"] == []
    assert report["filled_leaves"] == len(jax.tree_util.tree_leaves(v))
    for tree, want in ((params, v["params"]), (stats, v["batch_stats"])):
        got_leaves = jax.tree_util.tree_leaves_with_path(tree)
        want_leaves = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
        for (path, g), (_, w) in zip(got_leaves, want_leaves):
            assert np.shape(g) == np.shape(w) and np.array_equal(np.asarray(g), np.asarray(w)), \
                jax.tree_util.keystr(path)
