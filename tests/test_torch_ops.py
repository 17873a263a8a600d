"""Port parity, ops: the PyTorch port's curves, serialization, conv plans
and apply, pooling and norms against the JAX package on the same numpy
inputs, plus a source check that the port imports neither JAX nor the JAX
package."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.ops import segops as jseg  # noqa: E402
from scenesplat_tpu.ops import serialization as jser  # noqa: E402
from scenesplat_tpu.ops import subm_conv as jconv  # noqa: E402
from scenesplat_tpu_torch.ops import curves as tcurves  # noqa: E402
from scenesplat_tpu_torch.ops import segops as tseg  # noqa: E402
from scenesplat_tpu_torch.ops import serialization as tser  # noqa: E402
from scenesplat_tpu_torch.ops import subm_conv as tconv  # noqa: E402
from tests.test_full_model_golden import _make_scene  # noqa: E402

ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _padded_scene(seed, n_parents=128, levels=2, pad=37):
    """One point per voxel, shuffled, with ``pad`` trailing padding slots."""
    rng = np.random.default_rng(seed)
    coord, grid, feat = _make_scene(rng, n_parents=n_parents, levels=levels)
    n = len(grid) + pad
    grid_p = np.zeros((1, n, 3), np.int32)
    grid_p[0, : len(grid)] = grid
    coord_p = np.zeros((1, n, 3), np.float32)
    coord_p[0, : len(grid)] = coord
    mask = np.zeros((1, n), bool)
    mask[0, : len(grid)] = True
    return coord_p, grid_p, mask, rng


@pytest.mark.parametrize("depth", [10, 16])
@pytest.mark.parametrize("order", ORDERS)
def test_curve_codes_bit_exact(order, depth):
    rng = np.random.default_rng(depth)
    grid = rng.integers(0, 1 << depth, size=(2, 3000, 3)).astype(np.int32)
    mask = rng.random((2, 3000)) < 0.9
    hi, lo = jser.compute_codes(jnp.asarray(grid), jnp.asarray(mask), (order,),
                                depth)
    hi, lo = np.asarray(hi).astype(np.int64), np.asarray(lo).astype(np.int64)
    got = tser.compute_codes(_t(grid), _t(mask), (order,), depth).numpy()
    np.testing.assert_array_equal(got[:, mask], ((hi << 24) | lo)[:, mask])
    assert (got[:, ~mask] == tser.SENTINEL).all()
    # the encoder alone, unmasked
    np.testing.assert_array_equal(
        tcurves.encode(_t(grid), order, depth).numpy()[mask],
        ((hi << 24) | lo)[0][mask])


@pytest.mark.parametrize("depth", [10, 16])
def test_orders_and_inverses_equal_on_valid_slots(depth):
    _, grid, mask, _ = _padded_scene(depth)
    ser_j = jser.serialize(jnp.asarray(grid), jnp.asarray(mask), ORDERS, depth)
    ser_t = tser.serialize(_t(grid), _t(mask), ORDERS, depth)
    nv = int(mask.sum())
    order_j = np.asarray(ser_j.order)
    np.testing.assert_array_equal(ser_t.order.numpy()[..., :nv], order_j[..., :nv])
    inv_j = np.asarray(ser_j.inverse)
    np.testing.assert_array_equal(ser_t.inverse.numpy()[:, mask], inv_j[:, mask])
    # inverse really inverts, padding included
    s, b, n = ser_t.order.shape
    iota = np.broadcast_to(np.arange(n), (s, b, n))
    np.testing.assert_array_equal(
        np.take_along_axis(ser_t.inverse.numpy(), ser_t.order.numpy(), -1), iota)


def _plan_np(plan):
    return np.asarray(plan.neighbor_index), np.asarray(plan.neighbor_valid)


@pytest.mark.parametrize("builder", ["merge_join", "dense"])
@pytest.mark.parametrize("k", [3, 5])
def test_conv_plan_matches_jax_builders(k, builder):
    _, grid, mask, _ = _padded_scene(k)
    if builder == "dense":
        ref = jconv.build_subm_conv_plan_dense(
            jnp.asarray(grid), jnp.asarray(mask), kernel_size=k, extent=(64,) * 3)
    else:
        ref = jconv.build_subm_conv_plan(
            jnp.asarray(grid), jnp.asarray(mask), kernel_size=k, depth=16)
    nbr_j, val_j = _plan_np(ref)
    plan = tconv.build_subm_conv_plan(_t(grid), _t(mask), kernel_size=k, depth=16)
    nbr_t, val_t = _plan_np(plan)
    np.testing.assert_array_equal(val_t, val_j)
    np.testing.assert_array_equal(np.where(val_t, nbr_t, 0), np.where(val_j, nbr_j, 0))
    assert val_t.sum() > 2 * mask.sum()  # non-trivial: real neighbours exist
    if k == 5:
        sub = tconv.subplan(plan, 3)
        ref3 = jconv.subplan(ref, 3)
        np.testing.assert_array_equal(sub.neighbor_valid.numpy(),
                                      np.asarray(ref3.neighbor_valid))


def test_conv_plan_respects_depth_limit():
    # neighbours outside [0, 2**depth) are invalid even if a point sits there
    grid = np.array([[[0, 0, 0], [1, 0, 0], [3, 3, 3]]], np.int32)
    mask = np.ones((1, 3), bool)
    ref = jconv.build_subm_conv_plan(jnp.asarray(grid), jnp.asarray(mask),
                                     kernel_size=3, depth=2)
    plan = tconv.build_subm_conv_plan(_t(grid), _t(mask), kernel_size=3, depth=2)
    np.testing.assert_array_equal(plan.neighbor_valid.numpy(),
                                  np.asarray(ref.neighbor_valid))


@pytest.mark.parametrize("k,bias", [(3, True), (5, False)])
def test_subm_conv_apply(k, bias):
    _, grid, mask, rng = _padded_scene(10 + k)
    n = grid.shape[1]
    cin, cout = 6, 10
    feat = rng.normal(size=(1, n, cin)).astype(np.float32)
    w = rng.normal(size=(k ** 3, cin, cout)).astype(np.float32)
    bvec = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    ref_plan = jconv.build_subm_conv_plan(jnp.asarray(grid), jnp.asarray(mask),
                                          kernel_size=k, depth=16)
    ref = jconv.subm_conv_apply(jnp.asarray(feat), ref_plan, jnp.asarray(w),
                                None if bvec is None else jnp.asarray(bvec))
    plan = tconv.build_subm_conv_plan(_t(grid), _t(mask), kernel_size=k, depth=16)
    got = tconv.subm_conv_apply(_t(feat), plan, _t(w),
                                None if bvec is None else _t(bvec))
    np.testing.assert_allclose(got.numpy()[mask], np.asarray(ref)[mask],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("capacity", [272, 100])  # room to spare, overflow
def test_pooling_plan_equal(capacity):
    _, grid, mask, _ = _padded_scene(21)
    ser_j = jser.serialize(jnp.asarray(grid), jnp.asarray(mask), ORDERS, 16)
    ser_t = tser.serialize(_t(grid), _t(mask), ORDERS, 16)
    pj = jseg.build_pooling_plan(ser_j, jnp.asarray(mask), capacity, 1)
    pt = tseg.build_pooling_plan(ser_t, _t(mask), capacity, 1)
    assert int(pt.n_clusters[0]) == int(pj.n_clusters[0])
    assert int(pt.n_overflow[0]) == int(pj.n_overflow[0])
    assert (int(pt.n_overflow[0]) > 0) == (capacity == 100)
    for name in ("cluster_of_point", "counts", "out_mask"):
        np.testing.assert_array_equal(getattr(pt, name).numpy(),
                                      np.asarray(getattr(pj, name)), err_msg=name)
    # empty clusters point at the last sorted slot, a padding slot whose
    # identity depends on how each sort orders padding
    live = pt.out_mask.numpy()
    np.testing.assert_array_equal(pt.head_index.numpy()[live],
                                  np.asarray(pj.head_index)[live])
    nv = int(mask.sum())
    np.testing.assert_array_equal(pt.seg_sorted.numpy()[:, :nv],
                                  np.asarray(pj.seg_sorted)[:, :nv])

    # pooled serialization: codes everywhere, orders on valid slots
    sj = jseg.pool_serialization(pj, ser_j, 1)
    st = tseg.pool_serialization(pt, ser_t, 1)
    out_mask = pt.out_mask.numpy()
    code_j = (np.asarray(sj.code_hi).astype(np.int64) << 24) | np.asarray(sj.code_lo)
    np.testing.assert_array_equal(st.code.numpy()[:, out_mask], code_j[:, out_mask])
    nc = int(out_mask.sum())
    np.testing.assert_array_equal(st.order.numpy()[..., :nc],
                                  np.asarray(sj.order)[..., :nc])


@pytest.mark.parametrize("reduce", ["mean", "max"])
def test_pool_values(reduce):
    _, grid, mask, rng = _padded_scene(22)
    ser_j = jser.serialize(jnp.asarray(grid), jnp.asarray(mask), ("z",), 16)
    ser_t = tser.serialize(_t(grid), _t(mask), ("z",), 16)
    pj = jseg.build_pooling_plan(ser_j, jnp.asarray(mask), 272, 1)
    pt = tseg.build_pooling_plan(ser_t, _t(mask), 272, 1)
    vals = rng.normal(size=(1, grid.shape[1], 7)).astype(np.float32)
    ref = np.asarray(jseg.pool_values(pj, jnp.asarray(vals), reduce))
    got = tseg.pool_values(pt, _t(vals), reduce).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    unpooled = tseg.unpool_values(_t(got), pt.cluster_of_point).numpy()
    np.testing.assert_array_equal(
        unpooled, np.asarray(jseg.unpool_values(jnp.asarray(got),
                                                pj.cluster_of_point)))


@pytest.mark.parametrize("train", [False, True])
def test_masked_batchnorm(train):
    from scenesplat_tpu.models.norm import MaskedBatchNorm as JBN
    from scenesplat_tpu_torch.models.norm import MaskedBatchNorm as TBN

    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 50, 8)).astype(np.float32) * 3 + 1
    mask = rng.random((2, 50)) < 0.7
    stats = dict(mean=rng.normal(size=8).astype(np.float32),
                 var=rng.random(8).astype(np.float32) + 0.5)
    params = dict(scale=rng.normal(size=8).astype(np.float32),
                  bias=rng.normal(size=8).astype(np.float32))
    jbn = JBN(8)
    ref, upd = jbn.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         jnp.asarray(mask), use_running_average=not train,
                         mutable=["batch_stats"])
    tbn = TBN(8)
    tbn.load_state_dict(dict(weight=_t(params["scale"]), bias=_t(params["bias"]),
                             running_mean=_t(stats["mean"]),
                             running_var=_t(stats["var"]),
                             num_batches_tracked=torch.zeros((), dtype=torch.int64)))
    tbn.train(train)
    got = tbn(_t(x), _t(mask)).detach().numpy()
    np.testing.assert_allclose(got[mask], np.asarray(ref)[mask], rtol=1e-5, atol=1e-5)
    if train:  # padding rows, which every consumer masks, come out as zeros
        assert not got[~mask].any()
    new = upd["batch_stats"] if train else stats
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(new["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(new["var"]),
                               rtol=1e-5, atol=1e-6)


def test_layernorm():
    from scenesplat_tpu.models.norm import LayerNorm as JLN
    from scenesplat_tpu_torch.models.norm import LayerNorm as TLN

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 30, 12)).astype(np.float32) * 2 - 1
    params = dict(scale=rng.normal(size=12).astype(np.float32),
                  bias=rng.normal(size=12).astype(np.float32))
    ref = JLN(12).apply({"params": params}, jnp.asarray(x))
    ln = TLN(12)
    ln.load_state_dict(dict(weight=_t(params["scale"]), bias=_t(params["bias"])))
    np.testing.assert_allclose(ln(_t(x)).detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_class_names_and_text_embeddings_equal_jax(tmp_path):
    """The port's copies of the ScanNet200 labels and SigLIP2 table, and its
    .npy and label-file loaders, give what the JAX package's give."""
    from scenesplat_tpu.engines import eval as jeval
    from scenesplat_tpu_torch.engines import eval as teval

    rng = np.random.default_rng(9)
    np.save(tmp_path / "emb.npy", rng.normal(size=(5, 8)).astype(np.float32))
    (tmp_path / "labels.txt").write_text("wall\n floor \n\nchair\n")
    for src in ("builtin:scannet200", str(tmp_path / "emb.npy")):
        got, ref = teval.load_text_embeddings(src), jeval.load_text_embeddings(src)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    for src in ("builtin:scannet200", str(tmp_path / "labels.txt"), ["a", "b"]):
        assert teval.load_class_names(src) == jeval.load_class_names(src)
    assert len(teval.load_class_names("builtin:scannet200")) == 200


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "scenesplat_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 10
    banned = ("jax", "jaxlib", "flax", "optax", "scenesplat_tpu")
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in banned, f"{path.relative_to(root)} imports {name}"
