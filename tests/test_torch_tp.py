"""Port parity, tensor and context parallel over PT-v3m1: the port's rule
on the state dict against the JAX package's ``tp_spec_for_path``, the
shard / gather round trip, and one group of 4 ranks (``run_ranks``, the
``grids`` job of tests/torch_dist_worker.py) that runs both grids in turn:

- (data 2, model 2): the eval loss (1e-5 relative), gradients (2e-4
  relative, 2e-5 absolute) of the JAX single-device ``value_and_grad``
  (tests/test_tensor_parallel.py's bounds) and of one port process;
- (data 2, seq 2): the forward (2e-4 / 2e-4) and gradients (5e-4 / 5e-5
  relative to each tensor's scale) of the same JAX run
  (tests/test_context_parallel.py's bounds) and of one port process;
- on both: a train step of a LangPretrainer with drop-path 0.3, MLP
  dropout, the curve shuffle, the contrastive term and gradient clipping
  equal to one port process with the same generator (loss 1e-5, clipped
  gradients, the gradient norm and the BatchNorm statistics 1e-4, as
  tests/test_torch_dist.py holds two ranks), so the points group and the
  sliced draws count every point once; the gathered tensor-parallel
  checkpoint loads strictly into one process's model, bit for bit.

The JAX side runs its plain attention (``use_pallas=False``) on the JAX
test files' tiny PT-v3m1, whose weights reach the port through
``state_dict_from_flax``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv, one_torch_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from tests.test_torch_dist import (  # noqa: E402
    GRAD_RTOL,
    LOSS_RTOL,
    STAT_RTOL,
    _assert_grads,
    _assert_stats,
    run_ranks,
)

# the JAX test files' tiny PT-v3m1 (tests/test_tensor_parallel.py:_tiny_model)
TINY_TP = dict(type="PT-v3m1", in_channels=6, order=("z", "hilbert"), stride=(2,),
               enc_depths=(1, 1), enc_channels=(8, 16), enc_num_head=(2, 2),
               enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(8,),
               dec_num_head=(2,), dec_patch_size=(16,), mlp_ratio=2, drop_path=0.0,
               serialization_depth=10)
ROWS, N, LATTICE, GRID = 4, 128, 8, 0.05
PADDING = (0, 24, 0, 40)  # trailing padding slots of each row
TRAIN = dict(TINY_TP, drop_path=0.3, proj_drop=0.1, shuffle_orders=True)
CRITERIA = [
    dict(type="CosineSimilarity", reduction="mean", loss_weight=1.0),
    dict(type="L2Loss", reduction="mean", loss_weight=1.0),
    dict(type="AggregatedContrastiveLoss", temperature=0.2, reduction="mean",
         loss_weight=0.02, schedule="last_75", num_classes=8, min_samples=4),
]
CLIP_GRAD = 1e-3  # below the step's gradient norm, so that every rank clips
# stage 1 in one window of 64: its second seq rank runs no attention there
WIDE = dict(TINY_TP, enc_patch_size=(16, 64))


def _rows(seed=0):
    """ROWS rows of N slots: distinct cells of an 8^3 lattice (so the one
    pooling's 2^3 cells fit its capacity of 64), coordinates inside them,
    six features, a target and the lang batch's keys; trailing padding."""
    rng = np.random.default_rng(seed)
    cells = np.stack([rng.choice(LATTICE ** 3, N, replace=False) for _ in range(ROWS)])
    grid = np.stack(np.unravel_index(cells, (LATTICE,) * 3), -1).astype(np.int64)
    mask = np.arange(N)[None] < (N - np.array(PADDING))[:, None]
    coord = ((grid + rng.uniform(0.1, 0.9, grid.shape)) * GRID).astype(np.float32)
    rows = dict(coord=coord, grid_coord=grid, mask=mask,
                feat=rng.normal(size=(ROWS, N, 6)).astype(np.float32),
                target=rng.normal(size=(ROWS, N, 8)).astype(np.float32),
                lang_feat=rng.normal(size=(ROWS, N, 8)).astype(np.float32),
                segment=rng.integers(-1, 6, (ROWS, N)).astype(np.int64),
                valid_feat_mask=rng.random((ROWS, N)) > 0.1)
    for key in ("coord", "grid_coord", "feat"):
        rows[key] = np.where(mask[..., None], rows[key], 0).astype(rows[key].dtype)
    return rows


def _jax_model(**extra):
    from scenesplat_tpu.models import build_model

    return build_model(dict(TINY_TP, use_pallas=False, **extra))


def _jax_point(rows):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(rows["coord"]), feat=jnp.asarray(rows["feat"]),
                      grid_coord=jnp.asarray(rows["grid_coord"].astype(np.int32)),
                      mask=jnp.asarray(rows["mask"]))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX eval loss, output and gradients over the global batch (weights
    and BatchNorm statistics made with numpy), the port's one-process runs,
    and the 4 ranks' results."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.torch_dist_worker import grid_eval, grid_train

    from tests.test_torch_model import _numpy_variables

    rows = _rows()
    model, point = _jax_model(), _jax_point(rows)
    params, stats = _numpy_variables(model, point, np.random.default_rng(1))
    scale = float(ROWS * N * 8)

    def loss_fn(params, pt, tgt):
        out = model.apply({"params": params, "batch_stats": stats}, pt, train=False)
        d = (out.feat - tgt) * out.mask[..., None]
        return jnp.sum(d.astype(jnp.float32) ** 2) / scale, out.feat

    (loss, feat), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params, point, jnp.asarray(rows["target"]))
    flat = dict(backbone_prefix="", flax_backbone_key=None)
    state = state_dict_from_flax(params, stats, **flat)
    train_state = {"backbone." + k: v for k, v in state.items()}
    job = dict(kind="grids", backbone=dict(TINY_TP), state=state, loss_scale=scale,
               wide_backbone=WIDE,
               batch={k: rows[k] for k in ("coord", "grid_coord", "mask", "feat", "target")},
               train_model=dict(type="LangPretrainer", backbone=TRAIN), train_state=train_state,
               train_batch={k: v for k, v in rows.items() if k != "target"},
               criteria=CRITERIA, seed=5, clip_grad=CLIP_GRAD)
    ranks = run_ranks(tmp_path_factory.mktemp("grids"), job, world=4)
    return dict(rows=rows, job=job, loss=float(loss), feat=np.asarray(feat),
                grads=state_dict_from_flax(grads, {}, **flat), one_eval=grid_eval(job),
                one_wide=grid_eval(dict(job, backbone=WIDE)), one_train=grid_train(job),
                ranks=ranks)


def _bits(t):
    return t.contiguous().view(torch.uint8) if t.is_floating_point() else t


def _numpy(tensors):
    return {k: v.numpy() for k, v in tensors.items()}


def _rows_of(r):
    """(data rank, its rows) of rank ``r``: the data axis is the major one
    on both grids."""
    d = r // 2
    return d, slice(d * ROWS // 2, (d + 1) * ROWS // 2)


def test_tp_spec_rule_shards_the_jax_families():
    """Every flax parameter of the tiny model reaches one state-dict tensor
    (each leaf filled with its own index, through ``state_dict_from_flax``):
    the port's rule shards exactly the tensors that ``tp_spec_for_path``
    shards, in the same direction (the flax kernel is [in, out], the torch
    weight [out, in]); the pooling and unpooling proj stay replicated."""
    from scenesplat_tpu.parallel.tp import tp_spec_for_path
    from scenesplat_tpu_torch.parallel.tp import tp_spec_for_name
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    model = _jax_model()
    point = _jax_point(_rows())
    params = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p), point)["params"]
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    state = state_dict_from_flax(tagged, {}, backbone_prefix="", flax_backbone_key=None)
    want = {P(None, "model"): (0, "kernel"), P("model", None): (1, "kernel"),
            P("model"): (0, "bias")}
    counts = {}
    for name, tensor in state.items():
        (index,) = np.unique(tensor)
        path, leaf = leaves[int(index)]
        spec = tp_spec_for_path(path, leaf)
        got = tp_spec_for_name(name, torch.as_tensor(tensor))
        if spec == P():
            assert got is None, name
        else:
            assert got is not None and got[0] == want[spec][0], (name, spec, got)
            assert name.endswith(want[spec][1].replace("kernel", "weight")), name
        if got is not None:
            family = (*name.split(".")[-2:], spec)
            counts[family] = counts.get(family, 0) + 1
    assert len(state) == len(leaves)
    assert counts == {("qkv", "weight", P(None, "model")): 3, ("qkv", "bias", P("model")): 3,
                      ("proj", "weight", P("model", None)): 3,
                      ("fc1", "weight", P(None, "model")): 3, ("fc1", "bias", P("model")): 3,
                      ("fc2", "weight", P("model", None)): 3}
    assert all(tp_spec_for_name(k, torch.as_tensor(v)) is None for k, v in state.items()
               if ".up.proj" in k or ".down.proj" in k)


@pytest.mark.parametrize("degree,heads,replicated", [
    (2, dict(enc_num_head=(2, 2), dec_num_head=(2,)), 0),
    (4, dict(enc_num_head=(2, 4), dec_num_head=(4,)), 1),
])
def test_shard_then_merge_is_the_state_dict_bit_for_bit(degree, heads, replicated):
    """shard_state_dict_tp at every model index, then merge_state_dicts_tp,
    gives every tensor back bit for bit; a block whose heads the degree
    does not divide (stage 0's 2 heads at 4) stays whole in the shard map.
    A qkv share holds the q, k and v rows of the rank's heads."""
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.parallel.tp import (
        merge_state_dicts_tp,
        shard_state_dict_tp,
        tp_shard_map,
    )

    model = build_model(dict(TINY_TP, **heads, seed=3))
    state = model.state_dict()
    state["enc.enc0.block0.attn.qkv.bias"] = -torch.zeros(24)  # the sign of zero survives
    shard_map = tp_shard_map(model, degree)
    blocks = {k.rsplit(".attn.qkv.weight")[0] for k in shard_map if k.endswith("attn.qkv.weight")}
    whole = [b for b in blocks if shard_map[b + ".attn.qkv.weight"] is None]
    assert len(whole) == replicated, whole
    shares = [shard_state_dict_tp(state, shard_map, degree, i) for i in range(degree)]
    merged = merge_state_dicts_tp(shares, shard_map)
    for k, v in state.items():
        assert merged[k].dtype == v.dtype and torch.equal(_bits(merged[k]), _bits(v)), k
    name = "dec.dec0.block0.attn.qkv.weight"
    c = state[name].shape[1]
    rows = state[name].view(3, degree, c // degree, c)
    for i in range(degree):
        assert torch.equal(shares[i][name], rows[:, i].reshape(-1, c))
        assert shares[i]["dec.dec0.block0.mlp.0.fc2.weight"].shape == (c, 2 * c // degree)


def test_tp_eval_equals_jax_and_one_process(case):
    """(data 2, model 2): each rank's loss and whole gradients (its shares
    gathered over the model group) against the JAX single-device
    value_and_grad and one port process; the output rows too."""
    for r, got in enumerate(case["ranks"]):
        ev = got["tp"]["eval"]
        d, rows = _rows_of(r)
        assert got["tp"]["coords"] == (d, 0, r % 2)
        np.testing.assert_allclose(ev["loss"], case["loss"], rtol=1e-5)
        np.testing.assert_allclose(ev["loss"], case["one_eval"]["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(ev["feat"].numpy(), case["feat"][rows], rtol=2e-4, atol=2e-4)
        grads = _numpy(ev["grads"])
        assert sorted(grads) == sorted(case["grads"])
        for k, g in grads.items():
            np.testing.assert_allclose(g, case["grads"][k], rtol=2e-4, atol=2e-5, err_msg=k)
            np.testing.assert_allclose(g, case["one_eval"]["grads"][k].numpy(), rtol=2e-4,
                                       atol=2e-5, err_msg=k)


def test_cp_eval_equals_jax_and_one_process(case):
    """(data 2, seq 2): each rank's block of the output and its whole
    gradients against the JAX single-device run and one port process
    (relative to each tensor's scale); features were gathered. With stage
    1 in one window (``WIDE``) the second seq rank runs no attention there,
    and the ranks still equal one process."""
    for r, got in enumerate(case["ranks"]):
        ev = got["cp"]["eval"]
        d, rows = _rows_of(r)
        s = r % 2
        assert got["cp"]["coords"] == (d, s, 0)
        block = slice(s * N // 2, (s + 1) * N // 2)
        np.testing.assert_allclose(ev["feat"].numpy(), case["feat"][rows, block],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(ev["loss"], case["loss"], rtol=2e-4)
        for ref in (case["grads"], _numpy(case["one_eval"]["grads"])):
            grads = _numpy(ev["grads"])
            assert sorted(grads) == sorted(ref)
            for k, g in grads.items():
                scale = max(np.abs(ref[k]).max(), 1e-3)
                np.testing.assert_allclose(g / scale, ref[k] / scale, rtol=5e-4, atol=5e-5,
                                           err_msg=k)
        assert ev["gathered"]["forward"] > 0 and ev["gathered"]["backward"] > 0
        wide, one = got["cp"]["eval_wide"], case["one_wide"]
        np.testing.assert_allclose(wide["feat"].numpy(), one["feat"].numpy()[rows, block],
                                   rtol=2e-4, atol=2e-4)
        for k, g in _numpy(wide["grads"]).items():
            ref = one["grads"][k].numpy()
            scale = max(np.abs(ref).max(), 1e-3)
            np.testing.assert_allclose(g / scale, ref / scale, rtol=5e-4, atol=5e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["tp", "cp"])
def test_train_step_on_a_grid_equals_one_process(case, kind):
    """drop-path 0.3, MLP dropout (cut by hidden columns under tensor
    parallel, by points under context parallel), the curve shuffle, the
    contrastive split and the clip: the loss, the global gradient norm
    (over the model group's shares), the clipped gradients and the
    BatchNorm statistics of every rank equal one process's; equal on the
    ranks."""
    one = case["one_train"]
    assert one["grad_norm"] > 10 * CLIP_GRAD
    for r, got in enumerate(case["ranks"]):
        tr = got[kind]["train"]
        np.testing.assert_allclose(tr["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(tr["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(_numpy(tr["grads"]), _numpy(one["grads"]), f"{kind} rank {r}")
        _assert_stats(_numpy(tr["stats"]), _numpy(one["stats"]), f"{kind} rank {r}",
                      rtol=STAT_RTOL, atol=1e-7)
        clipped = np.sqrt(sum(float((g.double() ** 2).sum()) for g in tr["grads"].values()))
        np.testing.assert_allclose(clipped, CLIP_GRAD, rtol=1e-4)


def test_tp_checkpoint_loads_strictly_into_one_process(case):
    """The gathered state dict of a tensor-parallel model (what the
    checkpoint saver writes) loads into one process's LangPretrainer with
    strict=True and equals the weights it was cut from, bit for bit; the
    ranks held shares of the four families."""
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(case["job"]["train_model"]))
    for r, got in enumerate(case["ranks"]):
        state = got["tp"]["train"]["state"]
        model.load_state_dict(state, strict=True)
        for k, v in case["job"]["train_state"].items():  # SGD at lr 0: the weights it began with
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked")):
                assert np.array_equal(state[k].numpy().view(np.uint8),
                                      np.ascontiguousarray(v).view(np.uint8)), k
        shards = got["tp"]["train"]["shards"]
        assert shards["backbone.enc.enc1.block0.attn.qkv.weight"] == (24, 16)
        assert shards["backbone.enc.enc1.block0.mlp.0.fc2.weight"] == (16, 16)
        assert len(shards) == 6 * 3
