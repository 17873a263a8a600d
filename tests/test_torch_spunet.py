"""Port parity, SpUNet: the strided and inverse sparse convs, and SpUNet-v1m1,
v1m2, NoSkipBase and v1m3 (PDNorm with a named condition, with and without
the adaptive affine) and ``cls_mode`` against the JAX package on the same
numpy inputs, the weights carried by ``utils/weights.py`` and loaded with
strict=True; the state dict's keys and values equal to the JAX package's
``export_spunet_checkpoint``.

The model is tiny: channels (8, 16, 16, 8), layers (1, 1, 1, 1) (two
stages), two rows of 2,048 points whose pooled counts stay inside the
stage capacities, a padding tail. The JAX model runs under one jit a
variant (its train forward and gradient, about 30 s of compile on one
CPU worker; the other variants are in test_torch_spunet_variants.py and
test_torch_spunet_pdnorm.py). Tolerances: the convs fp32 1e-5 (values and gradients, relative
to each tensor's largest magnitude); the models' forwards rtol 1e-4 (atol
1e-4 of the output's scale), every gradient tensor 1e-4 relative L2 (a
gradient that is zero in exact arithmetic, the bias of a norm's input
conv, held below 1e-7 of the whole gradient on both sides), the BatchNorm
running statistics 1e-5."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import _make_scene  # noqa: E402

CONV_RTOL = 1e-5
RTOL, GRAD_RTOL, STAT_RTOL, ZERO_GRAD = 1e-4, 1e-4, 1e-5, 1e-7
CTX = 16
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")
TINY = dict(in_channels=6, base_channels=8, channels=(8, 16, 16, 8), layers=(1, 1, 1, 1))


def _scene(seed=0, rows=2, pad=32, duplicates=0):
    """``rows`` scenes of 2,048 voxels (each stride-2 cell of two levels
    holding 4 children, so each pooling at most halves), a padding tail,
    and ``duplicates`` repeated voxels (Mix3D's merged rooms hold such):
    numpy arrays [rows, n, ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        coord, grid, feat = _make_scene(rng, n_parents=128, children_per_parent=4, levels=2)
        if duplicates:
            pick = rng.choice(len(grid), duplicates, replace=False)
            grid, coord = np.concatenate([grid, grid[pick]]), np.concatenate([coord, coord[pick]])
            feat = np.concatenate([feat, rng.normal(size=(duplicates, 6)).astype(np.float32)])
        n = len(grid)
        out.append(dict(coord=np.concatenate([coord, np.zeros((pad, 3), np.float32)]),
                        grid=np.concatenate([grid, np.zeros((pad, 3), np.int32)]),
                        feat=np.concatenate([feat, np.zeros((pad, 6), np.float32)]),
                        mask=np.arange(n + pad) < n))
    return {k: np.stack([r[k] for r in out]) for k in out[0]}


def _jax_point(s):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(s["coord"]), feat=jnp.asarray(s["feat"]),
                      grid_coord=jnp.asarray(s["grid"]), mask=jnp.asarray(s["mask"]))


def _torch_point(s):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(coord=torch.from_numpy(s["coord"]), feat=torch.from_numpy(s["feat"]),
                      grid_coord=torch.from_numpy(s["grid"]).long(),
                      mask=torch.from_numpy(s["mask"]))


def _fill(shapes, rng):
    """numpy values at the shapes flax gives every variable: fan-in kernels,
    norm scales near 1, small biases, running statistics away from 0/1."""
    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


# ---- the strided and inverse convs ------------------------------------------------

def _plans(s):
    """The JAX and the port's pooling plans (depth 1, capacity 1,040) over
    the z-serialization at depth 16."""
    from scenesplat_tpu.ops.segops import build_pooling_plan as jplan
    from scenesplat_tpu.ops.serialization import serialize as jser
    from scenesplat_tpu_torch.ops.segops import build_pooling_plan
    from scenesplat_tpu_torch.ops.serialization import serialize

    grid, mask = jnp.asarray(s["grid"]), jnp.asarray(s["mask"])
    jp = jplan(jser(grid, mask, orders=("z",), depth=16), mask, 1040, pooling_depth=1)
    tg, tm = torch.from_numpy(s["grid"]).long(), torch.from_numpy(s["mask"])
    return jp, build_pooling_plan(serialize(tg, tm, ("z",), 16), tm, 1040, 1)


def _close(got, want, what, rtol=CONV_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err}"


@pytest.mark.parametrize("duplicates", [0, 40], ids=["unique", "duplicate_voxels"])
def test_strided_and_inverse_conv_match_jax(duplicates):
    """Values and gradients (feat, kernel, bias) of both convs, fp32."""
    from scenesplat_tpu.ops.sparse_conv import inverse_conv_apply as jinv
    from scenesplat_tpu.ops.sparse_conv import strided_conv_apply as jstr
    from scenesplat_tpu_torch.ops.sparse_conv import inverse_conv_apply, strided_conv_apply

    s = _scene(1, duplicates=duplicates)
    rng = np.random.default_rng(2)
    b, n, _ = s["grid"].shape
    feat = rng.normal(size=(b, n, 5)).astype(np.float32)
    k_down = rng.normal(size=(8, 5, 7)).astype(np.float32)
    bias = rng.normal(size=(7,)).astype(np.float32)
    k_up = rng.normal(size=(8, 7, 3)).astype(np.float32)
    cot_down = rng.normal(size=(b, 1040, 7)).astype(np.float32)
    cot_up = rng.normal(size=(b, n, 3)).astype(np.float32)
    jp, tp = _plans(s)
    assert np.array_equal(np.asarray(jp.out_mask), tp.out_mask.numpy())
    assert int(tp.n_overflow.max()) == 0
    grid, mask = jnp.asarray(s["grid"]), jnp.asarray(s["mask"])

    def jax_fn(x, kd, bd, ku):
        down = jstr(x, jp, grid, kd, bias=bd)
        up = jinv(down, jp, grid, ku, mask=mask)
        return (down * cot_down).sum() + (up * cot_up).sum(), (down, up)

    (_, (jdown, jup)), jgrads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (feat, k_down, bias, k_up)))

    leaves = [torch.from_numpy(a).requires_grad_() for a in (feat, k_down, bias, k_up)]
    tgrid, tmask = torch.from_numpy(s["grid"]).long(), torch.from_numpy(s["mask"])
    down = strided_conv_apply(leaves[0], tp, tgrid, leaves[1], bias=leaves[2])
    up = inverse_conv_apply(down, tp, tgrid, leaves[3], mask=tmask)
    ((down * torch.from_numpy(cot_down)).sum() + (up * torch.from_numpy(cot_up)).sum()).backward()

    _close(down.detach(), jdown, "strided conv")
    _close(up.detach(), jup, "inverse conv")
    assert (up.detach().numpy()[~s["mask"]] == 0).all()
    for name, leaf, want in zip(("feat", "down kernel", "bias", "up kernel"), leaves, jgrads):
        _close(leaf.grad, want, f"gradient of the {name}")


def test_kernel_tap_matches_jax():
    from scenesplat_tpu.ops.sparse_conv import kernel_tap as jtap
    from scenesplat_tpu_torch.ops.sparse_conv import kernel_tap

    g = np.random.default_rng(0).integers(0, 1 << 12, size=(2, 300, 3)).astype(np.int32)
    assert np.array_equal(kernel_tap(torch.from_numpy(g)).numpy(), np.asarray(jtap(g)))


# ---- the models ---------------------------------------------------------------------

VARIANTS = {
    "v1m1": dict(type="SpUNet-v1m1", num_classes=5),
    "v1m2": dict(type="SpUNet-v1m2", num_classes=5),
    "noskip": dict(type="SpUNetNoSkipBase", num_classes=5),
    "cls_mode": dict(type="SpUNet-v1m1", num_classes=4, cls_mode=True),
    "v1m3": dict(type="SpUNet-v1m3", num_classes=5, pd_adaptive=False,
                 context_channels=CTX),
    "v1m3_adaptive": dict(type="SpUNet-v1m3", num_classes=5, pd_adaptive=True,
                          context_channels=CTX),
}


def _cfg(variant):
    return dict(TINY, **VARIANTS[variant])


def _jax_run(cfg, s, seed=3, condition_index=1, context=None, eval_forward=True):
    """The JAX model's variables (numpy, from ``seed``), its eval forward
    (or with ``eval_forward`` off its train forward: each forward more
    costs the jit a third more compile time), and its train forward's loss
    (the sum of the output times a fixed cotangent over the valid rows),
    gradient and updated statistics, under one jit."""
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    point = _jax_point(s)
    kw = {}
    if "v1m3" in cfg["type"]:
        kw = dict(condition_index=jnp.asarray(condition_index, jnp.int32),
                  context=None if context is None else jnp.asarray(context))
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False, **kw),
                            point)
    variables = _fill(shapes, np.random.default_rng(seed))
    cls = cfg.get("cls_mode", False)
    cot = np.random.default_rng(seed + 1).normal(
        size=(s["mask"].shape[0],) + ((cfg["num_classes"],) if cls else
                                      (s["mask"].shape[1], cfg["num_classes"])))
    cot = np.asarray(cot, np.float32)

    def feat(out):
        return out if cls else jnp.where(point.mask[..., None], out.feat, 0.0)

    def loss(params, v):
        out, upd = model.apply({**v, "params": params}, point, train=True,
                               mutable=["batch_stats"], **kw)
        return (feat(out) * cot).sum(), (upd["batch_stats"], feat(out))

    @jax.jit
    def run(v):
        fwd = feat(model.apply(v, point, train=False, **kw)) if eval_forward else None
        return fwd, jax.value_and_grad(loss, has_aux=True)(v["params"], v)

    fwd, ((value, (stats, train_fwd)), grads) = run(variables)
    fwd = train_fwd if fwd is None else fwd
    return variables, np.asarray(fwd), float(value), stats, grads, cot


def _torch_model(cfg, params, stats):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    return load_flax_weights(build_model(copy.deepcopy(cfg)), params, stats,
                             backbone_prefix="", flax_backbone_key="")


def _torch_run(model, s, cot, cls, condition=None, context=None, eval_forward=True):
    """The port's counterpart of ``_jax_run``'s forward and loss."""
    kw = {} if condition is None else dict(
        condition=condition, context=None if context is None else torch.from_numpy(context))
    point = _torch_point(s)
    mask = point.mask[..., None]

    def feat(out):
        return out if cls else torch.where(mask, out.feat, 0.0)

    fwd = None
    if eval_forward:
        model.eval()
        with torch.no_grad():
            fwd = feat(model(point, **kw)).numpy()
    model.train()
    model.zero_grad()
    out = feat(model(point, **kw))
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    return out.detach().numpy() if fwd is None else fwd, loss.item()


def _check_grads(model, grads, **names):
    """Every port gradient against the JAX gradient of the same name (the
    JAX gradients of the inactive conditions' norms are zero; the port's
    have none); ``names``: state_dict_from_flax's prefix arguments (a bare
    backbone's by default)."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    names = dict(dict(backbone_prefix="", flax_backbone_key=""), **names)
    want = state_dict_from_flax(grads, {}, **names)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    whole = np.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in want.values()))
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = (np.zeros_like(w) if got[name] is None
             else got[name].detach().numpy().astype(np.float64))
        if np.linalg.norm(w) < ZERO_GRAD * whole:
            assert np.linalg.norm(g) < ZERO_GRAD * whole, f"{name}: gradient only in the port"
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, f"gradient of {name}: relative L2 {err}"


def _check_stats(model, stats, skip=lambda key: False):
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    want = state_dict_from_flax({}, stats, backbone_prefix="", flax_backbone_key="")
    state = model.state_dict()
    checked = 0
    for key, w in want.items():
        if not key.endswith(("running_mean", "running_var")) or skip(key):
            continue
        err = np.abs(state[key].numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max()
        assert err <= STAT_RTOL, f"{key}: {err}"
        checked += 1
    assert checked


def check_variant(variant, seed=4, eval_forward=False):
    """``variant``'s forward (eval, or train with ``eval_forward`` off),
    train-mode loss, every gradient and the running statistics after the
    train forward, against JAX."""
    cfg = _cfg(variant)
    s = _scene(seed)
    variables, fwd, value, stats, grads, cot = _jax_run(cfg, s, eval_forward=eval_forward)
    model = _torch_model(cfg, variables["params"], variables["batch_stats"])
    got_fwd, got_value = _torch_run(model, s, cot, cfg.get("cls_mode", False),
                                    eval_forward=eval_forward)
    np.testing.assert_allclose(got_fwd, fwd, rtol=RTOL, atol=RTOL * np.abs(fwd).max())
    assert abs(got_value - value) <= RTOL * abs(value)
    _check_grads(model, grads)
    _check_stats(model, stats)
    return model


@pytest.mark.parametrize("variant", ["v1m1", "cls_mode"])
def test_spunet_matches_jax(variant):
    """SpUNet-v1m1 and ``cls_mode`` (each row's mean after the encoder)."""
    model = check_variant(variant)
    assert (len(model.up) == 0) == (variant == "cls_mode")


def test_state_dict_equals_export_spunet_checkpoint():
    """Key for key and value for value the JAX package's export; it loads
    with strict=True, as a reference checkpoint does."""
    from scenesplat_tpu.utils.ckpt_bridge import export_spunet_checkpoint
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    cfg = dict(TINY, type="SpUNet-v1m1", num_classes=5, channels=(8, 16, 24, 12),
               layers=(2, 1, 1, 2))
    from scenesplat_tpu.models import build_model as jbuild

    shapes = jax.eval_shape(lambda p: jbuild(copy.deepcopy(cfg)).init(
        jax.random.PRNGKey(0), p, train=False), _jax_point(_scene(0, rows=1)))
    v = _fill(shapes, np.random.default_rng(0))
    want = export_spunet_checkpoint(v["params"], v["batch_stats"])
    got = state_dict_from_flax(v["params"], v["batch_stats"], flax_backbone_key="")
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape and np.array_equal(got[k], w), k
    model = build_model(dict(type="DefaultSegmentorV2", num_classes=0,
                             backbone_out_channels=12, backbone=cfg))
    model.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in got.items()},
                          strict=True)
    own = build_model(copy.deepcopy(cfg)).state_dict()
    assert sorted("backbone." + k for k in own) == sorted(got)
