"""Port parity, Stratified Transformer (ST-v1m2, ST-v1m1): the window member
tables, KPConv, the attention with its bin-first relative position bias,
and the whole model's eval forward, train forward, loss, gradients and
running statistics against the JAX package on the same numpy clouds, the
weights carried by ``utils/weights.py:state_dict_from_flax`` and loaded
with strict=True; padding rows; the v1m1 alias; the reference's names
through the JAX converter (the train and test entry points over ST are
tests/test_torch_default_heads.py's).

The model is tests/test_stratified.py's small configuration (widths 8 to
16, four stages, windows of 0.4 to 3.2 m) over two rows of 96 slots (one
with a 26-slot padding tail) uniform in a 2 m cube, drop path 0 (the two
frameworks draw other bits). One jit of the JAX eval forward, train
forward and gradient for the file (a module fixture).

Tolerances (fp32): tables and FPS ids equal; KPConv and attention outputs
1e-5 of their scale and their gradients 1e-4 relative L2 (the attention's
bias is summed bin first here, per slot in JAX: the same products in
another order); the model's forwards, loss and statistics 1e-4 (TRAIN_RTOL)
and each gradient tensor 1e-4 relative L2 (GRAD_RTOL); a gradient zero in
exact arithmetic below 1e-6 of the whole on both sides.
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_ptv2 import (  # noqa: E402
    assert_loss,
    check_stats,
    close,
    cloud,
    jax_point,
    port_model,
    port_run,
    torch_point,
)

SMALL = dict(
    type="ST-v1m2", in_channels=6, num_classes=5, channels=(8, 8, 16, 16, 16),
    num_heads=(2, 2, 4, 4), depths=(2, 2, 1, 1), window_size=(0.4, 0.8, 1.6, 3.2),
    quant_size=(0.05, 0.1, 0.2, 0.4), down_ratio=0.5, down_num_sample=8, kp_ball_radius=0.3,
    kp_max_neighbor=8, kp_sigma_radius=0.1, fine_capacity=16, coarse_capacity=8, knn_tile=64,
    drop_path_rate=0.0)
FWD_RTOL, GRAD_RTOL_PART = 1e-5, 1e-4
TRAIN_RTOL, GRAD_RTOL, ZERO_GRAD = 1e-4, 1e-4, 1e-6


def _cloud(seed=0, n=96, pad=26):
    return cloud(seed, rows=2, n=n, pad=pad, extent=2.0)


def fill_st(shapes, rng):
    """numpy values for every flax variable: fan-in kernels (KPConv's over
    its kernel points and input channels), norm scales near 1, small
    biases, running statistics away from 0 and 1, RPE tables at 0.02 of a
    normal (the module's initialization's scale)."""
    def one(path, leaf):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        elif name.startswith("relative_pos_"):
            x = 0.02 * rng.normal(size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _grad_check(got, want, what, rtol=GRAD_RTOL_PART):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    assert err <= rtol, f"{what}: relative L2 error {err}"


def _direct_sqdist(q, x):
    """Squared distances as sums of squared differences (the port's form)."""
    d = q.astype(jnp.float32)[..., :, None, :] - x.astype(jnp.float32)[..., None, :, :]
    return jnp.sum(d * d, axis=-1)


@pytest.fixture(scope="module")
def st_jax():
    """The JAX ST-v1m2's variables, eval forward, train forward, loss
    (the masked output times a fixed cotangent), statistics and gradient
    on ``_cloud()``, under one jit. Its point queries take squared
    distances as the port does (``_direct_sqdist`` in place of the
    package's expansion form, for this fixture's trace): each level's
    samples lie on points of the level above, and at such a point the
    expansion form leaves a distance of about 1e-4 where the true one is 0,
    which moves the decoder's interpolation there by up to 3e-4 of the
    output's scale (measured; the fault itself is
    tests/test_torch_ball_query.py's)."""
    from scenesplat_tpu.models import build_model
    from scenesplat_tpu.ops import pointops as jpo

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpo, "_pairwise_sqdist", _direct_sqdist)
        return _st_jax_run(build_model)


def _st_jax_run(build_model):
    s = _cloud()
    model = build_model(copy.deepcopy(SMALL))
    point = jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p), point)
    variables = fill_st(shapes, np.random.default_rng(3))
    cot = np.random.default_rng(4).normal(size=s["mask"].shape + (5,)).astype(np.float32)

    def keep(o):
        return jnp.where(point.mask[..., None], o.feat, 0.0)

    def loss(params):
        o, upd = model.apply({**variables, "params": params}, point, train=True,
                             mutable=["batch_stats"])
        f = keep(o)
        return (f * cot).sum(), (f, upd["batch_stats"])

    @jax.jit
    def run(v):
        return keep(model.apply(v, point)), jax.value_and_grad(loss, has_aux=True)(v["params"])

    fwd, ((value, (train_fwd, stats)), grads) = run(variables)
    return dict(s=s, variables=variables, fwd=np.asarray(fwd), train_fwd=np.asarray(train_fwd),
                loss=float(value), stats=stats, grads=grads, cot=cot)


DEAD_BN = "point_embed.1.bn."  # the reference declares it and never applies it


def check_grads(model, grads, zero=ZERO_GRAD, rtol=GRAD_RTOL):
    """tests/test_torch_ptv2.py's check for ST: every port gradient
    against JAX's of the same name; the never-applied norm (which the flax
    tree lacks) has none."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    want = {k: np.asarray(v, np.float64) for k, v in state_dict_from_flax(
        grads, {}, backbone_prefix="", flax_backbone_key="").items()
        if not k.startswith(DEAD_BN) and not k.endswith("K_points")}
    got = dict(model.named_parameters())
    assert sorted(k for k in got if not k.startswith(DEAD_BN)) == sorted(want)
    assert all(got[k].grad is None for k in got if k.startswith(DEAD_BN))
    whole = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for name, w in want.items():
        g = got[name].grad.numpy().astype(np.float64)
        if np.linalg.norm(w) < zero * whole:
            assert np.linalg.norm(g) < zero * whole, f"{name}: gradient only in the port"
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, f"gradient of {name}: relative L2 {err}"


def _port(variables, cfg=SMALL):
    return port_model(cfg, variables, kp_sigma_radius=cfg["kp_sigma_radius"])


def test_window_members_match_jax_as_sets():
    """Each valid point's valid members equal JAX's as a set, on windows of
    0.4 m (a few members each) and of 1 m with a capacity of 4, which
    truncates (the members dropped counted as the JAX tables drop them),
    with and without a subset."""
    from scenesplat_tpu.models.stratified import window_members as jwm
    from scenesplat_tpu_torch.models.stratified import window_members

    s = _cloud(1)
    coord, mask = s["coord"], s["mask"]
    start = np.where(mask[..., None], coord, 1e10).min(1, keepdims=True)
    subset = mask & (np.random.default_rng(2).uniform(size=mask.shape) < 0.4)
    for window, capacity in ((0.4, 16), (1.0, 4)):
        for sub in (None, subset):
            got = window_members(torch.from_numpy(coord), torch.from_numpy(mask), window,
                                 torch.from_numpy(start), capacity,
                                 None if sub is None else torch.from_numpy(sub))
            want = jax.jit(jwm, static_argnums=(2, 4))(
                jnp.asarray(coord), jnp.asarray(mask), window, jnp.asarray(start), capacity,
                None if sub is None else jnp.asarray(sub))
            widx, wval, wgc = (np.asarray(a) for a in want)
            idx, val = got.idx.numpy(), got.valid.numpy()
            assert np.array_equal(got.window_coord.numpy(), wgc)
            for r, p in zip(*np.nonzero(mask)):
                assert set(idx[r, p][val[r, p]]) == set(widx[r, p][wval[r, p]]), (window, r, p)
            # the members each window holds past its capacity
            member = mask if sub is None else sub
            for r in range(2):
                counts = {}
                for p in np.nonzero(member[r])[0]:
                    counts[tuple(wgc[r, p])] = counts.get(tuple(wgc[r, p]), 0) + 1
                dropped = sum(max(0, c - capacity) for c in counts.values())
                assert int(got.n_overflow[r]) == dropped, (window, capacity, r)
    # the 1 m windows at a capacity of 4 do truncate
    assert int(window_members(torch.from_numpy(coord), torch.from_numpy(mask), 1.0,
                              torch.from_numpy(start), 4).n_overflow.sum()) > 0


def _kpconv_inputs():
    s = _cloud(5)
    from scenesplat_tpu.ops import pointops as jpo

    nidx, _ = jpo.ball_query(jnp.asarray(s["coord"]), jnp.asarray(s["mask"]), 8, 0.3,
                             pad_mode="shadow")
    return s, np.asarray(nidx)


def test_kpconv_matches_jax():
    """KPConv over the JAX ball query's shadow neighbourhoods (-1 slots
    contribute nothing): output and the kernel's and features' gradients."""
    from scenesplat_tpu.models.stratified import KPConv as JKPConv
    from scenesplat_tpu_torch.models.stratified import KPConv

    s, nidx = _kpconv_inputs()
    assert (nidx == -1).any()
    jmod = JKPConv(6, 7, point_influence=0.1)
    feat, coord = jnp.asarray(s["feat"]), jnp.asarray(s["coord"])
    params = jmod.init(jax.random.PRNGKey(0), feat, jnp.asarray(nidx), coord)
    cot = np.random.default_rng(6).normal(size=s["mask"].shape + (7,)).astype(np.float32)

    def f(p, x):
        out = jmod.apply(p, x, jnp.asarray(nidx), coord)
        return (out * cot).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, feat)
    mod = KPConv(6, 7, 0.1)
    mod.weight.data = torch.from_numpy(np.array(params["params"]["kernel"]))
    x = torch.from_numpy(s["feat"]).requires_grad_()
    got = mod(x, torch.from_numpy(nidx).long(), torch.from_numpy(s["coord"]))
    close(got.detach().numpy(), want, "KPConv", FWD_RTOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _grad_check(mod.weight.grad.numpy(), gp["params"]["kernel"], "KPConv kernel gradient")
    _grad_check(x.grad.numpy(), gx, "KPConv feature gradient")


def test_attention_bin_first_matches_jax():
    """StratifiedAttention (all three RPE tables, a window of 0.4 m, bins
    of 0.05) on the JAX module's slot tables: output and every parameter's
    and the input's gradient, the port summing the bias bin first."""
    from scenesplat_tpu.models.ptv2 import PointsState
    from scenesplat_tpu.models.stratified import StratifiedAttention as JAttn
    from scenesplat_tpu.models.stratified import window_members as jwm
    from scenesplat_tpu_torch.models.stratified import StratifiedAttention

    s = _cloud(7)
    coord, mask = jnp.asarray(s["coord"]), jnp.asarray(s["mask"])
    start = jnp.min(jnp.where(mask[..., None], coord, 1e10), axis=1, keepdims=True)
    idx, val, _ = jax.jit(jwm, static_argnums=(2, 4))(coord, mask, 0.4, start, 16)
    rng = np.random.default_rng(8)
    x = rng.normal(size=s["mask"].shape + (8,)).astype(np.float32)
    jmod = JAttn(embed_channels=8, num_heads=2, window_size=0.4, quant_size=0.05)
    state = PointsState(coord=coord, mask=mask)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), state, idx,
                                              val, True))
    params = fill_st(shapes, rng)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def f(p, xx):
        out = jmod.apply(p, xx, state, idx, val, True)
        return (out * cot).sum(), out

    (_, want), (gp, gx) = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(x))
    mod = StratifiedAttention(8, 2, 0.4, 0.05)
    p = params["params"]
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(mod, name).weight.copy_(torch.from_numpy(np.asarray(p[name]["kernel"]).T))
            getattr(mod, name).bias.copy_(torch.from_numpy(np.asarray(p[name]["bias"])))
        for t in ("query", "key", "value"):
            getattr(mod, f"relative_pos_{t}_table").copy_(
                torch.from_numpy(np.asarray(p[f"relative_pos_{t}_table"])))
    xt = torch.from_numpy(x).requires_grad_()
    got = mod(xt, torch.from_numpy(s["coord"]), torch.from_numpy(np.asarray(idx)).long(),
              torch.from_numpy(np.asarray(val)))
    close(got.detach().numpy(), want, "attention", FWD_RTOL)
    (got * torch.from_numpy(cot)).sum().backward()
    _grad_check(xt.grad.numpy(), gx, "attention input gradient")
    for name in ("qkv", "proj"):
        _grad_check(getattr(mod, name).weight.grad.numpy().T, gp["params"][name]["kernel"],
                    f"{name} gradient")
    for t in ("query", "key", "value"):
        _grad_check(getattr(mod, f"relative_pos_{t}_table").grad.numpy(),
                    gp["params"][f"relative_pos_{t}_table"], f"{t} table gradient")


def test_st_v1m2_matches_jax(st_jax):
    """The whole ST-v1m2: eval forward, train forward, loss, every gradient
    and the BatchNorm statistics, flax weights loaded with strict=True."""
    model = _port(st_jax["variables"])
    fwd, train_fwd, loss = port_run(model, st_jax["s"], st_jax["cot"], eval_forward=True)
    close(fwd, st_jax["fwd"], "eval forward", TRAIN_RTOL)
    close(train_fwd, st_jax["train_fwd"], "train forward", TRAIN_RTOL)
    assert_loss(loss, st_jax, TRAIN_RTOL)
    check_grads(model, st_jax["grads"], zero=ZERO_GRAD, rtol=GRAD_RTOL)
    check_stats(model, st_jax["stats"], rtol=TRAIN_RTOL)


def test_padding_rows_do_not_change_the_valid_points():
    """Each row's logits at its valid points are the same with 40 more
    padded slots at the end of every row (more FPS samples, all of them
    masked), in eval."""
    from scenesplat_tpu_torch.models import build_model

    s = _cloud()
    wide = {k: np.concatenate([v, np.zeros((2, 40) + v.shape[2:], v.dtype)], 1)
            for k, v in s.items()}
    model = build_model(dict(SMALL, seed=4)).eval()
    with torch.no_grad():
        a = model(torch_point(s)).feat.numpy()
        b = model(torch_point(wide)).feat.numpy()[:, :96]
    keep = s["mask"][..., None]
    close(np.where(keep, b, 0), np.where(keep, a, 0), "padded rows", FWD_RTOL)


def test_v1m1_is_the_v1m2_computation():
    """ST-v1m1 builds under its name with v1m2's parameters and forward."""
    from scenesplat_tpu_torch.models import build_model

    s = _cloud()
    v2 = build_model(dict(SMALL, seed=2)).eval()
    v1 = build_model(dict(SMALL, type="ST-v1m1", seed=2)).eval()
    assert type(v1).__name__ == "StratifiedTransformerV1M1"
    assert v1.state_dict().keys() == v2.state_dict().keys()
    with torch.no_grad():
        assert torch.equal(v1(torch_point(s)).feat, v2(torch_point(s)).feat)


def test_reference_names_through_the_jax_converter(st_jax):
    """The port's state dict is a reference-named one: the JAX package's
    converter consumes every key (the K_points and the never-applied
    ``point_embed.1.bn`` too) and fills every flax leaf, and its result
    carried back by state_dict_from_flax loads with strict=True to the same
    values."""
    from scenesplat_tpu.utils.ckpt_bridge import convert_stratified_checkpoint
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    model = build_model(dict(SMALL, seed=9))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    v = st_jax["variables"]
    params, stats, report = convert_stratified_checkpoint(state, v["params"], v["batch_stats"],
                                                          backbone_prefix="")
    assert report["unused_torch_keys"] == []
    assert report["filled_leaves"] == len(jax.tree_util.tree_leaves(v["params"])) + len(
        jax.tree_util.tree_leaves(v["batch_stats"]))
    back = state_dict_from_flax(params, stats, backbone_prefix="", flax_backbone_key="",
                                kp_sigma_radius=SMALL["kp_sigma_radius"])
    fresh = build_model(dict(SMALL, seed=10))
    fresh.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in back.items()},
                          strict=True)
    for k, x in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], x), k

