"""Port parity, Point Transformer V2: PT-v2m2 (map and interp unpooling)
and PT-v2m1 (GroupedLinear) against the JAX package on the same numpy
clouds, the weights carried by ``utils/weights.py:state_dict_from_flax``
and loaded with strict=True; and the port's padding invariance. PT-v2m3 is
tests/test_torch_ptv2_pdnorm.py's, on these helpers.

The model is tests/test_ptv2_golden.py's MINI (two stages, widths 8 to 16,
8 neighbours) with both position encodings, over two rows of 160 slots
(one with a 40-slot padding tail) uniform in a 1.2 m cube, where the kNN
sets of the JAX matrix-product distances and the port's direct ones agree;
stage capacities of all slots, so no cluster is lost. One jit a variant of
the JAX train forward and gradient (about 15 s of compile), eval forward
too for m2.

Tolerances (fp32): forwards and the loss 1e-5 relative to the output's
scale, each gradient tensor 1e-4 relative L2, the BatchNorm running
statistics 1e-5 (the interp variant's forward 1e-4 and gradients 3e-4,
see VARIANTS). A
gradient that is zero in exact arithmetic (the bias of
a linear ahead of a BatchNorm or of the softmax over the neighbours) is held
below 1e-6 of the whole gradient on both sides: its fp32 sums over every
neighbour slot leave up to 4e-7 (measured).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

RTOL, GRAD_RTOL, STAT_RTOL, ZERO_GRAD = 1e-5, 1e-4, 1e-5, 1e-6
INTERP_RTOL, INTERP_GRAD_RTOL = 1e-4, 3e-4
MINI = dict(
    in_channels=6, num_classes=5, patch_embed_depth=1, patch_embed_channels=8,
    patch_embed_groups=2, patch_embed_neighbours=8, enc_depths=(1, 1),
    enc_channels=(16, 16), enc_groups=(4, 4), enc_neighbours=(8, 8), dec_depths=(1, 1),
    dec_channels=(8, 16), dec_groups=(2, 4), dec_neighbours=(8, 8), grid_sizes=(0.12, 0.24),
    pe_multiplier=True, pe_bias=True, stage_capacity=(1.0, 1.0))


def cloud(seed=0, rows=2, n=160, pad=40, extent=1.2, channels=6):
    """numpy rows [rows, n, ...] uniform in an ``extent`` cube; the last row
    ends in ``pad`` padded slots."""
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, extent, (rows, n, 3)).astype(np.float32)
    feat = rng.normal(size=(rows, n, channels)).astype(np.float32)
    mask = np.ones((rows, n), bool)
    mask[-1, n - pad:] = False
    coord[~mask], feat[~mask] = 0.0, 0.0
    return dict(coord=coord, feat=feat, grid=np.floor(coord / 0.05).astype(np.int32),
                mask=mask)


def voxel_cloud(seed=0, rows=2, voxels=40, pad=24, grid=0.12, channels=6):
    """Rows of 2 to 4 points in each of ``voxels`` cells of ``grid``
    (among 8^3, cell 0 always), inside each cell by 0.01 to 0.11 of it, one
    point at (0.01, 0.01, 0.01) so that the grid pooling's cells (counted
    from each row's smallest coordinate) are these cells: every cluster
    holds two or more points. The last row ends in ``pad`` padded slots."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rows):
        cells = rng.choice(np.arange(1, 512), voxels - 1, replace=False)
        cells = np.concatenate([[0], cells])
        ijk = np.stack([cells // 64, cells // 8 % 8, cells % 8], -1)
        per = rng.integers(2, 5, voxels)
        lo = np.repeat(ijk, per, 0) * grid
        coord = (lo + rng.uniform(0.01, 0.11, lo.shape) * grid / 0.12).astype(np.float32)
        coord[0] = 0.01 * grid / 0.12
        out.append(coord)
    n = max(len(c) for c in out) + pad
    coord = np.zeros((rows, n, 3), np.float32)
    mask = np.zeros((rows, n), bool)
    for r, c in enumerate(out):
        coord[r, :len(c)], mask[r, :len(c)] = c, True
    feat = np.where(mask[..., None], rng.normal(size=(rows, n, channels)), 0.0).astype(np.float32)
    return dict(coord=coord, feat=feat, grid=np.floor(coord / 0.05).astype(np.int32),
                mask=mask)


def jax_point(s):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(s["coord"]), feat=jnp.asarray(s["feat"]),
                      grid_coord=jnp.asarray(s["grid"]), mask=jnp.asarray(s["mask"]),
                      cls_token=None if "cls_token" not in s else jnp.asarray(s["cls_token"]))


def torch_point(s):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(coord=torch.from_numpy(s["coord"]), feat=torch.from_numpy(s["feat"]),
                      grid_coord=torch.from_numpy(s["grid"]).long(),
                      mask=torch.from_numpy(s["mask"]))


def fill(shapes, rng):
    """numpy values at the shapes flax gives every variable: fan-in kernels
    (and m1's grouped weight), norm scales near 1, small biases, running
    statistics away from 0/1."""
    def one(path, leaf):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "grouped_weight":
            x = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[-1])
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        elif name == "embedding":
            x = rng.normal(size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(one, shapes)


def jax_run(cfg, s, kw=None, eval_forward=False, seed=3, out=lambda o: o.feat):
    """The JAX model's numpy variables (from ``seed``), its eval forward (or
    None), and its train forward's masked output, loss (the output times a
    fixed cotangent), updated statistics and gradient, under one jit."""
    from scenesplat_tpu.models import build_model

    kw = kw or {}
    model = build_model(copy.deepcopy(cfg))
    point = jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, **kw), point)
    variables = fill(shapes, np.random.default_rng(seed))
    shape = jax.eval_shape(lambda v: out(model.apply(v, point, **kw)), variables).shape
    cot = np.random.default_rng(seed + 1).normal(size=shape).astype(np.float32)
    keep = (lambda x: x) if len(shape) == 2 else (
        lambda x: jnp.where(point.mask[..., None], x, 0.0))

    def loss(params):
        o, upd = model.apply({**variables, "params": params}, point, train=True,
                             mutable=["batch_stats"], **kw)
        f = keep(out(o))
        return (f * cot).sum(), (f, upd["batch_stats"])

    @jax.jit
    def run(v):
        fwd = keep(out(model.apply(v, point, **kw))) if eval_forward else None
        return fwd, jax.value_and_grad(loss, has_aux=True)(v["params"])

    fwd, ((value, (train_fwd, stats)), grads) = run(variables)
    return dict(variables=variables, fwd=None if fwd is None else np.asarray(fwd),
                train_fwd=np.asarray(train_fwd), loss=float(value), stats=stats, grads=grads,
                cot=cot)


def port_model(cfg, variables, **names):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    names = dict(dict(backbone_prefix="", flax_backbone_key=""), **names)
    return load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                             variables["batch_stats"], **names)


def port_run(model, s, cot, eval_forward=False, out=lambda o: o.feat, **kw):
    """The port's counterpart of ``jax_run``: (eval forward or None, train
    forward, loss), gradients left on the parameters."""
    point = torch_point(s)

    def keep(x):
        return x if x.dim() == 2 else torch.where(point.mask[..., None], x, 0.0)

    fwd = None
    if eval_forward:
        model.eval()
        with torch.no_grad():
            fwd = keep(out(model(point, **kw))).numpy()
    model.train()
    model.zero_grad()
    o = keep(out(model(point, **kw)))
    loss = (o * torch.from_numpy(cot)).sum()
    loss.backward()
    return fwd, o.detach().numpy(), loss.item()


def close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err}"


def assert_loss(loss, want, rtol=RTOL):
    """The loss (a sum of output times cotangent that cancels) to ``rtol``
    of the sum of its terms' magnitudes."""
    scale = np.abs(want["train_fwd"] * want["cot"]).sum()
    assert abs(loss - want["loss"]) <= rtol * scale, (loss, want["loss"], scale)


def check_grads(model, grads, zero=ZERO_GRAD, rtol=GRAD_RTOL, **names):
    """Every port gradient against JAX's of the same name; a parameter the
    port leaves without one (another condition's norm) has an exactly zero
    JAX gradient."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    names = dict(dict(backbone_prefix="", flax_backbone_key=""), **names)
    want = state_dict_from_flax(grads, {}, **names)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    whole = np.sqrt(sum(float((np.asarray(v, np.float64) ** 2).sum()) for v in want.values()))
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        if got[name].grad is None:
            assert not np.any(w), f"{name}: JAX gradient {np.abs(w).max()}, the port none"
            continue
        g = got[name].grad.numpy().astype(np.float64)
        if np.linalg.norm(w) < zero * whole:
            assert np.linalg.norm(g) < zero * whole, f"{name}: gradient only in the port"
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, f"gradient of {name}: relative L2 {err}"


def check_stats(model, stats, skip=lambda key: False, rtol=STAT_RTOL, **names):
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    names = dict(dict(backbone_prefix="", flax_backbone_key=""), **names)
    want = state_dict_from_flax({}, stats, **names)
    state = model.state_dict()
    checked = 0
    for key, w in want.items():
        if not key.endswith(("running_mean", "running_var")) or skip(key):
            continue
        close(state[key].numpy(), w, key, rtol)
        checked += 1
    assert checked


VARIANTS = {
    "m2_map": dict(type="PT-v2m2"),
    # interpolation reads distances: a cluster of one point lies on it, at
    # distance 0, which the JAX matrix-product form leaves at about 1e-4
    # (test_torch_pointops.py::test_interpolation_at_a_coincident_point);
    # so this case runs on voxel_cloud, whose clusters hold two points or
    # more at both stages (asserted); the JAX form's distances, 8 ulps of
    # |q|^2 + |x|^2 off, move the IDW weights by about 1e-5 of themselves,
    # the outputs by up to 4.1e-5 of their scale and the gradients by up to
    # 1.1e-4 relative L2 (measured): INTERP_RTOL, INTERP_GRAD_RTOL
    "m2_interp": dict(type="PT-v2m2", unpool_backend="interp", grid_sizes=(0.12, 0.48)),
    "m1": dict(type="PT-v2m1"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_ptv2_matches_jax(variant):
    """The train forward, its loss, every gradient and the running
    statistics, and m2's eval forward."""
    cfg = dict(MINI, **VARIANTS[variant])
    s = voxel_cloud(0) if variant == "m2_interp" else cloud(0)
    want = jax_run(cfg, s, eval_forward=variant == "m2_map")
    model = port_model(cfg, want["variables"])
    fwd, train_fwd, loss = port_run(model, s, want["cot"], want["fwd"] is not None)
    if variant == "m2_interp":
        with torch.no_grad():
            plans = copy.deepcopy(model).eval()(torch_point(s)).plans
        assert all(bool((p.counts[p.out_mask] >= 2).all()) for p in plans)
    rtol = INTERP_RTOL if variant == "m2_interp" else RTOL
    if fwd is not None:
        close(fwd, want["fwd"], "eval forward")
    close(train_fwd, want["train_fwd"], "train forward", rtol)
    assert_loss(loss, want, rtol)
    check_grads(model, want["grads"],
                rtol=INTERP_GRAD_RTOL if variant == "m2_interp" else GRAD_RTOL)
    check_stats(model, want["stats"])


@pytest.mark.parametrize("backend", ["map", "interp"])
def test_ptv2_padding_invariance(backend):
    """The valid points' logits, eval and train, do not depend on the padding's
    amount (the capacities follow the slots) or its content."""
    from scenesplat_tpu_torch.models import build_model

    base = cloud(5, rows=1, n=120, pad=0)
    model = build_model(dict(MINI, type="PT-v2m2", unpool_backend=backend, seed=2))
    outs = []
    for pad, value in ((16, 0.0), (80, 7.5)):
        s = {k: np.concatenate([v, np.full((1, pad) + v.shape[2:], value if k != "mask"
                                           else False, v.dtype)], 1) for k, v in base.items()}
        got = []
        for train in (False, True):
            run = copy.deepcopy(model).train(train)  # training moves the statistics
            with torch.no_grad():
                got.append(run(torch_point(s)).feat[0, :120].numpy())
        outs.append(got)
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_ptv2_drop_path_drops_whole_points():
    """In training, a drop-path rate of 1 drops every block's branch for
    every point (each block then passes ReLU of its input), and the draws
    come from the forward's generator."""
    from scenesplat_tpu_torch.models import build_model

    s = torch_point(cloud(1))
    model = build_model(dict(MINI, type="PT-v2m2", drop_path_rate=0.6, seed=4)).train()
    a = model(s, generator=torch.Generator().manual_seed(3)).feat
    b = model(s, generator=torch.Generator().manual_seed(3)).feat
    c = model(s, generator=torch.Generator().manual_seed(4)).feat
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(s)
