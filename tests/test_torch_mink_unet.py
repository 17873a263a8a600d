"""Port parity, MinkUNet: the eval forward, the train forward with its
BatchNorm statistics, the loss and every gradient of MinkUNet14 (basic
blocks) and a narrow MinkUNet50 (bottlenecks) against the JAX package on
the same numpy rows, the weights carried by ``utils/weights.py`` and
loaded with strict=True. The helpers here serve the other sparse-backbone
files (tests/test_torch_spvcnn.py, test_torch_oacnns.py,
test_torch_octformer.py, test_torch_sparse_lookup.py).

The models are tiny (8 to 16 channels, one block a stage) over two rows of
2,048 voxels where every stride-2 cell of two levels holds 4 children and a
padding tail; the deeper levels' clusters fit their capacities. The JAX
module's eval forward, train forward and gradient run under one jit, its
geometry through jitted copies of the package's functions (traced once a
shape for the worker) and its submanifold convs on the package's fused
path (``SCENESPLAT_CONV_APPLY=fused``).

Tolerances (fp32): the forwards and the loss 1e-5 relative to the output's
scale, every gradient tensor 1e-4 relative L2 (a gradient that is zero in
exact arithmetic, held below 1e-7 of the whole gradient on both sides),
the BatchNorm running statistics 1e-5."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import _make_scene  # noqa: E402

RTOL, GRAD_RTOL, STAT_RTOL, ZERO_GRAD = 1e-5, 1e-4, 1e-5, 1e-7
TINY_PLANES = (8, 16, 16, 16, 16, 16, 8, 8)
MINK14 = dict(type="MinkUNet14", in_channels=6, out_channels=5, planes=TINY_PLANES, init_dim=8)
MINK50 = dict(type="MinkUNet50", in_channels=6, out_channels=5, init_dim=8,
              planes=(4, 4, 4, 4, 4, 4, 4, 4), layers=(1,) * 8)


def scene(seed=0, rows=2, pad=32, channels=6, spacing=0.02):
    """``rows`` scenes of 2,048 voxels (every stride-2 cell of two levels
    holding 4 children), a padding tail: numpy arrays [rows, n, ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        _, grid, _ = _make_scene(rng, n_parents=128, children_per_parent=4, levels=2)
        n = len(grid)
        coord = grid.astype(np.float32) * spacing + rng.uniform(0, spacing, (n, 3)).astype(
            np.float32)
        feat = rng.normal(size=(n, channels)).astype(np.float32)
        out.append(dict(coord=np.concatenate([coord, np.zeros((pad, 3), np.float32)]),
                        grid=np.concatenate([grid, np.zeros((pad, 3), np.int32)]),
                        feat=np.concatenate([feat, np.zeros((pad, channels), np.float32)]),
                        mask=np.arange(n + pad) < n))
    return {k: np.stack([r[k] for r in out]) for k in out[0]}


def jax_point(s):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(s["coord"]), feat=jnp.asarray(s["feat"]),
                      grid_coord=jnp.asarray(s["grid"]), mask=jnp.asarray(s["mask"]))


def torch_point(s):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(coord=torch.from_numpy(s["coord"]), feat=torch.from_numpy(s["feat"]),
                      grid_coord=torch.from_numpy(s["grid"]).long(),
                      mask=torch.from_numpy(s["mask"]))


def fill(shapes, rng):
    """numpy values at the shapes flax gives every variable: fan-in kernels,
    norm scales near 1, small biases, running statistics away from 0/1."""
    def value(path, leaf):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif name == "cpe_weight":
            x = rng.normal(size=leaf.shape) / np.sqrt(leaf.shape[0])
        elif name == "rpe_table":
            x = 0.3 * rng.normal(size=leaf.shape)
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(value, shapes)


def jax_variables(cfg, s, seed=3):
    """The JAX model and its variables (numpy, drawn from ``seed``)."""
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False),
                            jax_point(s))
    return model, fill(shapes, np.random.default_rng(seed))


def jax_run(cfg, s, seed=3):
    """The JAX model's variables, eval forward, train forward, the train
    loss (the output times a fixed cotangent over the valid rows), its
    gradient and the updated statistics, under one jit."""
    model, variables = jax_variables(cfg, s, seed)
    point = jax_point(s)
    classes = cfg.get("out_channels", cfg.get("num_classes"))
    cot = np.random.default_rng(seed + 1).normal(size=s["mask"].shape + (classes,))
    cot = np.asarray(cot, np.float32)

    def masked(out):
        return jnp.where(point.mask[..., None], out.feat, 0.0)

    def loss(params, v):
        out, upd = model.apply({**v, "params": params}, point, train=True,
                               mutable=["batch_stats"])
        return (masked(out) * cot).sum(), (upd["batch_stats"], masked(out))

    def run(v):
        return masked(model.apply(v, point, train=False)), jax.value_and_grad(
            loss, has_aux=True)(v["params"], v)

    run = jax.jit(run).lower(variables).compile(compiler_options=FAST_COMPILE)
    fwd, ((value, (stats, train_fwd)), grads) = run(variables)
    return variables, np.asarray(fwd), np.asarray(train_fwd), float(value), stats, grads, cot


def torch_model(cfg, variables):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    return load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                             variables["batch_stats"], backbone_prefix="",
                             flax_backbone_key="")


def torch_run(model, s, cot, generator=None):
    """The port's eval forward, train forward and loss (as ``jax_run``)."""
    point = torch_point(s)
    mask = point.mask[..., None]
    model.eval()
    with torch.no_grad():
        fwd = torch.where(mask, model(point).feat, 0.0).numpy()
    model.train()
    model.zero_grad()
    out = torch.where(mask, model(point, generator=generator).feat, 0.0)
    loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    return fwd, out.detach().numpy(), loss.item()


def close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: error {err} of the largest magnitude"


def check_grads(model, grads, rtol=GRAD_RTOL):
    """Every port gradient against the JAX gradient of the same name."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    want = state_dict_from_flax(grads, {}, backbone_prefix="", flax_backbone_key="")
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
        assert err <= rtol, f"gradient of {name}: relative L2 {err}"


def check_stats(model, stats):
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    want = state_dict_from_flax({}, stats, backbone_prefix="", flax_backbone_key="")
    state = model.state_dict()
    checked = 0
    for key, w in want.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        err = np.abs(state[key].numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max()
        assert err <= STAT_RTOL, f"{key}: {err}"
        checked += 1
    assert checked


def check_model(cfg, s, seed=3, fwd_rtol=RTOL, grad_rtol=GRAD_RTOL):
    """``cfg``'s eval forward, train forward, loss, gradients and running
    statistics against JAX on rows ``s``; returns the port's model."""
    variables, fwd, train_fwd, value, stats, grads, cot = jax_run(cfg, s, seed)
    model = torch_model(cfg, variables)
    got_fwd, got_train, got_value = torch_run(model, s, cot)
    close(got_fwd, fwd, "eval forward", fwd_rtol)
    close(got_train, train_fwd, "train forward", fwd_rtol)
    assert abs(got_value - value) <= fwd_rtol * abs(value), (got_value, value)
    check_grads(model, grads, grad_rtol)
    check_stats(model, stats)
    return model


# XLA:CPU's quick code generation for the one-off jit of each JAX model (a
# quarter less compile time; outputs moved by at most 4e-7 of their scale)
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
_JITTED = {}
# the JAX geometry functions the backbones call, with their static arguments
_GEOMETRY = dict(build_pooling_plan=("out_capacity", "pooling_depth"),
                 pool_serialization=("pooling_depth", "packed"),
                 serialize=("orders", "depth"), lookup_pair_batched=("packed",),
                 build_corner_lookup=("depth", "packed"),
                 grid_cluster_plan=("grid_size", "out_capacity"))


def _jitted(name, fn):
    """``fn`` under one jax.jit kept across tests, so that every model's
    trace reuses its traced geometry at the same shapes (a SubMConvPlan's
    kernel size stays a Python int)."""
    if name not in _JITTED:
        if name == "build_subm_conv_plan":
            from scenesplat_tpu.ops.subm_conv import SubMConvPlan

            inner = jax.jit(lambda *a, **k: tuple(fn(*a, **k)[:2]),
                            static_argnames=("kernel_size", "depth", "offset_slice"))

            def plan(grid_coord, mask, kernel_size=3, **kwargs):
                return SubMConvPlan(*inner(grid_coord, mask, kernel_size=kernel_size, **kwargs),
                                    kernel_size=kernel_size)

            _JITTED[name] = plan
        else:
            _JITTED[name] = jax.jit(fn, static_argnames=_GEOMETRY[name])
    return _JITTED[name]


@pytest.fixture(autouse=True)
def jax_geometry(monkeypatch):
    """The JAX backbones' geometry (plans, serializations, lookups) through
    jitted copies of the same functions, traced once a shape for every
    test of the worker; and the package's fused submanifold conv (one
    gather and one fp32 einsum over the K3 x Cin products, as the port's
    one matmul a chunk), whose jit compiles in a third of the per-offset
    loop's time."""
    import scenesplat_tpu.models.mink_unet as mink
    import scenesplat_tpu.models.oacnns as oacnns
    import scenesplat_tpu.models.octformer as octformer
    import scenesplat_tpu.models.spvcnn as spvcnn
    import scenesplat_tpu.ops.pointops as pointops

    monkeypatch.setenv("SCENESPLAT_CONV_APPLY", "fused")
    for module in (mink, spvcnn, oacnns, octformer, pointops):
        for name in ("build_subm_conv_plan",) + tuple(_GEOMETRY):
            if hasattr(module, name):
                monkeypatch.setattr(module, name, _jitted(name, getattr(module, name)))


@pytest.mark.parametrize("cfg", [MINK14, MINK50], ids=["MinkUNet14", "MinkUNet50"])
def test_mink_unet_matches_jax(cfg):
    model = check_model(cfg, scene(0))
    assert len(model.block1) == 1 and hasattr(model.block5[0], "downsample")


def test_mink_unet_reports_its_plans():
    """The output carries the four downsamples' plans, none overflowing."""
    from scenesplat_tpu_torch.models import build_model

    s = scene(1)
    out = build_model(dict(MINK14)).eval()(torch_point(s))
    assert len(out.plans) == 4 and all(int(p.n_overflow.max()) == 0 for p in out.plans)
    assert [int(p.out_mask.sum(1).max()) for p in out.plans[:2]] == [512, 128]
