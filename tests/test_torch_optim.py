"""Port parity, optimizer and schedule: the port's torch AdamW + OneCycleLR
(param groups by keyword, per-group max_lr, the beta1 cycle, global-norm
clipping) against the JAX package's optax chain (``build_optimizer``) on
equal parameters and the same five-step gradient sequence; then SGD
(momentum, nesterov, weight decay), Adam and every other schedule
(PolyLR, CosineAnnealingLR, ExpLR, MultiStepLR, MultiStepWithWarmupLR, and
OneCycleLR's momentum cycle driving SGD) over 20 steps: every parameter
tensor within 1e-6 of its largest magnitude (float32 rounding alone moves
an element near 0 by an ulp of the values around it), each group's lr and
momentum within 1e-5 relative (the JAX schedules compute in float32: a
OneCycle lr carries about 2e-6 of rounding; the port's in float64, as the
reference's LambdaLR does)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from scenesplat_tpu.utils import optimizer as jopt  # noqa: E402
from scenesplat_tpu_torch.engines.train_step import apply_gradients  # noqa: E402
from scenesplat_tpu_torch.utils import optimizer as topt  # noqa: E402

RTOL = 1e-5
STEPS = 5
FLAGSHIP_OPT = dict(type="AdamW", lr=0.006, weight_decay=0.05)
FLAGSHIP_SCHED = dict(type="OneCycleLR", max_lr=[0.006, 0.0006], pct_start=0.05,
                      anneal_strategy="cos", div_factor=10.0, final_div_factor=1000.0)
PARAM_DICTS = [dict(keyword="block", lr=0.0006)]
# flax-style module paths and the port's names for the same parameters
NAMES = {("embedding", "kernel"): "embedding.weight",
         ("enc0_block0", "kernel"): "enc.enc0.block0.weight",
         ("enc0_block0", "bias"): "enc.enc0.block0.bias",
         ("dec0_up", "kernel"): "dec.dec0.up.weight"}
SHAPES = {"embedding": (6, 5), "enc0_block0": (5, 4), "dec0_up": (3, 7)}


class _Params(torch.nn.Module):
    """Parameters under the port's dotted names."""

    def __init__(self, arrays):
        super().__init__()
        for name, value in arrays.items():
            mod = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(torch.from_numpy(value.copy())))


def _problem(seed, grad_scales):
    rng = np.random.default_rng(seed)
    params = {}
    for (mod, leaf), _ in NAMES.items():
        shape = SHAPES[mod] if leaf == "kernel" else SHAPES[mod][-1:]
        params.setdefault(mod, {})[leaf] = rng.normal(size=shape).astype(np.float32)
    grads = []
    for s in grad_scales:  # a global norm above and below clip_grad = 1
        g = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32),
                                   params)
        norm = np.sqrt(sum(float((x ** 2).sum()) for x in jax.tree_util.tree_leaves(g)))
        grads.append(jax.tree_util.tree_map(lambda x: (x * (s / norm)).astype(np.float32), g))
    return params, grads


def _torch_arrays(tree):
    return {name: np.asarray(tree[mod][leaf]) for (mod, leaf), name in NAMES.items()}


@pytest.mark.parametrize("sched,total", [
    (FLAGSHIP_SCHED, 10),  # the flagship's: warmup shorter than a step (guarded)
    (dict(type="OneCycleLR", max_lr=[0.006, 0.0006], pct_start=0.4, anneal_strategy="linear",
          div_factor=5.0, final_div_factor=100.0, base_momentum=0.8,
          max_momentum=0.9), 8),
    (dict(FLAGSHIP_SCHED, pct_start=0.3, cycle_momentum=False), 12),
], ids=["flagship", "linear", "no_momentum_cycle"])
def test_adamw_onecycle_matches_optax_chain(sched, total):
    params, grads = _problem(7, [3.0, 0.4, 1.7, 0.9, 5.0])
    tx = jopt.build_optimizer(dict(FLAGSHIP_OPT), params, scheduler_cfg=dict(sched),
                              total_steps=total, param_dicts=PARAM_DICTS, clip_grad=1.0)
    state = tx.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    model = _Params(_torch_arrays(params))
    opt = topt.build_optimizer(dict(FLAGSHIP_OPT), model, param_dicts=PARAM_DICTS)
    names = [g["names"] for g in opt.param_groups]
    assert names == [["embedding.weight", "dec.dec0.up.weight"],
                     ["enc.enc0.block0.weight", "enc.enc0.block0.bias"]]
    sch = topt.build_scheduler(dict(sched), opt, total)

    # the JAX chain's per-group schedules, as make_tx builds them (each
    # group's peak is its own lr, which equals the max_lr list in every
    # config of the repo; the port takes the list, as torch does)
    lr_fns = [jopt.build_scheduler(dict(sched, max_lr=lr), total, lr)
              for lr in (0.006, 0.0006)]
    b1_fn = jopt.build_momentum_schedule(dict(sched), total)
    for step, g in enumerate(grads[:STEPS]):
        for group, lr_fn in zip(opt.param_groups, lr_fns):
            np.testing.assert_allclose(group["lr"], float(lr_fn(step)), rtol=RTOL)
            want_b1 = 0.9 if b1_fn is None else float(b1_fn(step))
            np.testing.assert_allclose(group["betas"][0], want_b1, rtol=RTOL)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)

        for name, value in _torch_arrays(g).items():
            model.get_parameter(name).grad = torch.from_numpy(value.copy())
        norm = apply_gradients(opt, sch, clip_grad=1.0)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(g)), rtol=RTOL)
        for name, want in _torch_arrays(jparams).items():
            np.testing.assert_allclose(model.get_parameter(name).detach().numpy(), want,
                                       rtol=RTOL, atol=1e-7, err_msg=f"{name} step {step}")


def test_grad_norm_without_clipping_and_no_scheduler():
    """clip_grad None: the gradients are applied as they are and the
    returned norm is still the global norm; no scheduler keeps the lr."""
    params, grads = _problem(8, [4.0])
    model = _Params(_torch_arrays(params))
    opt = topt.build_optimizer(dict(FLAGSHIP_OPT), model)
    assert len(opt.param_groups) == 1 and topt.build_scheduler(None, opt, 5) is None
    for name, value in _torch_arrays(grads[0]).items():
        model.get_parameter(name).grad = torch.from_numpy(value.copy())
    norm = apply_gradients(opt, None, clip_grad=None)
    np.testing.assert_allclose(float(norm), 4.0, rtol=RTOL)
    assert opt.param_groups[0]["lr"] == 0.006
    with pytest.raises(ValueError):
        topt.build_optimizer(dict(type="LAMB", lr=0.1), model)
    with pytest.raises(ValueError):
        topt.build_scheduler(dict(type="StepLR"), opt, 5)


LONG_STEPS, LONG_RTOL, SCHEDULE_RTOL = 20, 1e-6, 1e-5
PG_SGD = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.0001, nesterov=True)


@pytest.mark.parametrize("opt_cfg,sched", [
    (PG_SGD, dict(type="PolyLR")),  # Pointcept's PointGroup config
    (dict(type="SGD", lr=0.05, momentum=0.8, weight_decay=0.01), dict(type="PolyLR", power=2.0)),
    (dict(PG_SGD, nesterov=False), dict(type="CosineAnnealingLR", eta_min=0.001)),
    (PG_SGD, dict(type="ExpLR", gamma=0.5)),
    (PG_SGD, dict(type="MultiStepLR", milestones=[0.25, 0.6, 0.333], gamma=0.3)),
    # a warmup scale whose 1 - scale float32 holds exactly: JAX's float32
    # 1 - (1 - 1e-3) keeps 4 digits, the reference's (and the port's)
    # float64 all of them
    (PG_SGD, dict(type="MultiStepWithWarmupLR", milestones=[0.5, 0.8], gamma=0.2,
                  warmup_rate=0.15, warmup_scale=0.25)),
    (dict(PG_SGD, weight_decay=0.0), dict(type="OneCycleLR", max_lr=[0.1, 0.01],
                                          pct_start=0.2, base_momentum=0.8,
                                          max_momentum=0.9)),
    (dict(type="Adam", lr=0.003, weight_decay=0.01, betas=(0.8, 0.99)),
     dict(type="PolyLR")),
    (dict(type="Adam", lr=0.003, weight_decay=0.0), dict(type="OneCycleLR", max_lr=[0.003,
                                                                                   0.0003],
                                                         pct_start=0.3)),
    (dict(type="Adam", lr=0.002, weight_decay=0.05), None),
], ids=["sgd_poly", "sgd_poly_power2", "sgd_cosine", "sgd_exp", "sgd_multistep",
        "sgd_multistep_warmup", "sgd_onecycle_momentum", "adam_poly", "adam_onecycle",
        "adam_constant"])
def test_optimizer_and_schedule_match_optax_chain(opt_cfg, sched):
    """20 steps from the same parameters and gradients: each group's lr
    (and SGD's momentum or Adam's beta1 under OneCycle) and the parameters
    against the JAX package's chain, param groups by keyword (the second
    group's own lr; OneCycle's max_lr list matches the groups' lrs)."""
    lr = opt_cfg["lr"]
    param_dicts = [dict(keyword="block", lr=lr / 10)]
    params, grads = _problem(11, list(np.linspace(0.3, 3.0, LONG_STEPS)))
    tx = jopt.build_optimizer(dict(opt_cfg), params, scheduler_cfg=sched and dict(sched),
                              total_steps=LONG_STEPS, param_dicts=param_dicts, clip_grad=1.0)
    state = tx.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    model = _Params(_torch_arrays(params))
    opt = topt.build_optimizer(dict(opt_cfg), model, param_dicts=param_dicts)
    base = [g["lr"] for g in opt.param_groups]
    sch = topt.build_scheduler(sched and dict(sched), opt, LONG_STEPS)
    lr_fns = [(lambda s, b=b: b) if sched is None else
              jopt.build_scheduler(dict(sched, max_lr=b), LONG_STEPS, b) for b in base]
    mom_fn = jopt.build_momentum_schedule(sched and dict(sched), LONG_STEPS)
    for step, g in enumerate(grads):
        for group, lr_fn in zip(opt.param_groups, lr_fns):
            np.testing.assert_allclose(group["lr"], float(lr_fn(step)), rtol=SCHEDULE_RTOL,
                                       err_msg=f"lr at step {step}")
            if mom_fn is not None:
                got = group["momentum"] if opt_cfg["type"] == "SGD" else group["betas"][0]
                np.testing.assert_allclose(got, float(mom_fn(step)), rtol=SCHEDULE_RTOL)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, value in _torch_arrays(g).items():
            model.get_parameter(name).grad = torch.from_numpy(value.copy())
        apply_gradients(opt, sch, clip_grad=1.0)
        _assert_params(model, jparams, f"step {step}")


def _assert_params(model, jparams, where):
    for name, want in _torch_arrays(jparams).items():
        got = model.get_parameter(name).detach().numpy()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LONG_RTOL, f"{name} {where}: {err}"


def test_sgd_group_momentum_from_param_dicts():
    """A keyword group's own momentum (the reference's param-group rule),
    against the JAX chain."""
    params, grads = _problem(12, [1.0] * 6)
    dicts = [dict(keyword="block", lr=0.02, momentum=0.5)]
    cfg = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.001)
    tx = jopt.build_optimizer(dict(cfg), params, total_steps=6, param_dicts=dicts)
    state, jparams = tx.init(params), jax.tree_util.tree_map(jnp.asarray, params)
    model = _Params(_torch_arrays(params))
    opt = topt.build_optimizer(dict(cfg), model, param_dicts=dicts)
    assert [g["momentum"] for g in opt.param_groups] == [0.9, 0.5]
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, value in _torch_arrays(g).items():
            model.get_parameter(name).grad = torch.from_numpy(value.copy())
        apply_gradients(opt, None)
    _assert_params(model, jparams, "after 6 steps")
