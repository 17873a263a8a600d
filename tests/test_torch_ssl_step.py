"""Port parity, one SimDINO pretraining step: the port's ``ssl_loss`` and
``ssl_train_step`` (``scenesplat_tpu_torch/engines/pretrain.py``) against the
JAX package's ``make_ssl_loss_fn`` and ``make_ssl_train_step``
(``scenesplat_tpu/engines/pretrain.py``) on a two-stage cut of the SSL_TINY
SimDINOSSL of tests/test_torch_ssl.py with its MAE head: two global crops
with token masks made by JAX and injected into both batches, one local
crop, a teacher unlike the student, no drop-path and no curve shuffle. The
JAX side is one jitted ``make_ssl_train_step`` (its compile of six
backbone passes with their gradients takes about a minute on the CPU, so
it is made once): its optimizer is the SSL files' optax chain wrapped to
keep the gradient it is handed, which is ``make_ssl_loss_fn``'s, since the
step differentiates that loss; the metrics and the running statistics the
step returns are the loss's too.

Tolerances (fp32, other summation orders): the loss and every term 1e-5
relative; each gradient within 1e-4 of its largest JAX magnitude; running
statistics 1e-5 relative. After one step with the SSL files' AdamW (eps
1e-4), OneCycle and "block" group, each student value within the bound
its gradients give: Adam's first update is lr * u(g), u(g) = g / (|g| +
eps), and |u(a) - u(b)| <= 2 |a - b| / (max(|a|, |b|) + eps), so with the
port's and JAX's clipped gradients a, b at that element the two updates
differ by at most lr * 2 |a - b| / (max(|a|, |b|) + eps), plus a few fp32
roundings (2^-21 of |value| + lr). The EMA'd teacher within (1 - m) times
that bound plus 2^-21 of its value. The teacher's mask token is
untouched, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_ssl import (  # noqa: E402
    jax_ssl_model,
    numpy_variables,
    ssl_crop,
    stack_crops,
    torch_ssl_model,
    variable_shapes,
    jax_point,
)

LOSS_RTOL, GRAD_RTOL, STATS_RTOL = 1e-5, 1e-4, 1e-5
LOCALS = 1
STEP_TINY = dict(stride=(2,), enc_depths=(1, 1), enc_channels=(16, 32), enc_num_head=(1, 2),
                 enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(16,),
                 dec_num_head=(1,), dec_patch_size=(16,))
LOSS_KWARGS = dict(local_crop_num=LOCALS, enable_mae=True, mask_type="patch",
                   mask_grid_size=0.2, mask_ratio_min_max=(0.1, 0.5),
                   mask_sample_probability=0.5)
# the SSL files' optimizer and schedule (configs/scannet/ssl-pretrain-scannet-all-base.py)
OPTIMIZER = dict(type="AdamW", lr=0.001, weight_decay=0.001, eps=1e-4)
SCHEDULER = dict(type="OneCycleLR", max_lr=[0.001, 0.0001], pct_start=0.05,
                 anneal_strategy="cos", div_factor=10.0, final_div_factor=1000.0)
PARAM_DICTS = [dict(keyword="block", lr=0.0001)]
TOTAL_STEPS, CLIP_GRAD = 20, 3.0
# a zero gradient in exact arithmetic (the bias of a linear layer whose
# every consumer is a BatchNorm) is rounding noise on both sides, below this
# share of the global gradient norm (tests/test_torch_train.py)
ZERO_GRAD = 1e-7


def _keeping_gradient(tx):
    """``tx`` whose state also holds the last gradient it was handed."""
    import optax

    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def step_case():
    """Crops, JAX's token masks for the globals, variables, the JAX train
    state before the step, the step's momentum, and what the jitted JAX
    step gave: the new state, its metrics and the loss's gradient."""
    from scenesplat_tpu.engines.pretrain import SSLTrainState, make_ssl_train_step
    from scenesplat_tpu.engines.pretrain import cosine_scheduler as jcosine
    from scenesplat_tpu.models.ssl import generate_token_masks
    from scenesplat_tpu.utils import optimizer as jopt

    rng = np.random.default_rng(41)
    batch = {}
    for prefix, parents, slots in (("global_crop0", (24, 20), 112),
                                   ("global_crop1", (22, 24), 112),
                                   ("local_crop0", (12, 10), 64)):
        crop = stack_crops([ssl_crop(rng, p, slots, shift=(0.3, -0.2, 0.1)) for p in parents])
        crop["coord"] = crop["coord"] * 3.0  # several 0.2 m mask patches a crop
        batch.update({f"{prefix}_{k}": v for k, v in crop.items()})
    for i, key in enumerate(jax.random.split(jax.random.PRNGKey(9), 2)):
        p = f"global_crop{i}"
        tm, w = generate_token_masks(key, jnp.asarray(batch[f"{p}_coord"]),
                                     jnp.asarray(batch[f"{p}_mask"]), "patch", 0.2,
                                     (0.2, 0.5), 1.0)
        batch[f"{p}_token_mask"], batch[f"{p}_mask_weight"] = np.asarray(tm), np.asarray(w)
        assert batch[f"{p}_token_mask"].any(1).all()
    model = jax_ssl_model(**STEP_TINY)
    shapes = variable_shapes(model, jax_point({k[13:]: v for k, v in batch.items()
                                               if k.startswith("global_crop0_")}))
    params, stats = numpy_variables(shapes, rng)
    t_params, t_stats = numpy_variables(shapes, rng)
    tx = _keeping_gradient(jopt.build_optimizer(
        dict(OPTIMIZER), params, scheduler_cfg=dict(SCHEDULER), total_steps=TOTAL_STEPS,
        param_dicts=PARAM_DICTS, clip_grad=CLIP_GRAD))
    state = SSLTrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=tx.init(params), batch_stats=stats,
                          teacher_params=t_params["backbone_module"],
                          teacher_batch_stats=t_stats["backbone_module"],
                          rng=jax.random.PRNGKey(0))
    momentum = jcosine(0.994, 1.0, TOTAL_STEPS)(0)
    step = jax.jit(make_ssl_train_step(model, tx, **LOSS_KWARGS))
    new_state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                              jnp.asarray(momentum, jnp.float32))
    return dict(batch=batch, state=state, momentum=momentum, new_state=new_state,
                metrics=metrics, grads=new_state.opt_state[1])


def _torch_model(case):
    s = case["state"]
    return torch_ssl_model(s.params, s.batch_stats, s.teacher_params, s.teacher_batch_stats,
                           **STEP_TINY)


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()).long() if k.endswith("grid_coord")
            else torch.from_numpy(v.copy()) for k, v in batch.items()}


def _assert_stats(model, stats, teacher_stats):
    """The student's and the teacher's running statistics against JAX's."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    state = model.state_dict()
    want = state_dict_from_flax({}, {"backbone_module": stats}, teacher_params={},
                                teacher_batch_stats=teacher_stats)
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert {k.split(".")[0] for k in keys} == {"backbone", "teacher"}
    for key in keys:
        np.testing.assert_allclose(state[key].numpy(), want[key], rtol=STATS_RTOL, atol=1e-6,
                                   err_msg=key)


def test_ssl_loss_and_gradients_match_jax(step_case):
    """The composed loss, every term, every parameter's gradient and both
    backbones' running statistics after the six passes."""
    from scenesplat_tpu_torch.engines.pretrain import ssl_loss
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    case = step_case
    ref_metrics = case["metrics"]
    model = _torch_model(case).train()
    loss, metrics = ssl_loss(model, _torch_batch(case["batch"]), **LOSS_KWARGS)
    loss.backward()
    assert set(metrics) == set(ref_metrics) - {"grad_norm"} == {
        "mcr_comp_loss", "mcr_expa_loss", "sim_dino_crops_loss", "sim_ibot_patch_loss",
        "global_mae_loss", "loss"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), rtol=LOSS_RTOL, err_msg=k)

    want = state_dict_from_flax(case["grads"], {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters() if p.requires_grad}
    assert sorted(got) == sorted(want) and "backbone.mask_token" in got
    assert all(p.grad is None for p in model.teacher.parameters())
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for name, g in got.items():
        w = want[name]
        if np.linalg.norm(w) < ZERO_GRAD * total:
            assert np.linalg.norm(g) < ZERO_GRAD * total, name
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL, (name, err)
    new = case["new_state"]
    _assert_stats(model, new.batch_stats["backbone_module"], new.teacher_batch_stats)


def test_ssl_train_step_matches_jax(step_case):
    """One step with clipping, AdamW + OneCycle and the EMA at the
    schedule's first momentum: the teacher, its mask token, both backbones'
    running statistics, and the logged terms with ``grad_norm``."""
    from scenesplat_tpu_torch.engines.pretrain import cosine_scheduler, ssl_train_step
    from scenesplat_tpu_torch.utils.optimizer import build_optimizer, build_scheduler
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    case = step_case
    state, new_state, momentum = case["state"], case["new_state"], case["momentum"]
    assert cosine_scheduler(0.994, 1.0, TOTAL_STEPS)(0) == momentum == pytest.approx(0.994)
    model = _torch_model(case)
    teacher_token = model.teacher.mask_token.detach().clone()
    optimizer = build_optimizer(dict(OPTIMIZER), model, param_dicts=PARAM_DICTS)
    scheduler = build_scheduler(dict(SCHEDULER), optimizer, TOTAL_STEPS)
    names = {id(p): k for k, p in model.named_parameters()}
    lr_of = {names[id(p)]: g["lr"] for g in optimizer.param_groups for p in g["params"]}
    metrics = ssl_train_step(model, optimizer, scheduler, _torch_batch(case["batch"]),
                             momentum, clip_grad=CLIP_GRAD, **LOSS_KWARGS)
    assert set(metrics) == set(case["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(case["metrics"][k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    assert metrics["grad_norm"].item() > CLIP_GRAD  # the clip acts

    assert torch.equal(model.teacher.mask_token, teacher_token)
    np.testing.assert_array_equal(np.asarray(new_state.teacher_params["mask_token"]),
                                  np.asarray(state.teacher_params["mask_token"]))
    # the student: each element within the bound its two clipped gradients give
    grads = state_dict_from_flax(case["grads"], {})
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    clip = CLIP_GRAD / max(norm, CLIP_GRAD)
    params = dict(model.named_parameters())
    want = state_dict_from_flax(new_state.params, {})
    assert sorted(want) == sorted(lr_of) and len(want) > 50
    student_tol = {}
    for key, w in want.items():
        a, b = params[key].grad.numpy(), grads[key] * clip
        lr = lr_of[key]
        student_tol[key] = (lr * 2 * np.abs(a - b) / (np.maximum(np.abs(a), np.abs(b))
                                                      + OPTIMIZER["eps"])
                            + 2.0 ** -21 * (np.abs(w) + lr))
        err = np.abs(params[key].detach().numpy() - w)
        assert (err <= student_tol[key]).all(), (key, (err / student_tol[key]).max())
    # the teacher: m t + (1 - m) s of those students
    want = state_dict_from_flax({}, {}, teacher_params=new_state.teacher_params)
    before = state_dict_from_flax({}, {}, teacher_params=state.teacher_params)
    got = model.state_dict()
    moved = 0
    for key, w in want.items():
        tol = (1 - momentum) * student_tol["backbone." + key[len("teacher."):]] + (
            2.0 ** -21 * np.abs(w))
        err = np.abs(got[key].numpy() - w)
        assert (err <= tol).all(), (key, (err / tol).max())
        moved += not np.array_equal(w, before[key])
    assert moved == len(want) - 1  # every teacher parameter but the mask token
    _assert_stats(model, new_state.batch_stats["backbone_module"],
                  new_state.teacher_batch_stats)
