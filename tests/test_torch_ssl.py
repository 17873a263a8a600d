"""Port parity, SimDINO SSL components against ``scenesplat_tpu/models/ssl.py``
on the same numpy inputs: the DINO, iBOT and MAE heads, ``mcr_loss`` (value
and gradients), ``cosine_patch_loss``, ``masked_mean_pool``, the token masks
from JAX's own draws (equal), PT-v3m1 with ``token_mask`` and
``return_enc``, and ``state_dict_from_flax`` on a whole SimDINOSSL tree with
its teacher, loaded with strict=True.

fp32 throughout. Tolerances: values 1e-5 relative (other summation orders),
gradients 1e-4 of the largest magnitude of the JAX gradient, backbone
features the export bridge's 1e-4 relative / 2e-4 absolute; token masks
and weights equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import _make_scene  # noqa: E402

RTOL = 1e-5
GRAD_RTOL = 1e-4  # of the largest magnitude of the JAX gradient
FEAT_RTOL, FEAT_ATOL = 1e-4, 2e-4
# a 3-stage backbone at the SSL files' settings that shape the path: 11
# input channels, max pooling, serialization depth 10, two curves;
# deterministic (no drop-path, no curve shuffle) so both sides see one
# forward
SSL_TINY = dict(
    type="PT-v3m1", in_channels=11, order=("z", "z-trans"), stride=(2, 2),
    enc_depths=(1, 1, 1), enc_channels=(16, 16, 32), enc_num_head=(1, 1, 2),
    enc_patch_size=(16, 16, 16), dec_depths=(1, 1), dec_channels=(16, 16),
    dec_num_head=(1, 1), dec_patch_size=(16, 16), mlp_ratio=2, drop_path=0.0,
    shuffle_orders=False, pool_reduce="max", serialization_depth=10)
HEADS = dict(dino_out_dim=16, dino_hidden_dim=32, ibot_out_dim=8, ibot_hidden_dim=16)


def ssl_crop(rng, n_parents, n_slots, shift=(0.0, 0.0, 0.0)):
    """One crop: a pooling-exact scene of 4 * ``n_parents`` points
    (tests/test_full_model_golden.py), 11 Gaussian features, padded to
    ``n_slots``, coordinates moved by ``shift``."""
    coord, grid, _ = _make_scene(rng, n_parents=n_parents, levels=2)
    n = len(grid)
    pad = n_slots - n
    feat = rng.normal(size=(n, 11)).astype(np.float32)
    coord = coord + np.asarray(shift, np.float32)
    mask = np.arange(n + pad) < n
    return dict(coord=np.concatenate([coord, np.zeros((pad, 3), np.float32)]),
                grid_coord=np.concatenate([grid, np.zeros((pad, 3), np.int32)]),
                feat=np.concatenate([feat, np.zeros((pad, 11), np.float32)]), mask=mask)


def stack_crops(crops):
    return {k: np.stack([c[k] for c in crops]) for k in crops[0]}


def jax_ssl_model(enable_mae=True, **backbone):
    from scenesplat_tpu.models.ssl import SimDINOSSL

    return SimDINOSSL(backbone=dict(SSL_TINY, use_pallas=False, upcast_softmax=True,
                                    **backbone),
                      enable_mae=enable_mae, mae_out_dim=11, **HEADS)


def jax_point(crop):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(crop["coord"]), feat=jnp.asarray(crop["feat"]),
                      grid_coord=jnp.asarray(crop["grid_coord"]),
                      mask=jnp.asarray(crop["mask"]))


def torch_point(crop):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(coord=torch.from_numpy(crop["coord"]),
                      feat=torch.from_numpy(crop["feat"]),
                      grid_coord=torch.from_numpy(crop["grid_coord"]).long(),
                      mask=torch.from_numpy(crop["mask"]))


def variable_shapes(model, point):
    """The shapes of the flax variables (``jax.eval_shape`` traces the init
    without compiling it)."""
    return jax.eval_shape(lambda p: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)}, p, train=False), point)


def numpy_variables(shapes, rng):
    """Parameters and BatchNorm statistics made with numpy from ``rng`` at
    the flax ``shapes``: fan-in scaled kernels, norm scales near 1, small
    biases, running statistics away from their init, a mask token of the
    init's scale."""

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            x = rng.normal(size=leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        elif name == "mask_token":
            x = 0.5 * rng.normal(size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return variables["params"], variables["batch_stats"]


def torch_ssl_model(params, stats, teacher_params, teacher_stats, enable_mae=True,
                    **backbone):
    """The port's SimDINOSSL at SSL_TINY with the JAX variables carried over
    (strict=True)."""
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    model = build_model(dict(type="SimDINOSSL", backbone=dict(SSL_TINY, **backbone),
                             enable_mae=enable_mae, mae_out_dim=11, **HEADS))
    state = state_dict_from_flax(params, stats, teacher_params=teacher_params,
                                 teacher_batch_stats=teacher_stats)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    return model


@pytest.fixture(scope="module")
def ssl_case():
    """A batch of two padded crops of 96 and 72 points, the JAX SimDINOSSL's
    variables, and a teacher made apart from the student."""
    rng = np.random.default_rng(31)
    crops = stack_crops([ssl_crop(rng, 24, 112), ssl_crop(rng, 18, 112)])
    model = jax_ssl_model()
    shapes = variable_shapes(model, jax_point(crops))
    params, stats = numpy_variables(shapes, rng)
    t_params, t_stats = numpy_variables(shapes, rng)
    return dict(crops=crops, model=model, params=params, stats=stats,
                teacher_params=t_params["backbone_module"],
                teacher_stats=t_stats["backbone_module"])


def test_state_dict_from_flax_loads_simdino_strict(ssl_case):
    """Every entry of the port's SimDINOSSL state dict comes from the flax
    tree (student, teacher, heads), each equal to its source."""
    c = ssl_case
    model = torch_ssl_model(c["params"], c["stats"], c["teacher_params"], c["teacher_stats"])
    state = model.state_dict()
    assert state["backbone.mask_token"].shape == (1, 16)
    np.testing.assert_array_equal(state["backbone.mask_token"][0].numpy(),
                                  c["params"]["backbone_module"]["mask_token"])
    np.testing.assert_array_equal(state["teacher.mask_token"][0].numpy(),
                                  c["teacher_params"]["mask_token"])
    np.testing.assert_array_equal(state["dino_head.fc2.weight"].numpy(),
                                  np.asarray(c["params"]["dino_head"]["fc2"]["kernel"]).T)
    np.testing.assert_array_equal(state["mae_norm.weight"].numpy(),
                                  c["params"]["mae_norm"]["scale"])
    np.testing.assert_array_equal(
        state["teacher.enc.enc1.down.norm.0.running_var"].numpy(),
        c["teacher_stats"]["enc1_down"]["norm"]["var"])
    assert not any(p.requires_grad for p in model.teacher.parameters())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_backbone_token_mask_and_return_enc_match_jax(ssl_case, train):
    """PT-v3m1 with the mask token over a token mask and return_enc: the
    decoder output, the coarsest encoder stage and its mask equal the JAX
    module's; in train mode BatchNorm normalizes with the batch's moments,
    and the running statistics it leaves equal JAX's too."""
    from scenesplat_tpu.models.ssl import SimDINOSSL
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    c = ssl_case
    rng = np.random.default_rng(5)
    token_mask = (rng.random(c["crops"]["mask"].shape) < 0.4) & c["crops"]["mask"]
    variables = {"params": c["params"], "batch_stats": c["stats"]}

    def run(v, p, tm):
        return c["model"].apply(v, p, train, tm, True, method=SimDINOSSL.backbone_apply,
                                mutable=["batch_stats"] if train else False)

    out = jax.jit(run)(variables, jax_point(c["crops"]), jnp.asarray(token_mask))
    (dec, enc, enc_mask), updates = out if train else (out, None)

    model = torch_ssl_model(c["params"], c["stats"], c["teacher_params"], c["teacher_stats"])
    model.train(train)
    with torch.no_grad():
        t_dec, t_enc, t_mask = model.backbone(torch_point(c["crops"]),
                                              token_mask=torch.from_numpy(token_mask),
                                              return_enc=True)
    mask = c["crops"]["mask"]
    np.testing.assert_allclose(t_dec.feat.numpy()[mask], np.asarray(dec.feat)[mask],
                               rtol=FEAT_RTOL, atol=FEAT_ATOL)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(enc_mask))
    em = np.asarray(enc_mask)
    np.testing.assert_allclose(t_enc.numpy()[em], np.asarray(enc)[em], rtol=FEAT_RTOL,
                               atol=FEAT_ATOL)
    if train:
        after = state_dict_from_flax(c["params"], updates["batch_stats"])
        state = model.state_dict()
        keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
        assert len(keys) == 2 * 7  # the stem, 2 poolings, 2 unpoolings x 2
        for key in keys:
            np.testing.assert_allclose(state[key].numpy(), after[key], rtol=RTOL,
                                       atol=1e-6, err_msg=key)
    # the mask token moved the features: without it they differ
    with torch.no_grad():
        plain = model.backbone(torch_point(c["crops"]))
    assert np.abs(plain.feat.numpy()[mask] - t_dec.feat.numpy()[mask]).max() > 1e-2


def _unit_rows(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_heads_match_jax(ssl_case):
    """The DINO head on pooled features, the iBOT and MAE heads on decoder
    tokens (a bf16 input promoted to fp32 as flax does)."""
    from scenesplat_tpu.models.ssl import SimDINOSSL

    c = ssl_case
    model = torch_ssl_model(c["params"], c["stats"], c["teacher_params"], c["teacher_stats"])
    rng = np.random.default_rng(8)
    pooled = rng.normal(size=(3, 32)).astype(np.float32)
    tokens = rng.normal(size=(2, 40, 16)).astype(np.float32)
    tokens16 = np.asarray(jnp.asarray(tokens, jnp.bfloat16).astype(jnp.float32))
    v = {"params": c["params"]}
    for method, x, torch_fn in (
            (SimDINOSSL.apply_dino_head, pooled, model.dino_head),
            (SimDINOSSL.apply_ibot_head, tokens, model.ibot_head),
            (SimDINOSSL.apply_mae_head, tokens, model.mae_head)):
        want = np.asarray(c["model"].apply(v, jnp.asarray(x), method=method))
        with torch.no_grad():
            got = torch_fn(torch.from_numpy(x))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6,
                                   err_msg=method.__name__)
    want = np.asarray(c["model"].apply(v, jnp.asarray(tokens, jnp.bfloat16),
                                       method=SimDINOSSL.apply_ibot_head))
    with torch.no_grad():
        got = model.ibot_head(torch.from_numpy(tokens).bfloat16())
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(torch.from_numpy(tokens).bfloat16().float().numpy(),
                                  tokens16)


@pytest.mark.parametrize("n_student,m,d", [(5, 2, 16), (4, 6, 32)])
def test_mcr_loss_and_gradients_match_jax(n_student, m, d):
    from scenesplat_tpu.models.ssl import mcr_loss as jmcr
    from scenesplat_tpu_torch.models.ssl import mcr_loss

    rng = np.random.default_rng(n_student * 10 + m)
    s = _unit_rows(rng, n_student, m, d)
    t = _unit_rows(rng, 2, m, d)

    def jloss(s_, t_):
        loss, met = jmcr(list(s_), list(t_))
        return loss, met

    (want, wmet), (gs, gt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(s), jnp.asarray(t))
    st = torch.from_numpy(s).requires_grad_(True)
    tt = torch.from_numpy(t).requires_grad_(True)
    loss, met = mcr_loss(list(st), list(tt))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    for k in ("mcr_comp_loss", "mcr_expa_loss"):
        np.testing.assert_allclose(met[k].item(), float(wmet[k]), rtol=RTOL, err_msg=k)
    gs = np.asarray(gs)
    assert np.abs(st.grad.numpy() - gs).max() <= GRAD_RTOL * np.abs(gs).max()
    assert tt.grad is None or not tt.grad.any()  # the teacher side is detached
    assert not np.asarray(gt).any()


def test_cosine_patch_loss_and_pool_match_jax():
    from scenesplat_tpu.models.ssl import cosine_patch_loss as jcos
    from scenesplat_tpu.ops.segops import masked_mean_pool as jpool
    from scenesplat_tpu_torch.models.ssl import cosine_patch_loss
    from scenesplat_tpu_torch.ops.segops import masked_mean_pool

    rng = np.random.default_rng(4)
    s, t = _unit_rows(rng, 50, 8), _unit_rows(rng, 50, 8)
    w = (rng.random(50) < 0.4) * rng.uniform(0.1, 1, 50).astype(np.float32)
    want, g = jax.value_and_grad(lambda a: jcos(a, jnp.asarray(t), jnp.asarray(w)))(
        jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    loss = cosine_patch_loss(st, torch.from_numpy(t), torch.from_numpy(w))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(g), rtol=RTOL, atol=1e-7)

    values = rng.normal(size=(3, 20, 5)).astype(np.float32)
    mask = rng.random((3, 20)) < 0.6
    mask[2] = False  # no valid point: zeros
    np.testing.assert_allclose(
        masked_mean_pool(torch.from_numpy(values), torch.from_numpy(mask)).numpy(),
        np.asarray(jpool(jnp.asarray(values), jnp.asarray(mask))), rtol=RTOL, atol=1e-7)


def _jax_draws(key, b, n, mask_type, ratio, prob):
    """The draws ``scenesplat_tpu/models/ssl.py:generate_token_masks`` makes
    from ``key``, made the same way."""
    k_sample, k_rate, k_unit = jax.random.split(key, 3)
    sample_on = jax.random.bernoulli(k_sample, prob, (b, 1))
    rate = jax.random.uniform(k_rate, (b, 1), minval=ratio[0], maxval=ratio[1])
    unit = (jax.random.uniform(k_unit, (b, n)) if mask_type == "splats" else
            jax.random.randint(k_unit, (b, 1), 0, 2 ** 30, dtype=jnp.int32))
    return [torch.from_numpy(np.array(x)) for x in (sample_on, rate, unit)]


@pytest.mark.parametrize("mask_type,shift", [
    ("patch", (0.1, 0.25, 0.45)),  # crops off the origin: the padding's 0 sets the minimum
    ("patch", (-0.4, -0.3, -0.5)),  # centred crops: valid points set it
    ("patch", (3.1, 2.7, 0.4)),  # far from the origin
    ("splats", (0.0, 0.0, 0.0)),
])
def test_token_masks_from_jax_draws_equal(mask_type, shift):
    """Masks and weights from the draws JAX makes equal JAX's, bit for bit,
    over padded crops; one row not sampled."""
    from scenesplat_tpu.models.ssl import generate_token_masks as jgen
    from scenesplat_tpu_torch.models.ssl import token_masks_from_draws

    rng = np.random.default_rng(17)
    crops = stack_crops([ssl_crop(rng, 24 - 2 * i, 120, shift=shift) for i in range(4)])
    crops["coord"] = crops["coord"] * 4.0  # several 0.2 m patches a crop
    b, n = crops["mask"].shape
    ratio, prob = (0.2, 0.6), 0.7
    key = jax.random.PRNGKey(2)
    want_mask, want_w = jgen(key, jnp.asarray(crops["coord"]), jnp.asarray(crops["mask"]),
                             mask_type, 0.2, ratio, prob)
    draws = _jax_draws(key, b, n, mask_type, ratio, prob)
    assert not draws[0].all() and draws[0].any()  # one row not sampled, others are
    got_mask, got_w = token_masks_from_draws(
        torch.from_numpy(crops["coord"]), torch.from_numpy(crops["mask"]), *draws,
        mask_type=mask_type, mask_grid_size=0.2)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    assert got_mask.any() and got_w.dtype == torch.float32
    if mask_type == "patch" and min(shift) > 0:
        valid_min = np.floor(crops["coord"][crops["mask"]] / 0.2).min(0)
        assert (valid_min > 0).all()  # the padding's minimum is not the valid one


def test_generate_token_masks_draws_from_the_generator():
    """The same generator state gives the same masks; the rate and the
    sampled rows follow the arguments."""
    from scenesplat_tpu_torch.models.ssl import generate_token_masks

    rng = np.random.default_rng(2)
    crops = stack_crops([ssl_crop(rng, 24, 96) for _ in range(3)])
    coord, mask = torch.from_numpy(crops["coord"] * 4), torch.from_numpy(crops["mask"])
    a = generate_token_masks(torch.Generator().manual_seed(1), coord, mask)
    b = generate_token_masks(torch.Generator().manual_seed(1), coord, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    off, _ = generate_token_masks(torch.Generator().manual_seed(1), coord, mask,
                                  mask_sample_probability=0.0)
    assert not off.any()
    on, w = generate_token_masks(torch.Generator().manual_seed(1), coord, mask,
                                 mask_type="splats", mask_ratio_min_max=(0.3, 0.3),
                                 mask_sample_probability=1.0)
    frac = on.float().mean(1)
    assert ((frac > 0.15) & (frac < 0.45)).all()
    assert (w[~on] == 0).all()


@pytest.mark.parametrize("reduce", ["max", "min"])
def test_max_pooling_gradients_match_jax(reduce):
    """The SSL files pool by max: the port's pool_values is differentiable
    there (an in-place write after the scatter once broke its backward) and
    its gradient, ties shared evenly, equals JAX's segment_reduce gradient
    on the same plan."""
    from scenesplat_tpu.ops.segops import segment_reduce
    from scenesplat_tpu_torch.ops.segops import build_pooling_plan, pool_values
    from scenesplat_tpu_torch.ops.serialization import serialize

    rng = np.random.default_rng(9)
    b, n, c = 2, 300, 5
    grid = torch.from_numpy(rng.integers(0, 12, (b, n, 3)))
    mask = torch.from_numpy(np.arange(n)[None] < np.array([[n], [n - 40]]))
    plan = build_pooling_plan(serialize(grid, mask, ("z",), depth=10), mask, 256, 1)
    values = rng.normal(size=(b, n, c)).astype(np.float32)
    values[:, ::7] = values[:, 3:4]  # ties inside clusters
    w = rng.normal(size=(b, 256, c)).astype(np.float32)
    v = torch.from_numpy(values).requires_grad_(True)
    out = pool_values(plan, v, reduce)
    (out * torch.from_numpy(w)).sum().backward()

    order0, seg = (jnp.asarray(t.numpy()) for t in (plan.order0, plan.seg_sorted))
    counts = jnp.concatenate([jnp.asarray(plan.counts.numpy(), jnp.int32),
                              jnp.zeros((b, 1), jnp.int32)], 1)

    def jax_pool(x):
        sorted_vals = jnp.take_along_axis(x, order0[..., None], axis=1)
        return segment_reduce(sorted_vals, seg, 257, counts, reduce)[:, :256]

    want_out = jax_pool(jnp.asarray(values))
    want = jax.grad(lambda x: (jax_pool(x) * jnp.asarray(w)).sum())(jnp.asarray(values))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_out))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    assert (v.grad.numpy() != 0).sum() >= int(plan.out_mask.sum()) * c // 2
