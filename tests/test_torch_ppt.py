"""Port parity, Point Prompt Training: PDNorm, PT-v3m1 with
``pdnorm_conditions``, PPT-v1m1 and PPT-v1m2 against the JAX package on the
same numpy inputs (weights carried by ``utils/weights.py`` and loaded with
strict=True), and the four places where the JAX package's PPT path departs
from the reference, each shown beside what the port does:

  1. the condition reaches PDNorm by index (JAX) or by name (port);
  2. every condition's BatchNorm takes the batch's statistics (JAX) or only
     the active one (port);
  3. no transform writes the step's ``condition_index`` (JAX) or ``Add``'s
     ``condition`` reaches the step (port);
  4. the evaluator and the tester raise on a PPT model (JAX) or score each
     scene on its condition (port).

Plus ``MultiDatasetTrainer`` with the ``ppt`` task through the train and
test entry points on two tiny children.

The backbone is tiny (2 stages, widths 8/16, windows of 16, one curve, no
drop-path). Tolerances: forwards rtol 1e-4 / atol 2e-4
(tests/test_torch_model.py), steps' losses 1e-5 relative
(tests/test_torch_semseg.py) and each gradient tensor 1e-4 relative L2
(tests/test_torch_semseg_step.py), fp32: at these gradients' magnitudes
(up to 1e2) fp32 summation order alone moves elements by 5e-4, so the
1e-6 absolute bar of the loss tests does not apply. A gradient that is
zero in exact arithmetic (the bias of a linear layer whose consumers are
all BatchNorms) is held below 1e-7 of the whole gradient's norm on both
sides."""

import copy
import glob
import json
import logging
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_full_model_golden import _make_scene  # noqa: E402
from tests.test_torch_semseg import (  # noqa: E402,F401 (fixtures)
    FEAT_KEYS,
    GS_KEYS,
    _criteria_cfg,
    _pipelines,
    gs_root,
    one_torch_thread,
)

RTOL, ATOL = 1e-4, 2e-4
LOSS_RTOL, GRAD_RTOL, ZERO_GRAD = 1e-5, 1e-4, 1e-7
CTX = 16
# the backbone's (PDNorm's) order and the PPT model's, different as in the
# published file (which has a third condition)
CONDITIONS = ("ScanNet", "S3DIS")
PPT_ORDER = ("S3DIS", "ScanNet")
NAMES = ("wall", "floor", "chair", "table", "sofa", "bed")
VALID = {"ScanNet": (0, 1, 2, 3), "S3DIS": (0, 1, 4)}
NUM_CLASSES = {"ScanNet": 4, "S3DIS": 3}
TINY = dict(
    in_channels=6, order=("z",), stride=(2,), enc_depths=(1, 1), enc_channels=(8, 16),
    enc_num_head=(2, 2), enc_patch_size=(16, 16), dec_depths=(1,), dec_channels=(8,),
    dec_num_head=(2,), dec_patch_size=(16,), mlp_ratio=2, drop_path=0.0,
    serialization_depth=10, stage_capacity=(0.5,))


# ---- inputs and weights ---------------------------------------------------------

def _scene(seed=0, rows=2, pad=16):
    """``rows`` scenes whose pooled counts halve exactly, a padding tail,
    and labels 0..5 with ignored points: numpy arrays [rows, n, ...]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rows):
        coord, grid, feat = _make_scene(rng, n_parents=32, levels=1)
        n = len(grid)
        seg = rng.integers(0, 3, n + pad)
        seg[(rng.random(n + pad) < 0.1) | (np.arange(n + pad) >= n)] = -1
        out.append(dict(coord=np.concatenate([coord, np.zeros((pad, 3), np.float32)]),
                        grid=np.concatenate([grid, np.zeros((pad, 3), np.int32)]),
                        feat=np.concatenate([feat, np.zeros((pad, 6), np.float32)]),
                        mask=np.arange(n + pad) < n, segment=seg.astype(np.int64)))
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
    """numpy values at the shapes flax would give every variable: fan-in
    kernels, norm scales near 1, small biases, running statistics away from
    0/1, N(0, 1) context rows, a random class table and RPE table."""
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
        elif name in ("embedding", "class_embedding"):
            x = rng.normal(size=leaf.shape)
        elif name == "logit_scale":
            x = np.log(1 / 0.07) + 0.1 * rng.normal(size=leaf.shape)
        elif name == "rpe_table":
            x = 0.5 * rng.normal(size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _backbone(conditions=CONDITIONS, **extra):
    return dict(TINY, type="PT-v3m1", pdnorm_conditions=conditions, context_channels=CTX,
                **extra)


def _model_cfg(kind, ppt_conditions=CONDITIONS, bb_conditions=CONDITIONS, **bb_extra):
    backbone = _backbone(bb_conditions, **bb_extra)
    if kind == "backbone":
        return backbone
    if kind == "v1m1":
        return dict(type="PPT-v1m1", backbone=backbone, backbone_out_channels=8,
                    context_channels=CTX, conditions=ppt_conditions, class_name=NAMES,
                    valid_index=tuple(VALID[c] for c in ppt_conditions), text_channels=12)
    return dict(type="PPT-v1m2", backbone=backbone, backbone_out_channels=8,
                context_channels=CTX, conditions=ppt_conditions,
                num_classes=tuple(NUM_CLASSES[c] for c in ppt_conditions))


def _jax_cfg(cfg):
    cfg = copy.deepcopy(cfg)
    bb = cfg["backbone"] if "backbone" in cfg else cfg
    bb["use_pallas"] = False
    return cfg


_SHAPES = {}


def _jax_case(cfg, s, seed=3):
    """The JAX model and numpy-made variables (params, batch_stats, and
    constants for v1m1); the variables' shapes are traced once a config and
    input shape."""
    from scenesplat_tpu.models import build_model

    model = build_model(_jax_cfg(cfg))
    point = _jax_point(s)
    key = (repr(cfg), s["feat"].shape)
    if key not in _SHAPES:
        if cfg["type"] == "PT-v3m1":
            init = lambda p: model.init(  # noqa: E731
                jax.random.PRNGKey(0), p, train=False,
                condition_index=jnp.zeros((), jnp.int32), context=jnp.zeros((p.batch_size, CTX)))
        else:
            init = lambda p: model.init(  # noqa: E731
                jax.random.PRNGKey(0), p, jnp.zeros((), jnp.int32), train=False)
        _SHAPES[key] = jax.eval_shape(init, point)
    return model, point, _fill(_SHAPES[key], np.random.default_rng(seed))


_JITTED = {}


def _jitted(cfg):
    """One jitted function a config (its one compile, the condition traced):
    ``run(variables, point, ci, ctx, target)`` -> (the JAX model's eval
    forward, ((its training loss, the updated statistics), the gradient
    w.r.t. params and ctx)). The backbone's loss is the sum of its features
    times ``target``, a PPT model's the semseg criteria against ``target``
    labels, as the JAX step computes it for task "ppt"."""
    key = repr(cfg)
    if key not in _JITTED:
        from scenesplat_tpu.models import build_model
        from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria

        model = build_model(_jax_cfg(cfg))
        backbone = cfg["type"] == "PT-v3m1"
        crit = jcriteria(_criteria_cfg())

        def apply(variables, point, ci, ctx, train):
            kw = dict(condition_index=ci, context=ctx) if backbone else {}
            return model.apply(variables, point, *(() if backbone else (ci,)), train=train,
                               rngs={"dropout": jax.random.PRNGKey(1)},
                               mutable=["batch_stats"], **kw)

        def fwd(variables, point, ci, ctx):
            return apply(variables, point, ci, ctx, False)[0].feat

        def loss(params, ctx, variables, point, ci, target):
            out, upd = apply({**variables, "params": params}, point, ci, ctx, True)
            value = ((out.feat * target).sum() if backbone
                     else crit(out.feat, target, mask=out.mask))
            return value, upd["batch_stats"]

        grad = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
        _JITTED[key] = jax.jit(lambda v, p, ci, ctx, target: (
            fwd(v, p, ci, ctx), grad(v["params"], ctx, v, p, ci, target)))
    return _JITTED[key]


def _torch_model(cfg, variables):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    model = build_model(copy.deepcopy(cfg))
    prefix = dict(backbone_prefix="", flax_backbone_key="") if cfg["type"] == "PT-v3m1" else {}
    return load_flax_weights(model, variables["params"], variables["batch_stats"],
                             constants=variables.get("constants"), **prefix)


def _norm_condition(key):
    """The condition index of a PDNorm entry (``...norm.{c}.<leaf>``), else None."""
    m = re.search(r"\.norm\.(\d+)\.(weight|bias|running_mean|running_var)$", key)
    return None if m is None else int(m.group(1))


# ---- PDNorm ---------------------------------------------------------------------

def _pdnorm_state(params, stats, decouple):
    """A flax PDNorm's variables in the port PDNorm's names."""
    out = {}
    for key in sorted(k for k in params if k.startswith("norm")):
        t = f"norm.{key[4:]}" if decouple else "norm"
        out[f"{t}.weight"], out[f"{t}.bias"] = params[key]["scale"], params[key]["bias"]
        if key in stats:
            out[f"{t}.running_mean"], out[f"{t}.running_var"] = (stats[key]["mean"],
                                                                 stats[key]["var"])
            out[f"{t}.num_batches_tracked"] = np.zeros((), np.int64)
    if "modulation" in params:
        out["modulation.1.weight"] = np.asarray(params["modulation"]["kernel"]).T
        out["modulation.1.bias"] = params["modulation"]["bias"]
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("decouple", [True, False])
@pytest.mark.parametrize("norm_type", ["ln", "bn"])
def test_pdnorm_matches_jax(norm_type, decouple, adaptive):
    """Each condition (the two order tuples equal): the output, and for bn
    in training the active norm's running statistics after the step."""
    from scenesplat_tpu.models.norm import PDNorm as JPDNorm
    from scenesplat_tpu_torch.models.norm import PDNorm

    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 2.0, (2, 40, 8)).astype(np.float32)
    mask = rng.random((2, 40)) < 0.8
    ctx = rng.normal(size=(2, CTX)).astype(np.float32)
    jmod = JPDNorm(8, conditions=CONDITIONS, norm_type=norm_type, decouple=decouple,
                   adaptive=adaptive, context_channels=CTX)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), 0,
                                              mask=jnp.asarray(mask), context=jnp.asarray(ctx),
                                              use_running_average=True))
    variables = _fill(shapes, rng)
    stats = variables.get("batch_stats", {})
    for ci, name in enumerate(CONDITIONS):
        for train in ((False, True) if norm_type == "bn" else (False,)):
            mod = PDNorm(8, CONDITIONS, norm_type=norm_type, decouple=decouple,
                         adaptive=adaptive, context_channels=CTX)
            mod.load_state_dict(_pdnorm_state(variables["params"], stats, decouple), strict=True)
            mod.train(train)
            ref, upd = jmod.apply(variables, jnp.asarray(x), ci, mask=jnp.asarray(mask),
                                  context=jnp.asarray(ctx), use_running_average=not train,
                                  mutable=["batch_stats"])
            got = mod(torch.from_numpy(x), name, context=torch.from_numpy(ctx),
                      mask=torch.from_numpy(mask))
            sel = mask if train else np.ones_like(mask)  # padding rows are zeros in training
            np.testing.assert_allclose(got.detach().numpy()[sel], np.asarray(ref)[sel],
                                       rtol=RTOL, atol=ATOL)
            if train:
                key = f"norm{ci if decouple else 0}"
                t = f"norm.{ci}" if decouple else "norm"
                for leaf, buf in (("mean", "running_mean"), ("var", "running_var")):
                    np.testing.assert_allclose(
                        mod.state_dict()[f"{t}.{buf}"].numpy(),
                        np.asarray(upd["batch_stats"][key][leaf]), rtol=1e-5, atol=1e-6)


# ---- PT-v3m1 with pdnorm_conditions, PPT-v1m1 and PPT-v1m2 ------------------------------

def _assert_grads(got, want):
    """Each gradient the port computed against JAX's, to GRAD_RTOL relative
    L2 (or both below ZERO_GRAD of the whole); a parameter without a port
    gradient (another condition's norm or head, an unused context table)
    has an exactly zero JAX gradient."""
    assert set(got) <= set(want)
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for name, w in want.items():
        if name not in got:
            assert not np.any(w), f"{name}: JAX gradient {np.abs(w).max()}, port none"
            continue
        g = got[name]
        if np.linalg.norm(w) < ZERO_GRAD * total:
            assert np.linalg.norm(g) < ZERO_GRAD * total, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (name, err)


@pytest.mark.parametrize("condition", CONDITIONS)
def test_ptv3_pdnorm_matches_jax(condition):
    """The backbone alone (adaptive PDNorms, a context per row): the eval
    forward, and the training forward's gradients w.r.t. every parameter and
    the context."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    s = _scene(0)
    cfg = _model_cfg("backbone", pdnorm_adaptive=True)
    _, point, variables = _jax_case(cfg, s)
    ci = jnp.asarray(CONDITIONS.index(condition))
    ctx = np.random.default_rng(5).normal(size=(2, CTX)).astype(np.float32)
    m = s["mask"]
    w = np.random.default_rng(6).normal(size=(2, 80, 8)).astype(np.float32) * m[..., None]
    ref, ((ref_loss, _), (gp, gc)) = _jitted(cfg)(variables, point, ci, jnp.asarray(ctx),
                                                  jnp.asarray(w))
    model = _torch_model(cfg, variables).eval()
    got = model(_torch_point(s), condition=condition, context=torch.from_numpy(ctx)).feat
    np.testing.assert_allclose(got.detach().numpy()[m], np.asarray(ref)[m], rtol=RTOL, atol=ATOL)
    model.train()
    c = torch.from_numpy(ctx).requires_grad_(True)
    out = model(_torch_point(s), condition=condition, context=c)
    tl = (out.feat * torch.from_numpy(w)).sum()
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(ref_loss), rtol=LOSS_RTOL)
    _assert_grads({k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None},
                  state_dict_from_flax(gp, {}, backbone_prefix="", flax_backbone_key=""))
    gc = np.asarray(gc)
    assert np.linalg.norm(c.grad.numpy() - gc) <= GRAD_RTOL * np.linalg.norm(gc)


def _ppt_step(kind, condition, s, cfg=None, seed=3):
    """One training forward + semseg criteria of the JAX PPT model (its
    train loss as the JAX step computes it for task "ppt") and of the port's
    ppt_loss, from the same weights; returns both sides' loss, gradients,
    statistics and the variables."""
    from scenesplat_tpu_torch.engines.train_step import ppt_loss
    from scenesplat_tpu_torch.models import build_criteria as tcriteria

    cfg = cfg or _model_cfg(kind)
    _, point, variables = _jax_case(cfg, s, seed)
    ci = cfg["conditions"].index(condition)
    seg = np.where(s["segment"] < NUM_CLASSES[condition], s["segment"], -1)
    ref, ((ref_loss, ref_stats), (ref_grads, _)) = _jitted(cfg)(
        variables, point, jnp.asarray(ci), None, jnp.asarray(seg))
    model = _torch_model(cfg, variables).train()
    tp = _torch_point(s)
    batch = dict(coord=tp.coord, feat=tp.feat, grid_coord=tp.grid_coord, mask=tp.mask,
                 segment=torch.from_numpy(seg), condition=condition)
    got_loss, _ = ppt_loss(model, tcriteria(_criteria_cfg()), batch)
    got_loss.backward()
    return dict(ref=ref, ref_loss=float(ref_loss), ref_grads=ref_grads, ref_stats=ref_stats,
                loss=got_loss.item(), model=model, variables=variables, point=point, ci=ci,
                cfg=cfg)


@pytest.mark.parametrize("condition", CONDITIONS)
@pytest.mark.parametrize("kind", ["v1m1", "v1m2"])
def test_ppt_matches_jax(kind, condition):
    """PPT-v1m1 and PPT-v1m2 with the two order tuples equal: the eval
    logits (padded slots -1e9) and one training loss, the active
    parameters' gradients and BatchNorm statistics."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    s = _scene(2)
    r = _ppt_step(kind, condition, s)
    model, variables = r["model"], r["variables"]
    ref = r["ref"]
    with torch.no_grad():  # a fresh copy: the training forward moved the statistics
        got = _torch_model(r["cfg"], variables).eval()(_torch_point(s), condition=condition).feat
    m = s["mask"]
    k = NUM_CLASSES[condition]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy()[m][:, :k], np.asarray(ref)[m][:, :k], rtol=RTOL,
                               atol=ATOL)
    assert (got.numpy()[..., k:] <= -1e8).all() and (np.asarray(ref)[..., k:] <= -1e8).all()

    np.testing.assert_allclose(r["loss"], r["ref_loss"], rtol=LOSS_RTOL)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    _assert_grads(grads, state_dict_from_flax(r["ref_grads"], {}))
    active = {_norm_condition(n) for n in grads} - {None}
    assert active == {r["ci"]}
    if kind == "v1m2":
        assert set(n for n in grads if n.startswith("seg_heads")) == {
            f"seg_heads.{r['ci']}.weight", f"seg_heads.{r['ci']}.bias"}
    after = state_dict_from_flax(variables["params"], r["ref_stats"])
    state = model.state_dict()
    for key in [k for k in after if k.endswith(("running_mean", "running_var"))
                and _norm_condition(k) == r["ci"]]:
        np.testing.assert_allclose(state[key].numpy(), after[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["v1m1", "v1m2"])
def test_state_dict_from_flax_round_trip(kind):
    """The flax PPT variables load into the port with strict=True, every
    tensor equal to its flax leaf; the names are the reference's."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    cfg = _model_cfg(kind, pdnorm_adaptive=True)
    _, _, variables = _jax_case(cfg, _scene(0))
    model = _torch_model(cfg, variables)
    want = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                constants=variables.get("constants"))
    state = model.state_dict()
    assert sorted(state) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(state[key].numpy(), value, err_msg=key)
    names = set(state)
    assert "backbone.enc.enc0.block0.norm1.0.norm.1.weight" in names
    assert "backbone.embedding.stem.norm.norm.1.running_var" in names
    assert "backbone.dec.dec0.up.proj_skip.1.modulation.1.weight" in names
    assert "embedding_table.weight" in names
    if kind == "v1m1":
        assert {"proj_head.weight", "logit_scale", "class_embedding"} <= names
    else:
        assert {f"seg_heads.{i}.weight" for i in range(2)} <= names


def test_undecoupled_pdnorm_state_dict_names():
    """pdnorm_decouple=False: one shared norm, ``norm.*``."""
    cfg = _model_cfg("v1m2", pdnorm_decouple=False)
    _, _, variables = _jax_case(cfg, _scene(0))
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    model = load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                              variables["batch_stats"], pdnorm_decouple=False)
    assert "backbone.enc.enc0.block0.norm1.0.norm.weight" in model.state_dict()


# ---- the JAX package's four faults ---------------------------------------------

def test_fault1_condition_by_name_not_by_index():
    """With different orders (backbone ScanNet, S3DIS; PPT S3DIS, ScanNet,
    as the published file orders its three differently), JAX hands the PPT
    index of ScanNet (1) to PDNorm, which picks S3DIS's norms: its logits
    equal the port's run with the backbone told "S3DIS". The port names
    ScanNet, and equals JAX when JAX's orders agree."""
    s = _scene(4)
    cfg = _model_cfg("v1m2", ppt_conditions=PPT_ORDER)
    _, point, variables = _jax_case(cfg, s)
    model = _torch_model(cfg, variables).eval()
    tp = _torch_point(s)
    m, k = s["mask"], NUM_CLASSES["ScanNet"]
    ci = PPT_ORDER.index("ScanNet")
    from scenesplat_tpu.models import build_model

    jmodel = build_model(_jax_cfg(cfg))
    jax_logits = np.asarray(jax.jit(lambda v, p: jmodel.apply(v, p, jnp.asarray(ci)).feat)(
        variables, point))
    with torch.no_grad():
        port = model(tp, condition="ScanNet").feat.numpy()
        ctx = model.embedding_table(torch.full((2,), ci))
        s3dis_norms = model.seg_heads[ci](model.backbone(tp, condition="S3DIS", context=ctx).feat)
    np.testing.assert_allclose(s3dis_norms.numpy()[m][:, :k], jax_logits[m][:, :k], rtol=RTOL,
                               atol=ATOL)
    assert np.abs(port[m][:, :k] - jax_logits[m][:, :k]).max() > 1e-2

    # JAX with the PPT order equal to the backbone's: heads and context rows
    # permuted to that order give the port's (the reference's) ScanNet logits
    perm = [PPT_ORDER.index(c) for c in CONDITIONS]
    params = dict(variables["params"])
    params["embedding_table"] = {"embedding": np.asarray(
        params["embedding_table"]["embedding"])[perm]}
    for i, j in enumerate(perm):
        params[f"seg_head{i}"] = variables["params"][f"seg_head{j}"]
    ref = np.asarray(_jitted(_model_cfg("v1m2"))({**variables, "params": params}, point,
                                                 jnp.asarray(CONDITIONS.index("ScanNet")),
                                                 None, jnp.asarray(s["segment"]))[0])
    np.testing.assert_allclose(port[m][:, :k], ref[m][:, :k], rtol=RTOL, atol=ATOL)


def test_fault2_only_the_active_norm_takes_statistics():
    """One training forward on condition S3DIS: JAX moves every condition's
    BatchNorm running statistics, the port only S3DIS's (to JAX's values)."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    s = _scene(5)
    r = _ppt_step("v1m2", "S3DIS", s)
    before = state_dict_from_flax(r["variables"]["params"], r["variables"]["batch_stats"])
    after_jax = state_dict_from_flax(r["variables"]["params"], r["ref_stats"])
    state = r["model"].state_dict()
    stat_keys = [k for k in before if k.endswith("running_mean")]
    moved_jax = {_norm_condition(k) for k in stat_keys
                 if not np.allclose(after_jax[k], before[k])}
    moved_port = {_norm_condition(k) for k in stat_keys
                  if not np.allclose(state[k].numpy(), before[k])}
    assert moved_jax == {0, 1}
    assert moved_port == {CONDITIONS.index("S3DIS")}
    for key in stat_keys + [k.replace("mean", "var") for k in stat_keys]:
        if _norm_condition(key) == CONDITIONS.index("S3DIS"):
            np.testing.assert_allclose(state[key].numpy(), after_jax[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_fault3_add_sets_the_condition_the_step_reads(gs_root):
    """The shipped semseg train pipeline ending in Add(condition=...): the
    port's loader batch carries the name and ppt_loss runs the model on it;
    the JAX batch carries no ``condition_index``, so its step trains every
    batch as condition 0."""
    from scenesplat_tpu import data as jdata
    from scenesplat_tpu_torch import data as tdata
    from scenesplat_tpu_torch.engines.train_step import ppt_loss
    from scenesplat_tpu_torch.models import build_criteria

    transform = _pipelines().semseg_train_transform(GS_KEYS, FEAT_KEYS, point_max=400,
                                                    grid_size=0.05)
    transform[-1] = dict(transform[-1], keys=transform[-1]["keys"] + ("condition",))
    transform.insert(-2, dict(type="Add", keys_dict={"condition": "S3DIS"}))
    cfg = dict(type="ScanNetGSDataset", split="train", data_root=gs_root, transform=transform,
               test_mode=False)
    loader = tdata.Loader(tdata.build_dataset(copy.deepcopy(cfg)), batch_size=2,
                          num_points=512, num_workers=1)
    batch = next(iter(loader))
    assert batch["condition"] == "S3DIS"
    jloader = jdata.Loader(jdata.build_dataset(copy.deepcopy(cfg)), batch_size=2,
                           num_points=512, num_workers=1)
    assert "condition_index" not in next(iter(jloader))

    seen = []
    s = _scene(0)
    s["feat"] = np.zeros((2, 80, 14), np.float32)
    cfg14 = _model_cfg("v1m2", in_channels=14)
    model = _torch_model(cfg14, _jax_case(cfg14, s)[2])
    forward = model.backbone.forward
    model.backbone.forward = lambda *a, **kw: seen.append(kw["condition"]) or forward(*a, **kw)
    from scenesplat_tpu_torch.engines.train_step import batch_to_device

    b = batch_to_device(batch, "cpu")
    b["segment"] = b["segment"].clamp(max=NUM_CLASSES["S3DIS"] - 1)
    loss, _ = ppt_loss(model.train(), build_criteria(_criteria_cfg()), b)
    assert seen == ["S3DIS"] and np.isfinite(loss.item())
    with pytest.raises(ValueError, match="one condition per batch"):
        tdata.collate_padded([dict(coord=np.zeros((3, 3), np.float32), condition=c)
                              for c in ("ScanNet", "S3DIS")], 4)


class _Storage:
    def __init__(self):
        self.scalars = {}

    def put_scalar(self, key, value):
        self.scalars[key] = value


def _ppt_val_cfg(root, name, dataset="ScanNetGSDataset"):
    transform = _pipelines().semseg_val_transform(GS_KEYS, FEAT_KEYS, grid_size=0.05)
    transform[-1] = dict(transform[-1], keys=transform[-1]["keys"] + ("condition",))
    transform.insert(-2, dict(type="Add", keys_dict={"condition": name}))
    return dict(type=dataset, split="val", data_root=root, transform=transform,
                test_mode=False)


def _ppt_test_cfg(root, name, dataset="ScanNetGSDataset"):
    transform, test_cfg = _pipelines().semseg_test_transform_and_cfg(GS_KEYS, FEAT_KEYS)
    test_cfg["voxelize"]["grid_size"] = 0.05
    post = test_cfg["post_transform"]
    post[-1] = dict(post[-1], keys=post[-1]["keys"] + ("condition",))
    post.insert(-2, dict(type="Add", keys_dict={"condition": name}))
    return dict(type=dataset, split="val", data_root=root, transform=transform,
                test_mode=True, test_cfg=test_cfg)


def test_fault4_evaluator_and_tester_score_ppt(gs_root, tmp_path):
    """SemSegEvaluator over validation scenes of two conditions logs each
    condition's mIoU (its scenes scored in its class space) and their mean;
    SemSegTester runs each fragment on its condition. The JAX evaluator and
    tester call the model without a condition and raise."""
    from scenesplat_tpu.engines.hooks.evaluator import SemSegEvaluator as JEval
    from scenesplat_tpu.utils.config import Config as JConfig
    from scenesplat_tpu_torch.engines.hooks.evaluator import SemSegEvaluator
    from scenesplat_tpu_torch.engines.test import SemSegTester
    from scenesplat_tpu_torch.utils.misc import intersection_and_union

    cfg = _model_cfg("v1m2", ppt_conditions=PPT_ORDER, in_channels=14)
    s = _scene(0)
    s["feat"] = np.zeros((2, 80, 14), np.float32)
    jmodel, _, variables = _jax_case(cfg, s)
    model = _torch_model(cfg, variables)
    val = dict(type="ConcatDataset", datasets=[_ppt_val_cfg(gs_root, "ScanNet"),
                                               _ppt_val_cfg(gs_root, "S3DIS")])
    conf = dict(seed=0, model=cfg, data=dict(num_classes=max(NUM_CLASSES.values()), val=val))
    hook = SemSegEvaluator()
    trainer = SimpleNamespace(cfg=Config(copy.deepcopy(conf)), device=torch.device("cpu"),
                              model=model, logger=logging.getLogger("test"), comm_info={},
                              storage=_Storage(), epoch=0)
    hook.trainer = trainer
    hook.before_train()
    hook.after_epoch()
    got = trainer.storage.scalars
    assert set(got) == {"val/ScanNet/mIoU", "val/S3DIS/mIoU", "val/mIoU"}
    assert got["val/mIoU"] == pytest.approx((got["val/ScanNet/mIoU"] + got["val/S3DIS/mIoU"]) / 2)
    # ScanNet's scenes on the ScanNet condition, scored directly
    from scenesplat_tpu_torch.data import build_dataset
    from scenesplat_tpu_torch.data.transforms import seed_transforms
    from scenesplat_tpu_torch.engines.infer import FeatureExtractor

    ds = build_dataset(copy.deepcopy(val["datasets"][0]))
    ext = FeatureExtractor(model.eval(), patch_size=16, device="cpu")
    width = max(NUM_CLASSES.values())
    tot = np.zeros((3, width))
    for i in range(len(ds)):
        seed_transforms((hook._seed(), i))
        sample = ds[i]
        logits = ext(sample)
        assert (logits[:, NUM_CLASSES["ScanNet"]:] <= -1e8).all()
        tot += np.stack(intersection_and_union(logits.argmax(-1).astype(np.int32),
                                               sample["segment"], width, -1))
    seen = tot[2] > 0
    assert got["val/ScanNet/mIoU"] == pytest.approx((tot[0] / np.maximum(tot[1], 1e-10))[seen].mean())

    tester = SemSegTester(num_classes=NUM_CLASSES["S3DIS"], model=model,
                          dataset_cfg=_ppt_test_cfg(gs_root, "S3DIS"), patch_size=16,
                          device="cpu", save_path=str(tmp_path / "s3dis"))
    res = tester.test()
    assert res["iou_per_class"].shape == (NUM_CLASSES["S3DIS"],) and 0 <= res["mIoU"] <= 1
    assert len(glob.glob(str(tmp_path / "s3dis" / "*_pred.npy"))) == 2

    jhook = JEval()
    jhook.trainer = SimpleNamespace(
        cfg=JConfig(copy.deepcopy(dict(conf, model=_jax_cfg(cfg)))), model=jmodel,
        state=SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"]),
        logger=logging.getLogger("test"), comm_info={}, storage=_Storage(), epoch=0)
    jhook.before_train()
    with pytest.raises(TypeError):
        jhook.after_epoch()


# ---- MultiDatasetTrainer, the ppt task, through the entry points -------------------------

def _tiny_ppt_config(root, save_path):
    """The semseg file's trainer settings (criteria, optimizer, schedule,
    param groups) over a PPT-v1m1 of the tiny backbone on two children of
    the same scenes: "ScanNetGS" (loop 2, ScanNet-20 labels) and
    "ScanNetPPGS" (loop 1), each pipeline ending in Add; SemSegEvaluator
    over both conditions and one SemSegTester per condition."""
    cfg = Config.fromfile("configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py")
    cfg.merge_from_options(dict(save_path=save_path, epoch=2, eval_epoch=2, batch_size=2,
                                num_worker=2, mix_prob=0.0))
    conds = ("ScanNetGS", "ScanNetPPGS")
    backbone = dict(_backbone(("ScanNetPPGS", "ScanNetGS")), in_channels=14)
    cfg.model = dict(type="PPT-v1m1", backbone=backbone, backbone_out_channels=8,
                     context_channels=CTX, conditions=conds, class_name=list(NAMES),
                     valid_index=((0, 1, 2, 3, 4, 5), (5, 4, 3, 2, 1, 0)), text_channels=12,
                     criteria=cfg.model.criteria)
    cfg.train = dict(type="MultiDatasetTrainer")
    train = []
    for name, dataset, loop in (("ScanNetGS", "ScanNetGSDataset", 2),
                                ("ScanNetPPGS", "ScanNetPPGSDataset", 1)):
        transform = _pipelines().semseg_train_transform(GS_KEYS, FEAT_KEYS, point_max=400,
                                                        grid_size=0.05)
        transform[-1] = dict(transform[-1], keys=transform[-1]["keys"] + ("condition",))
        transform.insert(-2, dict(type="Add", keys_dict={"condition": name}))
        train.append(dict(type=dataset, split="train", data_root=root, transform=transform,
                          test_mode=False, loop=loop))
    cfg.data = dict(num_classes=6, ignore_index=-1, num_points=512,
                    train=dict(type="ConcatDataset", datasets=train),
                    val=dict(type="ConcatDataset", datasets=[
                        _ppt_val_cfg(root, "ScanNetGS"),
                        _ppt_val_cfg(root, "ScanNetPPGS", "ScanNetPPGSDataset")]),
                    test=[_ppt_test_cfg(root, "ScanNetGS"),
                          _ppt_test_cfg(root, "ScanNetPPGS", "ScanNetPPGSDataset")])
    cfg.test = [dict(type="SemSegTester", num_classes=6, save_path=f"{save_path}/test0"),
                dict(type="SemSegTester", num_classes=6, save_path=f"{save_path}/test1")]
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    cfg.hooks[2]["log_interval"] = 1
    return cfg


def test_multidataset_ppt_train_and_test_entries(gs_root, tmp_path):
    """A tiny PPT-v1m1 trains through ``scenesplat_tpu_torch.train`` with
    MultiDatasetTrainer: the conditions interleave by the children's loop
    ratio (2:1), every step's loss is finite, the evaluator logs each
    condition's mIoU, and the test entry scores both conditions on the
    best checkpoint."""
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.engines import train_step as ts

    cfg = _tiny_ppt_config(gs_root, str(tmp_path / "exp"))
    path = tmp_path / "ppt.py"
    cfg.dump(str(path))
    seen, real = [], ts.TASK_LOSSES["ppt"]

    def recording(model, criteria, batch, *args, **kwargs):
        seen.append(batch["condition"])
        return real(model, criteria, batch, *args, **kwargs)

    ts.TASK_LOSSES["ppt"] = recording
    try:
        assert train_entry.main(["--config-file", str(path), "--device", "cpu"]) == 0
    finally:
        ts.TASK_LOSSES["ppt"] = real
    # 4 scenes, batch 2: an epoch of 4 ScanNetGS batches (loop 2) and 2
    # ScanNetPPGS ones, twice
    assert seen == ["ScanNetGS", "ScanNetGS", "ScanNetPPGS"] * 4
    with open(tmp_path / "exp" / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) >= 12 and np.isfinite(losses).all()
    last = [r for r in records if "val/mIoU" in r][-1]
    assert {"val/ScanNetGS/mIoU", "val/ScanNetPPGS/mIoU"} <= set(last)
    best = tmp_path / "exp" / "model" / "model_best.pth"
    res = test_entry.main(["--config-file", str(path), "--device", "cpu", "--options",
                           f"weight={best}"])
    assert [r["iou_per_class"].shape for r in res] == [(6,), (6,)]
    assert all(0 <= r["mIoU"] <= 1 for r in res)


class _Rows:
    """``n`` tiny samples of one condition, looped ``loop`` times."""

    def __init__(self, name, n, loop):
        self.name, self.n, self.loop = name, n, loop

    def __len__(self):
        return self.n * self.loop

    def __getitem__(self, i):
        return dict(coord=np.full((3, 3), i % self.n, np.float32), condition=self.name)


@pytest.mark.parametrize("sizes,batch", [((7, 5), 2), ((9, 4), 4), ((6, 6), 2)])
def test_multidataset_loader_ranks_stay_in_step(sizes, batch):
    """Per-rank loader rows (each process loads its block of every batch):
    every rank draws the same child at every step, to the end of each
    epoch, whatever the children's sizes; each batch holds one condition."""
    from scenesplat_tpu_torch.data import MultiDatasetLoader

    concat = SimpleNamespace(datasets=[_Rows("A", sizes[0], 2), _Rows("B", sizes[1], 1)],
                             loop=2)
    seqs = []
    for rank in range(2):
        loader = MultiDatasetLoader(concat, batch_size=batch, num_points=4, num_workers=1,
                                    process_index=rank, process_count=2)
        epochs = []
        for epoch in range(2):
            loader.set_epoch(epoch)
            epochs.append([b["condition"] for b in loader])
        seqs.append(epochs)
    assert seqs[0] == seqs[1] and all(len(e) == len(loader) for e in seqs[0])
    assert set(seqs[0][0]) == {"A", "B"}
