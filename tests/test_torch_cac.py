"""Port parity, the Context-Aware Classifier (CAC-v1m1) over a tiny
SpUNet-v1m1 against the JAX package on the same numpy inputs, the weights
carried by ``utils/weights.py`` and loaded with strict=True: the four loss
terms, every gradient and the statistics of one train forward, and the
eval logits (the refined prediction times ``cos_temp``), with no padding;
the state dict against the inverse of ``convert_cac_checkpoint``; the JAX
``feat_norm`` fault (its statistics take the padded slots in, the port's
do not); and a tiny CAC train and test through the entry points.

The model: channels (8, 16, 16, 8), layers (1, 1, 1, 1), two rows of 2,048
points (about 40 s of JAX compile on one CPU worker). Tolerances as
tests/test_torch_spunet.py: forwards and loss terms rtol 1e-4, each
gradient tensor 1e-4 relative L2, statistics 1e-5. ``feat_norm``'s
running variance is the reference's unbiased one in the port (torch's
BatchNorm1d) and the biased one in flax's BatchNorm: it is compared after
that factor n / (n - 1)."""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_semseg import gs_root, one_torch_thread  # noqa: E402,F401
from tests.test_torch_spunet import (  # noqa: E402
    RTOL,
    STAT_RTOL,
    _check_grads,
    _jax_point,
    _scene,
    _torch_point,
)

NUM_CLASSES = 5
BACKBONE = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                channels=(8, 16, 16, 8), layers=(1, 1, 1, 1))
CAC = dict(type="CAC-v1m1", num_classes=NUM_CLASSES, backbone_out_channels=8,
           backbone=BACKBONE,
           criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)])
TERMS = ("loss", "seg_loss", "pre_loss", "pre_self_loss", "kl_loss")


def _fill(shapes, rng):
    """tests/test_torch_spunet.py's values, and the prototype matrix
    ``seg_kernel`` [C, cls] and ``seg_bias`` of CAC's own parameters."""
    from tests.test_torch_spunet import _fill as fill

    params = dict(shapes["params"])
    kernel, bias = params.pop("seg_kernel"), params.pop("seg_bias")
    v = fill(dict(shapes, params=params), rng)
    v["params"]["seg_kernel"] = (rng.normal(size=kernel.shape) / 3).astype(kernel.dtype)
    v["params"]["seg_bias"] = (0.1 * rng.normal(size=bias.shape)).astype(bias.dtype)
    return v


def _segment(s, seed):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, NUM_CLASSES - 1, s["mask"].shape)  # one class absent
    seg[rng.random(seg.shape) < 0.1] = -1
    return seg


def _jax_run(cfg, s, seg, seed=3):
    """The JAX model's numpy variables, its eval logits, train-forward terms,
    gradient of the loss and updated statistics, under one jit."""
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    point, jseg = _jax_point(s), jnp.asarray(seg, jnp.int32)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False), point)
    variables = _fill(shapes, np.random.default_rng(seed))

    def loss(params, v):
        out, upd = model.apply({**v, "params": params}, point, train=True, segment=jseg,
                               mutable=["batch_stats"])
        return out["loss"], (out, upd["batch_stats"])

    @jax.jit
    def run(v):
        logits = model.apply(v, point, train=False).feat
        return logits, jax.value_and_grad(loss, has_aux=True)(v["params"], v)

    logits, ((_, (terms, stats)), grads) = run(variables)
    return variables, np.asarray(logits), {k: float(v) for k, v in terms.items()}, stats, grads


def _torch_model(cfg, variables):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    return load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                             variables["batch_stats"])


def test_cac_terms_logits_gradients_and_statistics_match_jax():
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    s = _scene(4, pad=0)
    seg = _segment(s, 5)
    variables, logits, want, stats, grads = _jax_run(CAC, s, seg)
    model = _torch_model(CAC, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.eval()
    with torch.no_grad():
        got_logits = model(_torch_point(s)).feat.numpy()
    np.testing.assert_allclose(got_logits, logits, rtol=RTOL, atol=RTOL * np.abs(logits).max())
    model.train()
    out = model(_torch_point(s), segment=torch.from_numpy(seg))
    out["loss"].backward()
    for key in TERMS:
        assert abs(out[key].item() - want[key]) <= RTOL * abs(want[key]), key
    _check_grads(model, grads, backbone_prefix="backbone.", flax_backbone_key="backbone_module")
    assert model.seg_head.weight.grad.abs().max() > 0

    ref = state_dict_from_flax({}, stats)
    state = model.state_dict()
    n = int(s["mask"].sum())
    for key, w in ref.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        w = np.asarray(w, np.float64)
        if key == "feat_proj_layer.1.running_var":  # flax: biased; 2 updates of 0.1
            old = before[key].numpy().astype(np.float64)
            w = 0.81 * old + (w - 0.81 * old) * n / (n - 1)
        err = np.abs(state[key].numpy() - w).max() / np.abs(w).max()
        assert err <= STAT_RTOL, f"{key}: {err}"
    assert not torch.equal(state["feat_proj_layer.1.running_mean"],
                           before["feat_proj_layer.1.running_mean"])


def test_cac_state_dict_is_the_inverse_of_convert_cac_checkpoint():
    """The reference's names (``seg_head``, ``proj.{0,2}``, ``apd_proj.{0,2}``,
    ``feat_proj_layer.{0,1,3}``, ``backbone.*``) load strictly into the
    port's CAC and go back through the JAX package's converter to the same
    flax variables."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.utils.ckpt_bridge import convert_cac_checkpoint
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_insseg import assert_same_tree

    s = _scene(0, rows=1)
    shapes = jax.eval_shape(lambda p: jbuild(copy.deepcopy(CAC)).init(
        jax.random.PRNGKey(0), p, train=False), _jax_point(s))
    v = _fill(shapes, np.random.default_rng(1))
    state = state_dict_from_flax(v["params"], v["batch_stats"])
    assert {"proj.0.weight", "apd_proj.2.bias", "feat_proj_layer.1.running_var",
            "seg_head.weight"} <= set(state) and "proj.0.bias" not in state
    model = build_model(copy.deepcopy(CAC))
    model.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in state.items()},
                          strict=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, back_stats, report = convert_cac_checkpoint(state, zeros["params"],
                                                      zeros["batch_stats"])
    assert report["unused_torch_keys"] == []
    assert_same_tree((back, back_stats), (v["params"], v["batch_stats"]))


def test_jax_cac_feat_norm_counts_padding():
    """The same features with a padded tail of 0 or of 500 slots: JAX's
    ``feat_norm`` (a flax BatchNorm over the whole [B, N, C] buffer) moves
    its statistics by the padding; the port's masked one gives the same
    statistics either way, those of the valid points."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu_torch.models import build_model

    rng = np.random.default_rng(6)
    feat = rng.normal(1.0, 2.0, (2, 300, 8)).astype(np.float32)
    jmodel = jbuild(copy.deepcopy(CAC))
    model = build_model(copy.deepcopy(CAC)).train()
    means = {}
    for pad in (0, 500):
        x = np.concatenate([feat, np.zeros((2, pad, 8), np.float32)], 1)
        mask = np.arange(x.shape[1]) < 300
        variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), True,
                                method=jmodel._feat_proj)
        _, upd = jmodel.apply(variables, jnp.asarray(x), True, method=jmodel._feat_proj,
                              mutable=["batch_stats"])
        norm = model.feat_proj_layer._modules["1"]
        norm.running_mean.zero_()
        model.feat_proj_layer(torch.from_numpy(x), torch.from_numpy(mask).expand(2, -1))
        means[pad] = (np.asarray(upd["batch_stats"]["feat_norm"]["mean"]),
                      norm.running_mean.clone().numpy())
    jax_moved = np.abs(means[0][0] - means[500][0]).max()
    assert jax_moved > 0.1 * np.abs(means[0][0]).max()
    np.testing.assert_allclose(means[500][1], means[0][1], rtol=1e-6, atol=1e-7)


# ---- the entry points ---------------------------------------------------------------

def cac_config(cfg, backbone=None, backbone_out_channels=96, num_classes=20):
    """The ScanNet-20 semseg file made a CAC-v1m1 config (Pointcept's
    semseg-cac-v1m1-0-spunet-base.py over the GS data path): CAC-v1m1 over
    SpUNet-v1m1 (its published widths unless ``backbone`` says otherwise;
    14 input channels), the cross-entropy as criteria, JAX's defaults
    (``cos_temp`` 15, every weight 1, ``conf_thresh`` 0), SGD (lr 0.05,
    momentum 0.9, nesterov) with OneCycleLR and no param groups; the
    file's data path, hooks and tester."""
    cfg.model = dict(
        type="CAC-v1m1", num_classes=num_classes, backbone_out_channels=backbone_out_channels,
        backbone=backbone or dict(type="SpUNet-v1m1", in_channels=14, num_classes=0,
                                  channels=(32, 64, 128, 256, 256, 128, 96, 96),
                                  layers=(2, 3, 4, 6, 2, 2, 2, 2)),
        criteria=[dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)],
        cos_temp=15, main_weight=1, pre_weight=1, pre_self_weight=1, kl_weight=1,
        conf_thresh=0)
    cfg.optimizer = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="OneCycleLR", max_lr=0.05, pct_start=0.05, anneal_strategy="cos",
                         div_factor=10.0, final_div_factor=10000.0)
    cfg.param_dicts = None
    return cfg


def test_cac_train_and_test_entry(gs_root, tmp_path):
    """Two tiny epochs of a CAC config through ``python -m
    scenesplat_tpu_torch.train`` with the semseg file's hooks (the
    evaluator scores the refined logits, the saver keeps the best, the
    tester runs after training), every loss term logged, then ``python -m
    scenesplat_tpu_torch.test`` on model_best.pth gives the tester's
    mIoU."""
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry
    from tests.test_torch_semseg import _tiny_semseg

    exp = tmp_path / "exp"
    cfg = _tiny_semseg(gs_root, str(exp))
    tiny = dict(BACKBONE, in_channels=14)
    cfg = cac_config(cfg, backbone=tiny, backbone_out_channels=8, num_classes=cfg.data.num_classes)
    cfg_file = tmp_path / "tiny_cac.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0
    with open(exp / "metrics.json") as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if "kl_loss" in r]
    assert steps and all(np.isfinite([r[k] for k in TERMS]).all() for r in steps)
    assert any("val/mIoU" in r for r in lines)
    best = exp / "model" / "model_best.pth"
    assert best.exists()
    results = test_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                               f"weight={best}", f"test.save_path={tmp_path / 'test'}"])
    assert len(results) == 1 and 0.0 <= results[0]["mIoU"] <= 1.0
