"""Port parity, Point Prompt Training over SpUNet-v1m3 (every norm a PDNorm
of the batch's condition, adaptive, the condition's context row): PPT-v1m1
and PPT-v1m2 on tests/test_ppt.py's JAX setup (its backbone and batch: 96
points a row, a padded tail, 5 cm voxels), the weights carried by
``utils/weights.py`` and loaded with strict=True. One training forward a
variant on the ScanNet condition: its logits (the condition's classes;
the padded columns -1e9 on both), the semseg cross-entropy, every
gradient (the other conditions' norms and heads take none in the port and
zero in JAX) and the active condition's BatchNorm statistics (JAX moves
every condition's, ROADMAP Queue 3).

About 30 s of JAX compile a variant on one CPU worker. Tolerances as
tests/test_torch_spunet.py: forwards and losses rtol 1e-4, each gradient
tensor 1e-4 relative L2, statistics 1e-5."""

import copy
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_ppt import _backbone, _batch  # noqa: E402
from tests.test_torch_ppt import _assert_grads, _fill  # noqa: E402
from tests.test_torch_spunet import RTOL, STAT_RTOL  # noqa: E402

CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")
CONDITION = "ScanNet"
CRITERIA = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
MODELS = {
    "v1m1": dict(type="PPT-v1m1", backbone=_backbone(), backbone_out_channels=8,
                 context_channels=16, conditions=CONDITIONS,
                 class_name=("wall", "floor", "chair", "table", "sofa"),
                 valid_index=((0, 1, 2), (0, 1, 2, 3), (0, 1, 4)), text_channels=12),
    "v1m2": dict(type="PPT-v1m2", backbone=_backbone(), backbone_out_channels=8,
                 context_channels=16, conditions=CONDITIONS, num_classes=(5, 4, 3)),
}
CLASSES = 4  # ScanNet's in both


def _bns_condition(key):
    """The condition of a SpUNet-v1m3 norm entry ``...bns.{c}.<leaf>``."""
    m = re.search(r"\.bns\.(\d+)\.", key)
    return None if m is None else int(m.group(1))


@pytest.mark.parametrize("kind", ["v1m1", "v1m2"])
def test_ppt_over_spunet_v1m3_matches_jax(kind):
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria
    from scenesplat_tpu_torch.engines.train_step import ppt_loss
    from scenesplat_tpu_torch.models import PointBatch, build_criteria, build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights, state_dict_from_flax

    cfg = MODELS[kind]
    point = _batch(np.random.default_rng(0))
    rng = np.random.default_rng(1)
    segment = rng.integers(0, CLASSES, point.mask.shape)
    segment[rng.random(segment.shape) < 0.1] = -1
    ci = jnp.asarray(CONDITIONS.index(CONDITION), jnp.int32)
    jmodel = jbuild(copy.deepcopy(cfg))
    shapes = jax.eval_shape(lambda p: jmodel.init(jax.random.PRNGKey(0), p, ci), point)
    variables = _fill(shapes, np.random.default_rng(2))
    crit = jcriteria(CRITERIA)

    def loss(params):
        out, upd = jmodel.apply({**variables, "params": params}, point, ci, train=True,
                                mutable=["batch_stats"])
        return crit(out.feat, jnp.asarray(segment), mask=out.mask), (out.feat,
                                                                     upd["batch_stats"])

    (want, (logits, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    model = load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                              variables["batch_stats"], constants=variables.get("constants"))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    batch = dict(coord=torch.from_numpy(np.asarray(point.coord)),
                 feat=torch.from_numpy(np.asarray(point.feat)),
                 grid_coord=torch.from_numpy(np.asarray(point.grid_coord)).long(),
                 mask=torch.from_numpy(np.asarray(point.mask)),
                 segment=torch.from_numpy(segment), condition=CONDITION)
    got, out = ppt_loss(model, build_criteria(CRITERIA), batch)
    got.backward()
    assert isinstance(out, PointBatch)
    m = np.asarray(point.mask)
    logits = np.asarray(logits)
    np.testing.assert_allclose(out.feat.detach().numpy()[m][:, :CLASSES],
                               logits[m][:, :CLASSES], rtol=RTOL,
                               atol=RTOL * np.abs(logits[m][:, :CLASSES]).max())
    assert (out.feat.detach().numpy()[..., CLASSES:] <= -1e8).all()
    assert (logits[..., CLASSES:] <= -1e8).all()
    assert abs(got.item() - float(want)) <= RTOL * abs(float(want))

    port_grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    _assert_grads(port_grads, state_dict_from_flax(grads, {}))
    active = CONDITIONS.index(CONDITION)
    assert {_bns_condition(n) for n in port_grads} - {None} == {active}
    after = state_dict_from_flax({}, stats)
    state = model.state_dict()
    checked = 0
    for key, value in after.items():
        if not key.endswith(("running_mean", "running_var")):
            continue
        if _bns_condition(key) == active:
            w = np.asarray(value)
            err = np.abs(state[key].numpy() - w).max() / np.abs(w).max()
            assert err <= STAT_RTOL, f"{key}: {err}"
            checked += 1
        else:  # the port's other conditions keep theirs
            assert torch.equal(state[key], before[key]), key
    assert checked
