"""Port parity, Point Prompt Training over PT-v2m3 (every norm a PDNorm of
the batch's condition, adaptive, the condition's context row): PPT-v1m1 on
tests/test_torch_ptv2.py's MINI backbone and cloud against the JAX package,
the weights carried by ``utils/weights.py`` and loaded with strict=True.

One training forward on the ScanNet condition: its 4 classes' logits, the
loss (their product with a fixed cotangent), every gradient (the other
conditions' norms take none in the port and zero in JAX) and the active
condition's BatchNorm statistics (JAX moves every condition's, ROADMAP
Queue 3); the others keep theirs in the port. Then the conditions in
another order in the backbone than in PPT: JAX hands PPT's index on, and
its logits are the port's with the backbone told the condition at that
index of its own order (tests/test_torch_ppt.py's first fault, on PT-v2m3).
About 35 s of JAX compile a case on one CPU worker. Tolerances as
tests/test_torch_ptv2.py, the logits and the loss 1e-4 (PPT_RTOL)."""

import copy
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_ppt import _fill  # noqa: E402
from tests.test_torch_ptv2 import (  # noqa: E402
    MINI,
    assert_loss,
    check_grads,
    check_stats,
    close,
    cloud,
    jax_point,
    jax_run,
    port_model,
    port_run,
    torch_point,
)

CONDITIONS = ("Structured3D", "ScanNet", "S3DIS")
CTX = 16
CLASSES = 4  # ScanNet's
# the logits are exp(logit_scale) ~ 14 times cosines of normalized
# projections: 1.2e-5 of their scale apart (measured), held to 1e-4 as
# tests/test_torch_ppt_spunet.py holds PPT's forwards
PPT_RTOL = 1e-4


def ppt_cfg(backbone_conditions=CONDITIONS):
    return dict(type="PPT-v1m1", backbone=dict(
        MINI, type="PT-v2m3", num_classes=0, conditions=backbone_conditions,
        context_channels=CTX), backbone_out_channels=MINI["dec_channels"][0],
        context_channels=CTX, conditions=CONDITIONS,
        class_name=("wall", "floor", "chair", "table", "sofa"),
        valid_index=((0, 1, 2), (0, 1, 2, 3), (0, 1, 4)), text_channels=12)


def _names():
    return dict(backbone_prefix="backbone.", flax_backbone_key="backbone_module")


def _jax_variables(cfg, s, ci):
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    point = jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, ci), point)
    return model, point, _fill(shapes, np.random.default_rng(2))


def test_ppt_over_ptv2m3_matches_jax(monkeypatch):
    cfg = ppt_cfg()
    s = cloud(3)
    ci = jnp.asarray(CONDITIONS.index("ScanNet"), jnp.int32)
    _, _, variables = _jax_variables(cfg, s, ci)
    import tests.test_torch_ptv2 as ptv2_tests

    monkeypatch.setattr(ptv2_tests, "fill", lambda shapes, rng: variables)
    want = jax_run(cfg, s, dict(condition_index=ci), out=lambda o: o.feat[..., :CLASSES])
    model = port_model(cfg, want["variables"], constants=want["variables"].get("constants"),
                       **_names())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    _, train_fwd, loss = port_run(model, s, want["cot"], out=lambda o: o.feat[..., :CLASSES],
                                  condition="ScanNet")
    close(train_fwd, want["train_fwd"], "train logits", PPT_RTOL)
    assert_loss(loss, want, PPT_RTOL)
    check_grads(model, want["grads"], **_names())
    active = CONDITIONS.index("ScanNet")
    norm = re.compile(r"\.norm\.(\d+)\.running_")
    check_stats(model, want["stats"], **_names(),
                skip=lambda k: norm.search(k) is not None and int(norm.search(k)[1]) != active)
    state = model.state_dict()
    inactive = [k for k in state if norm.search(k) and int(norm.search(k)[1]) != active]
    assert inactive and all(torch.equal(state[k], before[k]) for k in inactive)


def test_condition_by_name_not_by_index():
    """Backbone conditions (S3DIS, ScanNet, Structured3D), PPT's
    (Structured3D, ScanNet, S3DIS): JAX hands ScanNet's PPT index (1) on,
    which is ScanNet in the backbone too; for Structured3D (PPT index 0)
    JAX's backbone runs S3DIS's norms: its logits are the port's with the
    backbone told "S3DIS" and Structured3D's context, and differ from the
    port's Structured3D logits."""
    backbone_order = ("S3DIS", "ScanNet", "Structured3D")
    cfg = ppt_cfg(backbone_order)
    s = cloud(4)
    ci = CONDITIONS.index("Structured3D")
    jmodel, point, variables = _jax_variables(cfg, s, jnp.asarray(ci, jnp.int32))
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, point, jnp.asarray(ci)).feat)(variables))
    model = port_model(cfg, variables, constants=variables.get("constants"), **_names()).eval()
    tp = torch_point(s)
    k = len(cfg["valid_index"][ci])
    m = s["mask"]
    with torch.no_grad():
        port = model(tp, condition="Structured3D").feat.numpy()
        ctx = model.embedding_table(torch.full((2,), ci))
        feat = model.backbone(tp, condition=backbone_order[ci], context=ctx).feat
        emb = model.class_embedding[model.class_ids[ci, :k]]
        f = model.proj_head(feat).float()
        f = f / (f.norm(dim=-1, keepdim=True) + 1e-8)
        e = emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)
        by_index = (model.logit_scale.exp() * (f @ e.T)).numpy()
    close(by_index[m], want[m][:, :k], "JAX logits against the backbone told S3DIS")
    assert np.abs(port[m][:, :k] - want[m][:, :k]).max() > 1e-3
