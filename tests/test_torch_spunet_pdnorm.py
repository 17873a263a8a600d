"""Port parity, SpUNet-v1m3 (every norm a PDNorm of the batch's dataset
condition, with and without the adaptive affine) against the JAX package,
with the helpers and tolerances of tests/test_torch_spunet.py (a file of
its own: each variant's JAX jit compiles for about 30 s)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)

from tests.test_torch_spunet import (  # noqa: E402
    CONDITIONS,
    CTX,
    RTOL,
    _cfg,
    _check_grads,
    _check_stats,
    _jax_run,
    _scene,
    _torch_model,
    _torch_point,
    _torch_run,
)


@pytest.mark.parametrize("variant", ["v1m3", "v1m3_adaptive"])
def test_spunet_v1m3_named_condition_matches_jax(variant):
    """PDNorm by name: the port told "S3DIS" equals JAX given its index in
    the same conditions; only the active condition's statistics move in the
    port (JAX moves every condition's, ROADMAP Queue 3), and they equal
    JAX's active ones; the inactive norms take no gradient."""
    cfg = _cfg(variant)
    s = _scene(5)
    context = np.random.default_rng(9).normal(size=(2, CTX)).astype(np.float32)
    adaptive = cfg["pd_adaptive"]
    variables, fwd, value, stats, grads, cot = _jax_run(
        cfg, s, condition_index=CONDITIONS.index("S3DIS"),
        context=context if adaptive else None, eval_forward=False)
    model = _torch_model(cfg, variables["params"], variables["batch_stats"])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got_fwd, got_value = _torch_run(model, s, cot, False, condition="S3DIS",
                                    context=context if adaptive else None, eval_forward=False)
    np.testing.assert_allclose(got_fwd, fwd, rtol=RTOL, atol=RTOL * np.abs(fwd).max())
    assert abs(got_value - value) <= RTOL * abs(value)
    _check_grads(model, grads)
    active = f".bns.{CONDITIONS.index('S3DIS')}."
    _check_stats(model, stats, skip=lambda key: active not in key)
    for key, v in model.state_dict().items():
        if key.endswith("running_mean") and active not in key:
            assert torch.equal(v, before[key]), f"{key} moved"
    assert all(p.grad is None for k, p in model.named_parameters()
               if ".bns." in k and active not in k)
    assert (model.conv_input.normalization.modulation is not None) == adaptive
    with pytest.raises(ValueError):
        model(_torch_point(s))  # a conditioned SpUNet needs its condition


@pytest.mark.parametrize("adaptive", [False, True])
def test_v1m3_state_dict_is_the_inverse_of_convert_spunet_v1m3_checkpoint(adaptive):
    """The port's v1m3 state dict (reference spconv_unet_v1m3_pdnorm names:
    ``conv_input.{conv,bn}``, ``bns.{c}``, ``modulation.1``, ``proj_conv``)
    loads strictly into the port's model and goes back through the JAX
    package's converter to the same flax variables."""
    import copy

    import jax

    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.utils.ckpt_bridge import convert_spunet_v1m3_checkpoint
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_insseg import assert_same_tree
    from tests.test_torch_spunet import _fill, _jax_point

    cfg = dict(_cfg("v1m3_adaptive" if adaptive else "v1m3"), channels=(8, 16, 24, 12))
    s = _scene(0, rows=1)
    kw = dict(condition_index=jax.numpy.zeros((), "int32"),
              context=jax.numpy.zeros((1, CTX)) if adaptive else None)
    shapes = jax.eval_shape(lambda p: jbuild(copy.deepcopy(cfg)).init(
        jax.random.PRNGKey(0), p, train=False, **kw), _jax_point(s))
    v = _fill(shapes, np.random.default_rng(1))
    state = state_dict_from_flax(v["params"], v["batch_stats"], flax_backbone_key="")
    assert "backbone.conv_input.bn.bns.2.running_var" in state
    assert ("backbone.down.0.bn.modulation.1.weight" in state) == adaptive
    model = build_model(dict(type="DefaultSegmentorV2", num_classes=0,
                             backbone_out_channels=12, backbone=cfg))
    model.load_state_dict({k: torch.from_numpy(np.array(x)) for k, x in state.items()},
                          strict=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, back_stats, report = convert_spunet_v1m3_checkpoint(
        state, zeros["params"], zeros["batch_stats"], num_conditions=len(CONDITIONS))
    assert report["unused_torch_keys"] == []
    assert_same_tree((back, back_stats), (v["params"], v["batch_stats"]))
