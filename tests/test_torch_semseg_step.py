"""Port parity, one semantic-segmentation train step: the tiny 5-stage
DefaultSegmentorV2 of tests/test_torch_semseg.py with the semseg files'
criteria (CE + Lovasz) against the same loss built from the JAX model and
criteria as the JAX package's ``loss_fn`` builds it for task "semseg"
(``scenesplat_tpu/engines/train_step.py``), jitted. The loss, every
parameter gradient (through ``utils/weights.py``'s key mapping) and the
BatchNorm running statistics after the step: loss 1e-5 relative, each
gradient 1e-4 relative L2 (the training test's bar)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria  # noqa: E402
from scenesplat_tpu_torch.models import build_criteria as tcriteria  # noqa: E402
from tests.test_torch_semseg import (  # noqa: E402,F401 (fixtures)
    TINY,
    _criteria_cfg,
    _torch_point,
    _torch_segmentor,
    one_torch_thread,
    seg_case,
)

STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-4
# the bias of a linear layer whose every consumer is a BatchNorm has a zero
# gradient in exact arithmetic (tests/test_torch_train.py)
ZERO_GRAD = 1e-7


def test_semseg_train_step_matches_jax(seg_case):
    """The port's semseg_loss against the JAX model's apply and the file's
    criteria as the JAX loss_fn calls them for task "semseg": the
    serialization (4 curves, shuffled) drawn by JAX outside the model and
    its ``perm`` handed to the port."""
    from scenesplat_tpu_torch.engines.train_step import semseg_loss
    from scenesplat_tpu_torch.ops.serialization import serialize
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    case = seg_case
    criteria = jcriteria(_criteria_cfg())
    k_shuffle, k_drop = jax.random.split(jax.random.PRNGKey(5))
    point = case["point"].serialized(TINY["order"], depth=10, shuffle_rng=k_shuffle)
    seg = jnp.asarray(case["segment"])[None]

    def loss_fn(params):
        out, updates = case["model"].apply(
            {"params": params, "batch_stats": case["stats"]}, point, train=True,
            rngs={"dropout": k_drop, "shuffle": k_shuffle}, mutable=["batch_stats"])
        return criteria(out.feat, seg, mask=out.mask), updates["batch_stats"]

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        case["params"])
    perm = tuple(np.asarray(point.ser.perm).tolist())
    assert perm != (0, 1, 2, 3)  # this key does shuffle the curves

    model = _torch_segmentor(case["params"], case["stats"]).train()
    tp = _torch_point(case)
    ser = dataclasses.replace(serialize(tp.grid_coord, tp.mask, TINY["order"], 10), perm=perm)
    batch = dict(coord=tp.coord, feat=tp.feat, grid_coord=tp.grid_coord, mask=tp.mask, ser=ser,
                 segment=torch.from_numpy(case["segment"]).long()[None])
    loss, out = semseg_loss(model, tcriteria(_criteria_cfg()), batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=STEP_LOSS_RTOL)
    assert all(int(p.n_overflow.max()) == 0 for p in out.plans)

    want = state_dict_from_flax(ref_grads, {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want) and "seg_head.weight" in got
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for name, g in got.items():
        w = want[name]
        if np.linalg.norm(w) < ZERO_GRAD * total:  # zero in exact arithmetic
            assert np.linalg.norm(g) < ZERO_GRAD * total, name
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= STEP_GRAD_RTOL, (name, err)
    after = state_dict_from_flax(case["params"], ref_stats)
    state = model.state_dict()
    for key in [k for k in after if k.endswith(("running_mean", "running_var"))]:
        np.testing.assert_allclose(state[key].numpy(), after[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)
