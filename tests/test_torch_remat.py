"""Port parity, ``remat_blocks``: PT-v3m1's blocks under activation
checkpointing (the counterpart of the JAX package's ``nn.remat(Block)``).

With it on, a training forward keeps only each block's inputs and runs the
block again in the backward, drawing its dropout and drop-path masks from
the generator set back to the block's entry. The port with it on against
the port with it off (fp32, drop-path 0.3, dropout 0.1, the curves
shuffled): the loss bit-equal, every gradient within 1e-6 of its norm, the
generator left where the run without it leaves it, fewer bytes kept for
the backward; and against the JAX model with ``remat_blocks=True`` at the
tolerances of tests/test_torch_train.py (loss 1e-5, gradients 1e-4)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from tests.test_full_model_golden import MINI, _make_scene  # noqa: E402
from tests.test_torch_train import (  # noqa: E402,F401 (fixture)
    CRITERIA,
    GRAD_RTOL,
    LOSS_RTOL,
    ZERO_GRAD,
    _jax_loss_fn,
    step_case,
)

REMAT_GRAD_RTOL = 1e-6


def _point(seed, n_parents=96):
    from scenesplat_tpu_torch.models import PointBatch

    coord, grid, feat = _make_scene(np.random.default_rng(seed), n_parents=n_parents)
    return PointBatch(coord=torch.from_numpy(coord)[None], feat=torch.from_numpy(feat)[None],
                      grid_coord=torch.from_numpy(grid)[None].long(),
                      mask=torch.ones(1, len(grid), dtype=torch.bool))


def _run(model_cfg, point, seed=3):
    """A train-mode forward and backward of a weighted sum of the output;
    returns the loss, the gradients, the bytes autograd kept for the
    backward and the generator's next draw."""
    from scenesplat_tpu_torch.models import build_model

    model = build_model(model_cfg).train()
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    generator = torch.Generator().manual_seed(seed)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = model(point, generator=generator)
        feat = out.feat.float()
        loss = (feat ** 2 * torch.linspace(0.5, 1.5, feat.shape[-1])).sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}
    return loss.detach(), grads, kept[0], torch.rand(4, generator=generator)


@pytest.mark.parametrize("kind", ["lang", "semseg"])
def test_remat_equals_no_remat(kind):
    backbone = dict(MINI, type="PT-v3m1", stage_capacity=(0.5,), drop_path=0.3, proj_drop=0.1)
    if kind == "lang":
        cfg = dict(type="LangPretrainer", backbone=backbone)
    else:
        cfg = dict(type="DefaultSegmentorV2", num_classes=5,
                   backbone_out_channels=MINI["dec_channels"][0], backbone=backbone)
    point = _point(7)
    off = _run(dict(cfg, backbone=dict(backbone, remat_blocks=False)), point)
    on = _run(dict(cfg, backbone=dict(backbone, remat_blocks=True)), point)
    assert torch.equal(on[0], off[0])  # the forward, bit for bit
    assert sorted(on[1]) == sorted(off[1])
    for key, g in off[1].items():
        err = float((on[1][key] - g).norm() / g.norm().clamp(min=1e-30))
        assert err <= REMAT_GRAD_RTOL, (key, err)
    assert torch.equal(on[3], off[3])  # the recompute left the generator in step
    assert on[2] < 0.7 * off[2], (on[2], off[2])  # the blocks' activations are not kept


def test_remat_is_inert_outside_training_with_gradients():
    from scenesplat_tpu_torch.models import build_model

    backbone = dict(MINI, type="PT-v3m1", stage_capacity=(0.5,))
    point = _point(8)
    outs = []
    for remat in (False, True):
        model = build_model(dict(type="LangPretrainer",
                                 backbone=dict(backbone, remat_blocks=remat))).eval()
        with torch.no_grad():
            outs.append(model(point).feat)
    assert torch.equal(*outs)


def test_remat_matches_jax_remat_blocks(step_case):
    """engines/train_step.py:loss_fn over the JAX model with
    ``remat_blocks=True`` and the port's lang_loss with it on, the same
    weights, curve order and contrastive split."""
    from scenesplat_tpu_torch.engines.train_step import lang_loss
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.ops.serialization import serialize
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_model import _jax_model, _torch_model

    case = dict(step_case, model=_jax_model(MINI, (0.5,), remat_blocks=True))
    ref_loss, ref_grads, _, perm, split = _jax_loss_fn(case, jax.random.PRNGKey(4))
    model = _torch_model(MINI, (0.5,), case["params"], case["stats"], remat_blocks=True).train()
    assert model.backbone.remat_blocks

    def t(x):
        return torch.from_numpy(np.array(x))

    grid, mask = t(case["grid"])[None], t(case["mask"])[None]
    ser = dataclasses.replace(serialize(grid, mask, MINI["order"], 16), perm=tuple(perm))
    batch = dict(coord=t(case["coord"])[None], feat=t(case["feat"])[None], grid_coord=grid,
                 mask=mask, ser=ser, **{k: t(v) for k, v in case["batch"].items()})
    loss, _ = lang_loss(model, build_criteria(CRITERIA), batch, epoch_progress=1.0,
                        split=t(split))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)
    want = state_dict_from_flax(ref_grads, {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    for name, g in got.items():
        w = want[name]
        if np.linalg.norm(w) < ZERO_GRAD * total:
            assert np.linalg.norm(g) < ZERO_GRAD * total, name
            continue
        assert np.linalg.norm(g - w) / np.linalg.norm(w) <= GRAD_RTOL, name
