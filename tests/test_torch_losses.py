"""Port parity, the VL pretraining losses: CosineSimilarity, L2Loss,
AggregatedContrastiveLoss and the summing Criteria against the JAX
package's, on the same numpy inputs, values and gradients with respect to
``pred``. The contrastive loss's Bernoulli split is drawn by JAX and handed
to the port as ``split``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.models.losses.builder import build_criteria as jbuild  # noqa: E402
from scenesplat_tpu_torch.models.losses import build_criteria as tbuild  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
FLAGSHIP_CRITERIA = [
    dict(type="CosineSimilarity", reduction="mean", loss_weight=1.0),
    dict(type="L2Loss", reduction="mean", loss_weight=1.0),
    dict(type="AggregatedContrastiveLoss", temperature=0.2, reduction="mean",
         loss_weight=0.02, schedule="last_75", num_classes=256),
]


def _inputs(seed, b=2, n=700, d=24, classes=9):
    """pred, target, masks and segments of a padded batch; a few classes fall
    under min_samples, a few points carry ignore (-1) or out-of-table
    labels."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(b, n, d)).astype(np.float32)
    emb = rng.normal(size=(classes, d)).astype(np.float32)
    seg = rng.integers(0, classes, (b, n))
    seg[0, :40] = -1
    seg[1, :5] = 300  # >= num_classes: dropped
    seg[:, -60:] = classes + 1  # a class of at most 2 x 60 points, under 110
    target = (emb[np.clip(seg, 0, classes - 1)]
              + 0.3 * rng.normal(size=(b, n, d))).astype(np.float16)
    mask = np.ones((b, n), bool)
    mask[1, n - 90:] = False
    vfm = rng.random((b, n)) > 0.15
    return dict(pred=pred, target=target, segment=seg.astype(np.int32), mask=mask,
                valid_feat_mask=vfm)


def _jax_value_and_grad(cfg, x, key, epoch_progress):
    crit = jbuild(cfg)

    def loss(pred):
        return crit(pred, jnp.asarray(x["target"]).astype(jnp.float32),
                    valid_feat_mask=jnp.asarray(x["valid_feat_mask"]),
                    mask=jnp.asarray(x["mask"]), segment=jnp.asarray(x["segment"]),
                    epoch_progress=epoch_progress, rng=key)

    val, grad = jax.value_and_grad(loss)(jnp.asarray(x["pred"]))
    return float(val), np.asarray(grad)


def _torch_value_and_grad(cfg, x, split, epoch_progress):
    crit = tbuild(cfg)
    pred = torch.from_numpy(x["pred"]).requires_grad_(True)
    val = crit(pred, torch.from_numpy(x["target"]).float(),
               valid_feat_mask=torch.from_numpy(x["valid_feat_mask"]),
               mask=torch.from_numpy(x["mask"]), segment=torch.from_numpy(x["segment"]),
               epoch_progress=epoch_progress, split=split)
    val.backward()
    return float(val.detach()), pred.grad.numpy()


def _split(key, x):
    """The JAX loss's draw: Bernoulli(0.5) over the flattened points."""
    return torch.from_numpy(np.array(
        jax.random.bernoulli(key, 0.5, (x["segment"].size,))))


@pytest.mark.parametrize("cfg", [
    [FLAGSHIP_CRITERIA[0]],
    [FLAGSHIP_CRITERIA[1]],
    [dict(type="CosineSimilarity", reduction="sum", loss_weight=0.5)],
    [dict(type="L2Loss", reduction="sum", loss_weight=2.0)],
], ids=["cos", "l2", "cos_sum", "l2_sum"])
def test_feature_losses_match_jax(cfg):
    x = _inputs(1)
    key = jax.random.PRNGKey(0)
    ref = _jax_value_and_grad(cfg, x, key, None)
    got = _torch_value_and_grad(cfg, x, None, None)
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("reduction,min_samples", [("mean", 100), ("sum", 110),
                                                   ("mean", 10_000)])
def test_contrastive_loss_matches_jax_with_its_split(reduction, min_samples):
    x = _inputs(2)
    cfg = [dict(type="AggregatedContrastiveLoss", temperature=0.2, reduction=reduction,
                loss_weight=0.7, num_classes=16, min_samples=min_samples)]
    key = jax.random.PRNGKey(3)
    ref = _jax_value_and_grad(cfg, x, key, None)
    got = _torch_value_and_grad(cfg, x, _split(key, x), None)
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    if min_samples == 10_000:  # no class qualifies: zero loss, zero gradient
        assert got[0] == 0.0 and not got[1].any()
    else:
        assert got[0] > 0 and np.abs(got[1]).max() > 0


@pytest.mark.parametrize("progress", [None, 0.2, 0.25, 0.26, 1.0])
def test_flagship_criteria_and_last_75_gate_match_jax(progress):
    """The flagship's three losses summed by Criteria; the contrastive term
    counts only once epoch_progress > 0.25 (or without a progress)."""
    x = _inputs(4)
    key = jax.random.PRNGKey(5)
    cfg = [dict(c) for c in FLAGSHIP_CRITERIA]
    cfg[2]["min_samples"] = 50
    ref = _jax_value_and_grad(cfg, x, key, progress)
    got = _torch_value_and_grad(cfg, x, _split(key, x), progress)
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    np.testing.assert_allclose(got[1], ref[1], rtol=RTOL, atol=ATOL)
    without = _torch_value_and_grad(cfg[:2], x, None, progress)[0]
    live = progress is None or progress > 0.25
    assert (got[0] != without) == live


def test_contrastive_split_from_a_generator():
    """Without an injected split the port draws it from the generator: the
    same seed gives the same loss, another seed another one; without either
    it raises."""
    x = _inputs(6)
    cfg = [dict(type="AggregatedContrastiveLoss", num_classes=16, min_samples=20)]
    crit = tbuild(cfg)
    args = (torch.from_numpy(x["pred"]), torch.from_numpy(x["target"]).float())
    kw = dict(segment=torch.from_numpy(x["segment"]), mask=torch.from_numpy(x["mask"]))
    a = crit(*args, generator=torch.Generator().manual_seed(1), **kw)
    b = crit(*args, generator=torch.Generator().manual_seed(1), **kw)
    c = crit(*args, generator=torch.Generator().manual_seed(2), **kw)
    assert a.item() == b.item() and a.item() != c.item()
    with pytest.raises(ValueError):
        crit(*args, **kw)
