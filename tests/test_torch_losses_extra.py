"""Port parity, the losses that no shipped file uses: ``SmoothCELoss``,
``FocalLoss``, ``BinaryFocalLoss``, ``DiceLoss`` and ``L1Loss``
(``models/losses/misc.py``) and the legacy DINOv2 ones, ``DINOLoss``,
``iBOTPatchLoss`` and ``sinkhorn_knopp_teacher``
(``models/losses/dino_legacy.py``), against the JAX package's on the same
numpy inputs: padded [B, N, C] predictions with a mask and ignored labels.

Tolerances: fp32 values to 1e-5 relative, gradients (of the loss with
respect to the prediction) to 1e-5 of their largest magnitude; the DINO
and iBOT centres after each of 3 updates to 1e-6 relative. A few seconds
alone on one worker.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

RTOL = 1e-5


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= rtol, f"{what}: relative error {err}"


def _inputs(seed=0, b=2, n=24, c=6, binary=False):
    rng = np.random.default_rng(seed)
    pred = rng.normal(0, 2.0, (b, n, c)).astype(np.float32)
    if binary:
        target = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
        target[..., ::2] = np.round(target[..., ::2])
    else:
        target = rng.integers(-1, c, (b, n)).astype(np.int32)  # -1 ignored
    mask = np.ones((b, n), bool)
    mask[1, n - 5:] = False
    return pred, target, mask


CASES = [
    ("SmoothCELoss", dict(), {}),
    ("SmoothCELoss", dict(smoothing_ratio=0.2, loss_weight=0.5, ignore_index=2), {}),
    ("FocalLoss", dict(), {}),
    ("FocalLoss", dict(gamma=1.5, alpha=0.25, reduction="sum", loss_weight=2.0), {}),
    ("FocalLoss", dict(ignore_index=0), dict(no_mask=True)),
    ("BinaryFocalLoss", dict(), dict(binary=True)),
    ("BinaryFocalLoss", dict(gamma=1.0, alpha=0.4, reduction="sum"), dict(binary=True)),
    ("BinaryFocalLoss", dict(logits=False), dict(binary=True, probabilities=True)),
    ("DiceLoss", dict(), {}),
    ("DiceLoss", dict(smooth=0.5, exponent=1.0, loss_weight=3.0, ignore_index=3), {}),
    ("L1Loss", dict(), dict(binary=True)),
    ("L1Loss", dict(reduction="sum", loss_weight=0.3), dict(binary=True)),
    ("L1Loss", dict(), dict(binary=True, no_mask=True)),
]


@pytest.mark.parametrize("name,kw,opts", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_loss_and_gradient_match_jax(name, kw, opts):
    """The loss and its gradient with respect to the prediction. A
    BinaryFocalLoss and L1Loss mask is the points' [B, N] (L1's counts
    points, not channels, as JAX's does) or the elements' [B, N, C]."""
    from scenesplat_tpu.models.losses.builder import LOSSES as JL
    from scenesplat_tpu_torch.models.losses import LOSSES as TL

    pred, target, mask = _inputs(binary=opts.get("binary", False))
    if opts.get("probabilities"):
        pred = 1 / (1 + np.exp(-pred))
    if name == "BinaryFocalLoss":
        mask = np.broadcast_to(mask[..., None], pred.shape).copy()
    if opts.get("no_mask"):
        mask = None
    jloss = JL.build(dict(type=name, **kw))
    tloss = TL.build(dict(type=name, **kw))
    jm = None if mask is None else jnp.asarray(mask)
    want, want_grad = jax.value_and_grad(
        lambda p: jloss(p, jnp.asarray(target), mask=jm))(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    tm = None if mask is None else torch.from_numpy(mask)
    got = tloss(p, torch.from_numpy(target), mask=tm)
    got.backward()
    assert got.dim() == 0 and got.dtype == torch.float32
    _close(got.item(), float(want), f"{name} value")
    _close(p.grad.numpy(), np.asarray(want_grad), f"{name} gradient")


def test_losses_keep_float64():
    """A float64 prediction stays float64 (the card's losses are held to a
    float64 run on the CPU)."""
    from scenesplat_tpu_torch.models.losses import LOSSES

    pred, target, mask = _inputs()
    for name in ("SmoothCELoss", "FocalLoss", "DiceLoss"):
        out = LOSSES.build(dict(type=name))(torch.from_numpy(pred).double(),
                                            torch.from_numpy(target), mask=torch.from_numpy(mask))
        assert out.dtype == torch.float64, name


def _views(seed, rows=4, k=16, views=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.0, (rows, k)).astype(np.float32) for _ in range(views)]


def test_dino_loss_and_centre_match_jax_over_three_updates():
    """Two student and two teacher views, 3 calls: each call's loss and
    student gradients, then the centre (EMA of the teacher views' mean)."""
    from scenesplat_tpu.models.losses.dino_legacy import DINOLoss as JaxDINO
    from scenesplat_tpu_torch.models.losses.dino_legacy import DINOLoss

    jmod, tmod = JaxDINO(out_dim=16, student_temp=0.1, center_momentum=0.8), \
        DINOLoss(16, student_temp=0.1, center_momentum=0.8)
    state = jmod.init(jax.random.PRNGKey(0), _views(0), _views(1), 0.04)
    assert not np.asarray(state["state"]["center"]).any()
    for step in range(3):
        student, teacher = _views(10 + step), _views(20 + step)

        def jloss(s, state=state):
            return jmod.apply(state, s, [jnp.asarray(t) for t in teacher], 0.05,
                              mutable=["state"])

        (want, state), want_grads = jax.value_and_grad(jloss, has_aux=True)(
            [jnp.asarray(s) for s in student])
        s_t = [torch.tensor(s, requires_grad=True) for s in student]
        got = tmod(s_t, [torch.from_numpy(t) for t in teacher], 0.05)
        got.backward()
        _close(got.item(), float(want), f"step {step} loss")
        for g, w in zip(s_t, want_grads):
            _close(g.grad.numpy(), np.asarray(w), f"step {step} student gradient")
        _close(tmod.center.numpy(), np.asarray(state["state"]["center"]),
               f"step {step} centre", 1e-6)
    assert "center" in dict(tmod.named_buffers())
    # no update: the centre stays
    before = tmod.center.clone()
    tmod([torch.from_numpy(s) for s in _views(3)], [torch.from_numpy(t) for t in _views(4)],
         0.05, update_center=False)
    assert torch.equal(tmod.center, before)


def test_ibot_patch_loss_and_centre_match_jax_over_three_updates():
    """Padded [B, N, K] tokens, a sample with no masked token (it adds 0):
    each call's loss and student gradient, then the centre."""
    from scenesplat_tpu.models.losses.dino_legacy import iBOTPatchLoss as JaxIBOT
    from scenesplat_tpu_torch.models.losses.dino_legacy import iBOTPatchLoss

    rng = np.random.default_rng(5)
    masks = rng.uniform(size=(3, 12)) < 0.4
    masks[2] = False
    jmod, tmod = JaxIBOT(patch_out_dim=8), iBOTPatchLoss(8)
    tokens = lambda: rng.normal(0, 1.0, (3, 12, 8)).astype(np.float32)  # noqa: E731
    state = jmod.init(jax.random.PRNGKey(0), tokens(), tokens(), masks, 0.04)
    for step in range(3):
        student, teacher = tokens(), tokens()
        (want, state), want_grad = jax.value_and_grad(
            lambda s, state=state: jmod.apply(state, s, jnp.asarray(teacher), jnp.asarray(masks),
                                              0.06, mutable=["state"]), has_aux=True)(
            jnp.asarray(student))
        s_t = torch.tensor(student, requires_grad=True)
        got = tmod(s_t, torch.from_numpy(teacher), torch.from_numpy(masks), 0.06)
        got.backward()
        _close(got.item(), float(want), f"step {step} loss")
        _close(s_t.grad.numpy(), np.asarray(want_grad), f"step {step} gradient")
        _close(tmod.center.numpy(), np.asarray(state["state"]["center"]),
               f"step {step} centre", 1e-6)


@pytest.mark.parametrize("iterations", [1, 3, 5])
def test_sinkhorn_knopp_matches_jax(iterations):
    """The assignment and the gradient of a weighted sum of it."""
    from scenesplat_tpu.models.losses.dino_legacy import sinkhorn_knopp_teacher as jax_sk
    from scenesplat_tpu_torch.models.losses.dino_legacy import DINOLoss, sinkhorn_knopp_teacher

    rng = np.random.default_rng(iterations)
    t = rng.normal(0, 1.0, (6, 5)).astype(np.float32)
    w = rng.normal(size=(6, 5)).astype(np.float32)
    want = np.asarray(jax_sk(jnp.asarray(t), 0.1, iterations))
    want_grad = np.asarray(jax.grad(
        lambda x: (jax_sk(x, 0.1, iterations) * w).sum())(jnp.asarray(t)))
    x = torch.tensor(t, requires_grad=True)
    got = sinkhorn_knopp_teacher(x, 0.1, iterations)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), want, "assignment")
    _close(x.grad.numpy(), want_grad, "gradient")
    np.testing.assert_allclose(got.detach().sum(1).numpy(), np.ones(6), rtol=1e-5)
    assert DINOLoss.sinkhorn_knopp_teacher is sinkhorn_knopp_teacher
