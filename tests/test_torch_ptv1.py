"""Port parity, Point Transformer V1: PointTransformer-Seg26's eval forward,
train forward, loss, every gradient and running statistics, and the eval
forwards of Cls38 and PartSeg26 (with ``num_shape_classes``, the head
conditioned on each row's shape category) against the JAX package on the
same numpy clouds, the weights carried by
``utils/weights.py:state_dict_from_flax`` and loaded with strict=True.

Two rows of 4,096 slots (one with a 256-slot padding tail) uniform in a
2 m cube: FPS keeps a quarter a stage, so the last stage holds 16 and 15
points, the second fewer than the 16 neighbours (the invalid slots'
path). The FPS and kNN indices are held equal to JAX's exactly. One jit
of the JAX model a case (Seg26's train forward and gradient about 30 s).

Tolerances as tests/test_torch_ptv2.py: eval forwards 1e-5 of the
output's scale, zero-in-exact-arithmetic gradients below 1e-5 of the
whole on both sides; the train forward, the loss and the statistics 1e-4
(TRAIN_RTOL); each gradient tensor 2.5 times a measured noise floor
(GRAD_RTOL, NOISE_FACTOR).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_ptv2 import (  # noqa: E402
    assert_loss,
    check_grads,
    check_stats,
    close,
    cloud,
    fill,
    jax_point,
    jax_run,
    port_model,
    port_run,
    torch_point,
)


# the train forward normalizes by batch moments, down to the last stage's
# 15 and 16 points (16 neighbours each): fp32 sums in another order there
# move the logits by up to 5.3e-5 of their scale and the running
# statistics by up to 1.6e-5 (measured); both are held to 1e-4
TRAIN_RTOL = 1e-4
# Seg26's fp32 gradients at random initialization move by up to 6% (the
# whole gradient by 2%) when only the order of the batch sums changes
# (measured on this cloud, the largest on the position encodings'
# BatchNorms; JAX's differ from the port's by as much, tensor by
# tensor): each gradient tensor is
# held to 2.5 times the largest such change of the port's own step on the
# rows swapped (``swapped_rows_floor``), as the card's fp32 steps of
# SpUNet are; a gradient zero in exact arithmetic reaches 1.7e-6 of the
# whole, so such gradients are held below 1e-5 of it
GRAD_RTOL, NOISE_FACTOR, ZERO_GRAD = 1e-4, 2.5, 1e-5


def _cloud(channels=6):
    return cloud(2, n=4096, pad=256, extent=2.0, channels=channels)


def test_ptv1_seg_matches_jax():
    cfg = dict(type="PointTransformer-Seg26", in_channels=6, num_classes=7)
    s = _cloud()
    want = jax_run(cfg, s, eval_forward=True)
    model = port_model(cfg, want["variables"])
    fwd, train_fwd, loss = port_run(model, s, want["cot"], eval_forward=True)
    close(fwd, want["fwd"], "eval forward")
    close(train_fwd, want["train_fwd"], "train forward", TRAIN_RTOL)
    assert_loss(loss, want, TRAIN_RTOL)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    floor = swapped_rows_floor(cfg, want, grads)
    assert floor < 0.1, floor
    check_grads(model, want["grads"], zero=ZERO_GRAD, rtol=max(GRAD_RTOL, NOISE_FACTOR * floor))
    check_stats(model, want["stats"], rtol=TRAIN_RTOL)


def swapped_rows_floor(cfg, want, grads):
    """The largest relative L2 change of a gradient tensor (above 1e-6 of
    the whole) when the port's step runs on the same rows in the other
    order: every batch sum then adds in another order."""
    s = {k: v[::-1].copy() for k, v in _cloud().items()}
    model = port_model(cfg, want["variables"])
    port_run(model, s, want["cot"][::-1].copy())
    whole = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values()))
    worst = 0.0
    for k, p in model.named_parameters():
        if grads[k].double().norm() > 1e-6 * whole:
            worst = max(worst, float((p.grad - grads[k]).double().norm() / grads[k].double().norm()))
    return worst


def _jax_eval(cfg, s):
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    point = jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p), point)
    variables = fill(shapes, np.random.default_rng(7))
    out = jax.jit(lambda v: model.apply(v, point))(variables)
    return variables, np.asarray(getattr(out, "feat", out))


def test_ptv1_cls_matches_jax():
    """Cls38 (coordinates and 3 feature channels in, 6 in all): eval logits
    [B, classes]; its stages build blocks - 1 bottlenecks."""
    cfg = dict(type="PointTransformer-Cls38", in_channels=6, num_classes=9)
    s = _cloud(channels=3)
    variables, want = _jax_eval(cfg, s)
    model = port_model(cfg, variables).eval()
    assert "enc2.1.linear1.weight" in model.state_dict()
    assert "enc2.2.linear1.weight" not in model.state_dict()
    with torch.no_grad():
        got = model(torch_point(s)).numpy()
    close(got, want, "logits")


def test_ptv1_partseg_matches_jax():
    """PartSeg26 with 4 shape categories, each row its own: eval logits at
    the valid points."""
    cfg = dict(type="PointTransformer-PartSeg26", in_channels=6, num_classes=5,
               num_shape_classes=4)
    s = dict(_cloud(), cls_token=np.array([3, 1], np.int32))
    variables, want = _jax_eval(cfg, s)
    model = port_model(cfg, variables).eval()
    with torch.no_grad():
        got = model(torch_point(s), cls_token=torch.tensor([3, 1])).feat.numpy()
    keep = s["mask"][..., None]
    close(np.where(keep, got, 0), np.where(keep, np.asarray(want), 0), "logits")


def test_fps_and_transition_down_indices_equal_jax():
    """The batched FPS and TransitionDown's kNN (a separate query set of
    the samples) give JAX's indices exactly on the test cloud."""
    from scenesplat_tpu.ops import pointops as jpo
    from scenesplat_tpu_torch.ops import pointops as po

    s = _cloud()
    coord, mask = torch.from_numpy(s["coord"]), torch.from_numpy(s["mask"])
    idx, smask = po.farthest_point_sampling(coord, mask, 256)
    jidx, jsmask = jpo.farthest_point_sampling(jnp.asarray(s["coord"]), jnp.asarray(s["mask"]),
                                               256)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(smask.numpy(), np.asarray(jsmask))
    new = np.take_along_axis(s["coord"], idx.numpy()[..., None], 1)
    qmask = np.arange(256) < (s["mask"].sum(1) // 4)[:, None]
    got, _ = po.knn(coord, mask, 16, query=torch.from_numpy(new),
                    query_mask=torch.from_numpy(qmask))
    want, _ = jpo.knn(jnp.asarray(s["coord"]), jnp.asarray(s["mask"]), 16,
                      query=jnp.asarray(new), query_mask=jnp.asarray(qmask))
    assert np.array_equal(got.numpy(), np.asarray(want))
