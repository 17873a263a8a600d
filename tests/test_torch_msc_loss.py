"""Port parity, Masked Scene Contrast's model: MSC-v1m1 over a tiny
SpUNet-v1m1 against the JAX package, the same cross masks and pairs
injected into both through the replay keys (``view{1,2}_point_mask``,
``match_{scene,i1,i2,valid}``), the weights carried by
``utils/weights.py`` and loaded with strict=True: every loss term and
monitor, every gradient and the BatchNorm statistics after the two
backbone passes. Plus view mixing against a hand-merged batch (port only).
MSC-v1m2 differs only in its contrastive term, held to JAX's in
tests/test_torch_msc.py.

The model: channels (8, 16, 16, 8), layers (1, 1, 1, 1), two rows of two
views of a few hundred points with padding tails (about 80 s on one CPU
worker, nearly all of it the JAX compile of two backbone passes and their
gradient). Tolerances as tests/test_torch_spunet.py: the loss terms rtol
1e-4, each gradient tensor 1e-4 relative L2, the statistics 1e-5
relative."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_spunet import RTOL, STAT_RTOL, _check_grads  # noqa: E402

BACKBONE = dict(type="SpUNet-v1m1", in_channels=6, num_classes=0, base_channels=8,
                channels=(8, 16, 16, 8), layers=(1, 1, 1, 1))
MSC = dict(backbone=BACKBONE, backbone_in_channels=6, backbone_out_channels=8,
           mask_grid_size=0.2, mask_rate=0.4, matching_max_k=4, matching_max_radius=0.05,
           matching_max_pair=96, nce_t=0.4)
PAIRS = 96


def _unique_grid(rng, n, extent=14):
    flat = rng.choice(extent ** 3, n, replace=False)
    return np.stack(np.unravel_index(flat, (extent,) * 3), -1).astype(np.int64)


def two_view_batch(seed, n=(300, 260), slots=320, pairs=PAIRS):
    """Two rows of two views (``n`` points a row, padded to ``slots``) in the
    collate_two_view layout (numpy), with injected masks (about 40 % of
    each view's points) and ``pairs`` pair slots (a quarter invalid) over
    both rows."""
    rng = np.random.default_rng(seed)
    out = {}
    for v in ("view1", "view2"):
        rows = []
        for count in n:
            grid = _unique_grid(rng, count)
            coord = (grid * 0.05 + rng.uniform(0, 0.05, grid.shape)).astype(np.float32)
            pad = slots - count

            def padded(x):
                return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])

            rows.append(dict(
                coord=padded(coord), grid_coord=padded(grid),
                origin_coord=padded((coord + rng.normal(0, 0.01, coord.shape)).astype(
                    np.float32)),
                feat=padded(rng.normal(size=(count, 6)).astype(np.float32)),
                color=padded(rng.uniform(-1, 1, (count, 3)).astype(np.float32)),
                normal=padded(rng.normal(size=(count, 3)).astype(np.float32)),
                mask=np.arange(slots) < count,
                point_mask=(rng.random(slots) < 0.4) & (np.arange(slots) < count)))
        for key in rows[0]:
            out[f"{v}_{key}"] = np.stack([r[key] for r in rows])
    scene = rng.integers(0, 2, pairs)
    count = np.asarray(n)[scene]
    out.update(match_scene=scene, match_i1=rng.integers(0, count),
               match_i2=rng.integers(0, count), match_valid=rng.random(pairs) < 0.75)
    return out


def _fill(shapes, rng):
    from tests.test_torch_spunet import _fill as fill_backbone

    token = shapes["params"].pop("mask_token")
    v = fill_backbone(shapes, rng)
    v["params"]["mask_token"] = rng.normal(0, 0.5, token.shape).astype(token.dtype)
    return v


def _jax_step(cfg, batch, seed=3):
    """The JAX model's numpy variables, its train forward's outputs, the
    gradient of its loss and its updated statistics."""
    from scenesplat_tpu.models import build_model

    model = build_model(copy.deepcopy(cfg))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda b: model.init(rngs, b, train=False), jb)
    shapes = jax.tree_util.tree_map(lambda x: x, dict(shapes))
    shapes["params"] = dict(shapes["params"])
    variables = _fill(shapes, np.random.default_rng(seed))

    def loss(params, v):
        out, upd = model.apply({**v, "params": params}, jb, train=True,
                               mutable=["batch_stats"], rngs={"shuffle": jax.random.PRNGKey(2)})
        return out["loss"], (out, upd["batch_stats"])

    (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"], variables)
    return variables, {k: float(v) for k, v in out.items()}, stats, grads


def _torch_model(cfg, variables):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    return load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                             variables["batch_stats"])


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _check_stats(model, stats):
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    want = state_dict_from_flax({}, stats)
    state = model.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys
    for key in keys:
        w = np.asarray(want[key])
        err = np.abs(state[key].numpy() - w).max() / np.abs(w).max()
        assert err <= STAT_RTOL, f"{key}: {err}"


def test_msc_terms_gradients_and_statistics_match_jax():
    cfg = dict(MSC, type="MSC-v1m1")
    batch = two_view_batch(0)
    variables, want, stats, grads = _jax_step(dict(cfg, knn_tile=64), batch)
    model = _torch_model(cfg, variables).train()
    out = model(torch_batch(batch))
    out["loss"].backward()
    for key, value in want.items():
        assert abs(out[key].item() - value) <= RTOL * max(abs(value), 1e-3), (
            key, out[key].item(), value)
    assert out["pairs"].item() == batch["match_valid"].sum()
    _check_grads(model, grads, backbone_prefix="backbone.", flax_backbone_key="backbone_module")
    assert model.mask_token.grad.abs().max() > 0
    _check_stats(model, stats)


def test_view_mixing_equals_a_hand_merged_batch():
    """view1_mix_prob = view2_mix_prob = 1: each view's two rows run through
    the backbone as one row of both scenes. The losses, gradients and
    statistics equal those of the unmixed model on a batch of that one row
    (the pairs re-indexed into it), where the reference merges offsets."""
    from scenesplat_tpu_torch.models import build_model

    cfg = dict(MSC, type="MSC-v1m1")
    batch = two_view_batch(1)
    slots = batch["view1_mask"].shape[1]
    merged = {k: v.reshape((1, 2 * slots) + v.shape[2:]) for k, v in batch.items()
              if k.startswith("view")}
    merged.update(match_scene=np.zeros_like(batch["match_scene"]),
                  match_i1=batch["match_i1"] + slots * batch["match_scene"],
                  match_i2=batch["match_i2"] + slots * batch["match_scene"],
                  match_valid=batch["match_valid"])
    results = []
    for mix, b in ((1.0, batch), (0.0, merged)):
        model = build_model(dict(cfg, view1_mix_prob=mix, view2_mix_prob=mix)).train()
        out = model(torch_batch(b), generator=torch.Generator().manual_seed(0))
        out["loss"].backward()
        results.append((out, {k: p.grad.clone() for k, p in model.named_parameters()},
                        {k: v.clone() for k, v in model.state_dict().items()
                         if k.endswith("running_var")}))
    (mixed, g_mix, s_mix), (ref, g_ref, s_ref) = results
    assert mixed["view1_mixed"].item() == mixed["view2_mixed"].item() == 1.0
    for key in ("loss", "nce_loss", "color_loss", "normal_loss", "pos_sim", "neg_sim"):
        assert abs(mixed[key].item() - ref[key].item()) <= 1e-5 * abs(ref[key].item()), key
    for key, g in g_ref.items():
        assert torch.linalg.vector_norm(g_mix[key] - g) <= 1e-4 * torch.linalg.vector_norm(g), key
    for key, s in s_ref.items():
        torch.testing.assert_close(s_mix[key], s, rtol=1e-5, atol=1e-6)
