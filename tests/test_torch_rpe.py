"""Port parity, PTv3's relative-position bias (``enable_rpe``): the port's
``window_attention_rpe`` (plain torch, ops/window_attention.py) against the
JAX package's on the same numpy inputs, forward and gradients; a zero table
against the plain attention; a ragged last window against the same input
padded to a whole window; the tiny PT-v3m1 of tests/test_torch_ppt.py with
``enable_rpe=True`` against JAX, forward and gradients, with the weights
carried by ``utils/weights.py`` (``attn.rpe.rpe_table``).

Tolerances as in tests/test_torch_ppt.py: forwards rtol 1e-4 / atol 2e-4,
losses 1e-5 relative, each gradient tensor 1e-4 relative L2, fp32. The
port's rows without a valid key are zeros (the plain version's rule) where
JAX gives the window's mean value, so rows are compared in windows that
hold a valid key."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu_torch.ops.window_attention import (  # noqa: E402
    rpe_pos_bnd,
    window_attention_rpe,
)
from tests.test_torch_ppt import (  # noqa: E402
    GRAD_RTOL,
    LOSS_RTOL,
    RTOL,
    ATOL,
    TINY,
    _assert_grads,
    _jax_case,
    _jitted,
    _scene,
    _torch_model,
    _torch_point,
)


def _inputs(seed, b, n, k, h, d, extent=12):
    """qkv [b, n, 3, h*d], a valid mask with a partial last window and, in
    the second row, a fully padded window, grid coordinates spread past the
    table's clip, and a table [3 * (2 * pos_bnd + 1), h]."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3, h * d)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[0, n - k // 3:] = False
    if b > 1:
        valid[1, k:2 * k] = False
    grid = rng.integers(0, extent, (b, n, 3)).astype(np.int32)
    table = rng.normal(size=(3 * (2 * rpe_pos_bnd(k) + 1), h)).astype(np.float32)
    return qkv, valid, grid, table


def _kept_rows(valid, k):
    """Rows of windows that hold a valid key."""
    b, n = valid.shape
    p = -(-n // k)
    pad = np.zeros((b, p * k), bool)
    pad[:, :n] = valid
    any_valid = pad.reshape(b, p, k).any(-1)
    return np.repeat(any_valid, k, axis=1)[:, :n]


@pytest.mark.parametrize("k,h,d,n", [(16, 2, 4, 64), (32, 4, 8, 96), (64, 2, 16, 128)])
def test_window_attention_rpe_matches_jax(k, h, d, n):
    """The output and the gradients of a weighted sum w.r.t. qkv and the
    table."""
    from scenesplat_tpu.ops.window_attention import window_attention_rpe as jrpe

    qkv, valid, grid, table = _inputs(k + n, 2, n, k, h, d)
    w = np.random.default_rng(1).normal(size=(2, n, h * d)).astype(np.float32)
    kept = _kept_rows(valid, k)
    w = w * kept[..., None]

    def loss(q, t):
        out = jrpe(q, jnp.asarray(valid), jnp.asarray(grid), t, patch_size=k, num_heads=h)
        return (out * w).sum(), out

    (ref_loss, ref), (gq, gt) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(qkv), jnp.asarray(table))
    q = torch.from_numpy(qkv).requires_grad_(True)
    t = torch.from_numpy(table).requires_grad_(True)
    out = window_attention_rpe(q, torch.from_numpy(valid), torch.from_numpy(grid).long(), t, k,
                               h)
    got_loss = (out * torch.from_numpy(w)).sum()
    got_loss.backward()
    np.testing.assert_allclose(out.detach().numpy()[kept], np.asarray(ref)[kept], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    for got, want in ((q.grad.numpy(), np.asarray(gq)), (t.grad.numpy(), np.asarray(gt))):
        assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)
    assert not out.detach().numpy()[~kept].any()  # rows of fully padded windows


def test_zero_table_equals_plain_attention():
    """A zero table gives the plain attention's output, padded windows and
    a ragged last window included; small chunks give the same result."""
    from scenesplat_tpu_torch.ops.flash_window_attn import flash_window_attention_plain

    k, h, d, n = 32, 4, 8, 3 * 32 + 11
    qkv, valid, grid, table = _inputs(2, 2, n, k, h, d)
    q, v, g = torch.from_numpy(qkv), torch.from_numpy(valid), torch.from_numpy(grid)
    zero = torch.zeros(table.shape)
    got = window_attention_rpe(q, v, g, zero, k, h)
    ref = flash_window_attention_plain(q, v, k, h)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)
    chunked = window_attention_rpe(q, v, g, torch.from_numpy(table), k, h, chunk_elems=k * k)
    whole = window_attention_rpe(q, v, g, torch.from_numpy(table), k, h)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())


def test_ragged_last_window_equals_padded_input():
    """N not a multiple of the window: equal to the same input padded with
    invalid slots to a whole window, on the rows returned."""
    k, h, d, n = 16, 2, 4, 5 * 16 + 7
    qkv, valid, grid, table = _inputs(3, 2, n, k, h, d)
    pad = 16 - 7
    args = [torch.from_numpy(x) for x in (qkv, valid, grid)]
    padded = [torch.cat([x, x.new_zeros((2, pad) + x.shape[2:])], 1) for x in args]
    t = torch.from_numpy(table)
    got = window_attention_rpe(*args, t, k, h)
    ref = window_attention_rpe(*padded, t, k, h)[:, :n]
    assert got.shape == (2, n, h * d)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def test_bf16_rows_follow_the_plain_rounding():
    """bf16 inputs: finite bf16 output within bf16 rounding of the fp32
    result."""
    k, h, d, n = 16, 2, 8, 64
    qkv, valid, grid, table = _inputs(4, 1, n, k, h, d)
    args = (torch.from_numpy(valid), torch.from_numpy(grid), torch.from_numpy(table), k, h)
    got = window_attention_rpe(torch.from_numpy(qkv).bfloat16(), *args)
    ref = window_attention_rpe(torch.from_numpy(qkv), *args)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    kept = torch.from_numpy(_kept_rows(valid, k))
    assert (got.float() - ref)[kept].abs().max().item() < 0.05


def _rpe_cfg():
    return dict(TINY, type="PT-v3m1", enable_rpe=True)


def test_ptv3_enable_rpe_matches_jax():
    """The tiny PT-v3m1 with enable_rpe: the eval forward, and the
    training forward's gradients w.r.t. every parameter (each block's
    ``attn.rpe.rpe_table`` among them)."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    s = _scene(7)
    cfg = _rpe_cfg()
    _, point, variables = _jax_case(cfg, s)
    m = s["mask"]
    w = np.random.default_rng(8).normal(size=(2, 80, 8)).astype(np.float32) * m[..., None]
    ref, ((ref_loss, _), (gp, _)) = _jitted(cfg)(variables, point, jnp.asarray(0), None,
                                                 jnp.asarray(w))
    model = _torch_model(cfg, variables).eval()
    with torch.no_grad():
        got = model(_torch_point(s)).feat
    np.testing.assert_allclose(got.numpy()[m], np.asarray(ref)[m], rtol=RTOL, atol=ATOL)
    model.train()
    loss = (model(_torch_point(s)).feat * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=LOSS_RTOL)
    grads = {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}
    assert sum(k.endswith("attn.rpe.rpe_table") for k in grads) == 3  # one a block
    _assert_grads(grads, state_dict_from_flax(gp, {}, backbone_prefix="",
                                              flax_backbone_key=""))


def test_state_dict_from_flax_round_trip_rpe():
    """The flax RPE backbone loads with strict=True, each table at
    ``attn.rpe.rpe_table``; without enable_rpe no such name exists."""
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    _, _, variables = _jax_case(_rpe_cfg(), _scene(0))
    model = _torch_model(_rpe_cfg(), variables)
    want = state_dict_from_flax(variables["params"], variables["batch_stats"],
                                backbone_prefix="", flax_backbone_key="")
    state = model.state_dict()
    assert sorted(state) == sorted(want)
    tables = [k for k in state if k.endswith("attn.rpe.rpe_table")]
    assert tables == ["enc.enc0.block0.attn.rpe.rpe_table", "enc.enc1.block0.attn.rpe.rpe_table",
                      "dec.dec0.block0.attn.rpe.rpe_table"]
    for key in tables:
        np.testing.assert_array_equal(state[key].numpy(), want[key])
        assert state[key].shape == (3 * (2 * rpe_pos_bnd(16) + 1), 2)
    plain = build_model(dict(TINY, type="PT-v3m1"))
    assert not any("rpe" in k for k in plain.state_dict())
