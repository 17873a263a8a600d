"""Port parity, the training ops: gradients of the port's window attention
(autograd through the plain version, the CPU side of the K1/K2 kernels)
against ``jax.grad`` through the JAX package's Pallas flash-window attention
in interpret mode; SubMConv gradients (the port's recomputing backward)
against ``jax.grad`` of the JAX ``subm_conv_apply``; the curve shuffle; and
drop-path and dropout semantics of the train-mode backbone."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from scenesplat_tpu.ops import pallas_attn as jfwa  # noqa: E402
from scenesplat_tpu.ops import serialization as jser  # noqa: E402
from scenesplat_tpu.ops import subm_conv as jconv  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402
from scenesplat_tpu_torch.ops import serialization as tser  # noqa: E402
from scenesplat_tpu_torch.ops import subm_conv as tconv  # noqa: E402
from scenesplat_tpu_torch.ops import window_attention as twa  # noqa: E402
from tests.test_full_model_golden import _make_scene  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _attn_inputs(seed, n, heads, d):
    """qkv, a validity mask with a partial window (row 0) and fully padded
    windows (row 1), and an output gradient that is zero at padding (as the
    model's is: nothing downstream reads padding)."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(2, n, 3, heads * d)).astype(np.float32)
    valid = np.zeros((2, n), bool)
    valid[0, : (3 * n) // 4 + 1] = True
    valid[1, : n // 3] = True
    dout = rng.normal(size=(2, n, heads * d)).astype(np.float32) * valid[..., None]
    return qkv, valid, dout


@pytest.mark.parametrize("n,patch,heads,d", [
    (256, 64, 2, 16),   # whole windows of 64, d = 16 (encoder, dec2)
    (192, 64, 2, 48),   # d = 48 (the flagship dec0 head dim)
    (126, 48, 2, 16),   # ragged last window of 30 slots in windows of 48
    (126, 48, 1, 48),
])
def test_attention_gradients_match_jax_pallas(n, patch, heads, d):
    qkv, valid, dout = _attn_inputs(n + d, n, heads, d)
    pad = -n % patch  # the JAX kernel needs whole windows: pad with invalid slots
    qkv_p = np.concatenate([qkv, np.zeros((2, pad, 3, heads * d), np.float32)], 1)
    valid_p = np.concatenate([valid, np.zeros((2, pad), bool)], 1)
    dout_p = np.concatenate([dout, np.zeros((2, pad, heads * d), np.float32)], 1)

    def jloss(x):
        out = jfwa.flash_window_attention(x, jnp.asarray(valid_p), patch, heads)
        return jnp.sum(out * jnp.asarray(dout_p)), out

    with pltpu.force_tpu_interpret_mode():
        (_, ref_out), ref = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(qkv_p))
    ref, ref_out = np.asarray(ref)[:, :n], np.asarray(ref_out)[:, :n]

    x = _t(qkv).requires_grad_(True)
    out = twa.window_attention(x, _t(valid), patch, heads)  # CPU: plain version
    assert out.grad_fn is not None
    out.backward(_t(dout))
    np.testing.assert_allclose(out.detach().numpy()[valid], ref_out[valid],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(x.grad.numpy(), ref, rtol=RTOL, atol=ATOL)
    # windows whose slot 0 is padding: zero gradient on both sides
    dead = np.zeros_like(valid)
    dead[1, -(-(n // 3) // patch) * patch:] = True
    assert dead.any() and (x.grad.numpy()[dead] == 0).all() and (ref[dead] == 0).all()
    assert np.abs(ref).max() > 1e-2  # non-trivial gradients


def test_attention_plain_gradient_does_not_keep_scores():
    """Recording a graph through the plain version keeps no [K, K] score
    tensor per chunk (torch.utils.checkpoint recomputes it), yet gives the
    gradient of the unchunked computation."""
    qkv, valid, dout = _attn_inputs(5, 128, 2, 16)
    grads = []
    for chunk in (1, 8):
        x = _t(qkv).requires_grad_(True)
        out = tfwa.flash_window_attention_plain(x, _t(valid), 16, 2, patch_chunk=chunk)
        out.backward(_t(dout))
        grads.append(x.grad.numpy())
    np.testing.assert_allclose(grads[0], grads[1], rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        assert tfwa.flash_window_attention(_t(qkv), _t(valid), 16, 2).grad_fn is None


@pytest.mark.parametrize("k,bias,cin,cout", [(3, True, 6, 10), (5, False, 4, 7)])
def test_subm_conv_gradients_match_jax(k, bias, cin, cout):
    """The port's backward (im2col recomputed per chunk, dW = cols^T dY, dX a
    scatter-add over neighbours) against jax.grad of the JAX gather + matmul;
    a small chunk bound forces several chunks."""
    rng = np.random.default_rng(30 + k)
    _, grid, feat = _make_scene(rng, n_parents=96)
    n = len(grid) + 11
    grid_p = np.zeros((1, n, 3), np.int32)
    grid_p[0, : len(grid)] = grid
    mask = np.arange(n)[None] < len(grid)
    x = rng.normal(size=(1, n, cin)).astype(np.float32)
    w = rng.normal(size=(k ** 3, cin, cout)).astype(np.float32)
    bvec = rng.normal(size=(cout,)).astype(np.float32) if bias else None
    dy = rng.normal(size=(1, n, cout)).astype(np.float32) * mask[..., None]

    plan_j = jconv.build_subm_conv_plan(jnp.asarray(grid_p), jnp.asarray(mask),
                                        kernel_size=k, depth=16)

    def jloss(xx, ww, bb):
        return jnp.sum(jconv.subm_conv_apply(xx, plan_j, ww, bb) * jnp.asarray(dy))

    argnums = (0, 1, 2) if bias else (0, 1)
    ref = jax.grad(jloss, argnums=argnums)(
        jnp.asarray(x), jnp.asarray(w), None if bvec is None else jnp.asarray(bvec))

    plan = tconv.build_subm_conv_plan(_t(grid_p), _t(mask), kernel_size=k, depth=16)
    tx, tw = _t(x).requires_grad_(True), _t(w).requires_grad_(True)
    tb = _t(bvec).requires_grad_(True) if bias else None
    old = tconv._COLS_PER_CHUNK
    tconv._COLS_PER_CHUNK = 40 * k ** 3 * cin  # 40 rows a chunk
    try:
        out = tconv.subm_conv_apply(tx, plan, tw, tb)
        out.backward(_t(dy))
    finally:
        tconv._COLS_PER_CHUNK = old
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(ref[1]), rtol=RTOL, atol=ATOL)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(ref[2]), rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(tx.grad.numpy()[~mask]).max() == 0  # nothing reads padding


def test_subm_conv_backward_saves_no_im2col():
    """Autograd keeps the inputs and the neighbour index, never the
    [rows, K3 * Cin] im2col."""
    rng = np.random.default_rng(3)
    _, grid, _ = _make_scene(rng, n_parents=64)
    n = len(grid)
    plan = tconv.build_subm_conv_plan(_t(grid[None]), torch.ones(1, n, dtype=torch.bool),
                                      kernel_size=3)
    x = torch.randn(1, n, 8, requires_grad=True)
    w = torch.randn(27, 8, 4, requires_grad=True)
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tconv.subm_conv_apply(x, plan, w)
    assert sizes and max(sizes) <= 27 * n  # the index; the im2col would be 216 n
    out.sum().backward()
    assert x.grad is not None and w.grad is not None


def test_shuffle_orders_matches_jax_for_one_draw(monkeypatch):
    """For the same permutation draw, the port's shuffle composes with the
    current ``perm`` as the JAX package's does (new perm[i] = perm[draw[i]]),
    twice in a row, and every logical curve then reads the same physical
    order and inverse; the physical curves (curve 0 = "z", read by pooling)
    do not move."""
    orders = ("z", "z-trans", "hilbert", "hilbert-trans")
    rng = np.random.default_rng(4)
    _, grid, _ = _make_scene(rng, n_parents=64)
    mask = np.ones((1, len(grid)), bool)
    ser_t = tser.serialize(_t(grid[None]), _t(mask), orders, 16)
    ser_j = jser.serialize(jnp.asarray(grid[None]), jnp.asarray(mask), orders, 16)
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        draw = torch.randperm(4, generator=_copy(gen)).numpy()  # the draw to come
        ser_t = tser.shuffle_orders(ser_t, gen)
        monkeypatch.setattr(jax.random, "permutation",
                            lambda key, s, d=draw: jnp.asarray(d))
        ser_j = jser.shuffle_orders(ser_j, jax.random.PRNGKey(0))
        assert list(ser_t.perm) == np.asarray(ser_j.perm).tolist()
    assert sorted(ser_t.perm) == [0, 1, 2, 3] and list(ser_t.perm) != [0, 1, 2, 3]
    for i in range(4):
        np.testing.assert_array_equal(ser_t.curve_order(i).numpy(),
                                      np.asarray(ser_j.order[ser_j.perm[i]]))
        np.testing.assert_array_equal(ser_t.curve_inverse(i).numpy(),
                                      np.asarray(ser_j.inverse[ser_j.perm[i]]))
    np.testing.assert_array_equal(ser_t.order[0].numpy(), np.asarray(ser_j.order[0]))


def _copy(gen):
    other = torch.Generator()
    other.set_state(gen.get_state())
    return other


def test_shuffle_orders_draws_from_the_generator():
    """Same seed, same shuffle; over many seeds every permutation of four
    curves appears."""
    ser = tser.serialize(torch.zeros(1, 4, 3, dtype=torch.int64),
                         torch.ones(1, 4, dtype=torch.bool),
                         ("z", "z-trans", "hilbert", "hilbert-trans"), 4)
    perms = set()
    for seed in range(200):
        a = tser.shuffle_orders(ser, torch.Generator().manual_seed(seed)).perm
        b = tser.shuffle_orders(ser, torch.Generator().manual_seed(seed)).perm
        assert a == b
        perms.add(a)
    assert len(perms) == 24


def test_dropout_and_drop_path_semantics():
    """flax nn.Dropout semantics: kept values scaled by 1 / (1 - p); the
    per-point form (drop-path) keeps or drops a whole point, broadcast over
    channels; p = 0 is the identity."""
    from scenesplat_tpu_torch.models.ptv3 import dropout

    x = torch.randn(2, 4000, 8) + 3.0
    gen = torch.Generator().manual_seed(0)
    y = dropout(x, 0.3, gen, per_point=True)
    kept = (y != 0).all(-1)
    dropped = (y == 0).all(-1)
    assert bool((kept | dropped).all())  # whole points only
    torch.testing.assert_close(y[kept], x[kept] / 0.7)
    assert abs(kept.float().mean().item() - 0.7) < 0.03
    z = dropout(x, 0.3, gen)  # element-wise
    assert not bool(((z != 0).all(-1) | (z == 0).all(-1)).all())
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        dropout(x, 0.3, None)


def _tiny_block(drop_path):
    from scenesplat_tpu_torch.models.ptv3 import Block

    torch.manual_seed(0)
    blk = Block(16, 2, 16, mlp_ratio=2, drop_path=drop_path)
    for p in blk.parameters():
        torch.nn.init.normal_(p, std=0.2)
    return blk


def _block_state(n=96):
    from scenesplat_tpu_torch.models.ptv3 import StageState

    rng = np.random.default_rng(1)
    _, grid, _ = _make_scene(rng, n_parents=n // 2)
    grid_t = _t(grid[None]).long()
    mask = torch.ones(1, len(grid), dtype=torch.bool)
    ser = tser.serialize(grid_t, mask, ("z", "z-trans"), 16)
    plan = tconv.build_subm_conv_plan(grid_t, mask, 3, 16)
    return StageState(grid_t.float() * 0.02, grid_t, mask, ser, plan), len(grid)


def test_block_drop_path_two_independent_per_point_draws(monkeypatch):
    """A training Block draws drop-path once for the attention branch and
    once for the MLP branch, per point, independently; eval draws nothing
    and equals the block built without drop-path."""
    from scenesplat_tpu_torch.models import ptv3

    state, n = _block_state()
    feat = torch.randn(1, n, 16)
    calls = []
    real = ptv3.dropout

    def spy(x, p, generator, per_point=False):
        y = real(x, p, generator, per_point)
        if per_point and p > 0:
            calls.append(((y != 0).all(-1), p))
        return y

    monkeypatch.setattr(ptv3, "dropout", spy)
    blk = _tiny_block(0.5).train()
    blk(feat, state, generator=torch.Generator().manual_seed(3))
    assert [p for _, p in calls] == [0.5, 0.5]
    (keep_a, _), (keep_m, _) = calls
    assert 0.3 < keep_a.float().mean().item() < 0.7
    assert not torch.equal(keep_a, keep_m)  # independent draws

    calls.clear()
    ref = _tiny_block(0.0).eval()(feat, state)
    got = _tiny_block(0.5).eval()(feat, state)
    assert calls == []
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_drop_path_rates_follow_the_jax_schedule():
    """Encoder: linspace(0, drop_path, sum(enc_depths)) over the encoder's
    blocks in order; decoder stage s: its slice of a second linspace over
    the decoder's blocks, reversed (scenesplat_tpu/models/ptv3.py)."""
    from scenesplat_tpu_torch.models import build_model

    enc_depths, dec_depths = (2, 1, 3), (2, 3)
    model = build_model(dict(
        type="PT-v3m1", in_channels=6, order=("z", "z-trans"), stride=(2, 2),
        enc_depths=enc_depths, enc_channels=(16, 16, 32), enc_num_head=(1, 1, 2),
        enc_patch_size=(16,) * 3, dec_depths=dec_depths, dec_channels=(16, 16),
        dec_num_head=(1, 1), dec_patch_size=(16,) * 2, drop_path=0.3))
    enc_dp = np.linspace(0, 0.3, sum(enc_depths))
    got = [blk.drop_path for s in range(3) for blk in model.enc[f"enc{s}"].blocks()]
    np.testing.assert_allclose(got, enc_dp, rtol=1e-12)
    dec_dp = np.linspace(0, 0.3, sum(dec_depths))
    for s in range(2):
        want = dec_dp[sum(dec_depths[:s]):sum(dec_depths[:s + 1])][::-1]
        got = [blk.drop_path for blk in model.dec[f"dec{s}"].blocks()]
        np.testing.assert_allclose(got, want, rtol=1e-12)
