"""Port parity, the one-pass forward K1 at windows of at most 64 slots
(``bf16_small``): a torch emulation of its arithmetic (the whole window's
maximum at once, exp2 with log2(e) folded, P normalised before it is rounded,
round(P) . V summed over key steps of 16, lse in the natural log) against
the JAX package's ``_fwa_fwd`` (the Pallas kernel in interpret mode), the
port's plain version and ``jax.nn.logsumexp``; and the order in which its
persistent blocks walk the (window, head) units."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from scenesplat_tpu.ops import pallas_attn as jfwa  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# fp32: the emulation, the JAX kernel and the plain version differ only by
# summation order and exp against exp2 (as in tests/test_torch_attention.py)
RTOL, ATOL = 1e-5, 1e-6
LSE_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _one_pass(q, k, v, kok, scale, dt):
    """One (window, head) of the kernel: q, k, v [R, D] fp32 (rows past the
    window's end zero), kok [R] the valid keys -> (O [R, D] fp32 of storage
    type ``dt`` values, lse [R])."""
    qs = (q.to(dt) * scale).to(dt).float()  # round(q * scale)
    s = qs @ k.T
    s = torch.where(kok[None, :], s, float("-inf"))
    m2 = s.amax(1).clamp(min=-1e30) * LOG2E  # the row maximum over every key at once
    e = torch.exp2(s * LOG2E - m2[:, None])  # an invalid key's -inf gives 0
    total = e.sum(1).clamp(min=1e-30)
    lse = LN2 * (m2 + torch.log2(total))
    p = (e * (1.0 / total)[:, None]).to(dt).float()  # P normalised, then rounded
    o = torch.zeros(q.shape[0], v.shape[1])
    for k0 in range(0, k.shape[0], 16):  # the products' key steps, in order
        o = o + p[:, k0:k0 + 16] @ v[k0:k0 + 16]
    return o.to(dt).float(), lse


def _emulate_small_window_kernel(qkv, valid, patch, heads):
    """The one-pass forward over [B, N, 3, C]: per (batch, window, head) the
    window's rows padded with zeros to R = 16 * ceil(K / 16), keys past a
    ragged window's end invalid, rows past it not written; a window whose
    slot 0 is padding writes zeros and no lse. Returns (out, lse, windows of
    padding seen)."""
    b, n, _, c = qkv.shape
    d = c // heads
    rows = 16 * -(-patch // 16)
    out = torch.zeros(b, n, c, dtype=qkv.dtype)
    lse = torch.zeros(b, n, heads)
    dead = 0
    for bi in range(b):
        for w0 in range(0, n, patch):
            wlen = min(patch, n - w0)
            if not valid[bi, w0]:
                dead += 1
                continue
            kok = torch.zeros(rows, dtype=torch.bool)
            kok[:wlen] = valid[bi, w0:w0 + wlen]
            for h in range(heads):
                cols = slice(h * d, (h + 1) * d)
                win = torch.zeros(rows, 3, d)
                win[:wlen] = qkv[bi, w0:w0 + wlen, :, cols].float()
                o, l_ = _one_pass(win[:, 0], win[:, 1], win[:, 2], kok, d ** -0.5, qkv.dtype)
                out[bi, w0:w0 + wlen, cols] = o[:wlen].to(qkv.dtype)
                lse[bi, w0:w0 + wlen, h] = l_[:wlen]
    return out, lse, dead


def _padded(qkv, valid, patch):
    b, n, _, c = qkv.shape
    pad = -n % patch
    return (np.concatenate([qkv, np.zeros((b, pad, 3, c), np.float32)], 1),
            np.concatenate([valid, np.zeros((b, pad), bool)], 1))


def _jax_fwd(qkv, valid, patch, heads):
    """The JAX package's _fwa_fwd (the Pallas kernel, interpret mode) on the
    input padded with invalid slots to whole windows."""
    n = qkv.shape[1]
    qkv_p, valid_p = _padded(qkv, valid, patch)
    with pltpu.force_tpu_interpret_mode():
        out, _ = jfwa._fwa_fwd(jnp.asarray(qkv_p), jnp.asarray(valid_p), patch, heads, None)
    return np.asarray(out)[:, :n]


def _jax_lse(qkv, valid, patch, heads):
    """jax.nn.logsumexp of the scaled scores over each row's valid keys."""
    b, n, _, c = qkv.shape
    d = c // heads
    qkv_p, valid_p = _padded(qkv, valid, patch)
    blk = jnp.asarray(qkv_p).reshape(b, -1, patch, 3, heads, d)
    scores = jnp.einsum("bpqhd,bpkhd->bphqk", blk[:, :, :, 0] * d ** -0.5, blk[:, :, :, 1])
    scores = jnp.where(jnp.asarray(valid_p).reshape(b, -1, 1, 1, patch), scores, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).transpose(0, 1, 3, 2)
    return want.reshape(b, -1, heads)[:, :n]


@pytest.mark.parametrize("patch", [16, 32, 48, 64])
@pytest.mark.parametrize("d", [16, 32, 48])
def test_small_window_arithmetic_matches_plain_and_jax(patch, d):
    """Windows of 16 to 64 at head widths 16, 32 and 48, a ragged last
    window, valid prefixes that end inside a window, then windows of
    padding, and one that ends inside the ragged window: equal to the plain
    version and to JAX's _fwa_fwd (output rtol 1e-5 / atol 1e-6), the lse
    to jax.nn.logsumexp (1e-5), zeros where slot 0 is padding."""
    heads = 2
    assert tfwa.forward_variant(torch.bfloat16, patch, d) == "bf16_small"
    n = 3 * patch + patch // 2 + 5
    rng = np.random.default_rng(patch + d)
    qkv = rng.normal(size=(3, n, 3, heads * d)).astype(np.float32)
    valid = np.zeros((3, n), bool)
    for row, stop in enumerate((int(0.8 * n), patch + 7, n - 2)):
        valid[row, :stop] = True
    got, lse, dead = _emulate_small_window_kernel(_t(qkv), _t(valid), patch, heads)
    got, lse = got.numpy(), lse.numpy()
    plain = tfwa.flash_window_attention_plain(_t(qkv), _t(valid), patch, heads).numpy()
    np.testing.assert_allclose(got[valid], plain[valid], rtol=RTOL, atol=ATOL)
    ref = _jax_fwd(qkv, valid, patch, heads)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=RTOL, atol=ATOL)
    # windows whose slot 0 is padding: zeros on every side
    slot0 = np.pad(valid, ((0, 0), (0, -n % patch))).reshape(3, -1, patch)[:, :, :1]
    dead_rows = np.broadcast_to(~slot0, (3, slot0.shape[1], patch)).reshape(3, -1)[:, :n]
    assert dead == (~slot0).sum() > 0
    assert (got[dead_rows] == 0).all() and (ref[dead_rows] == 0).all()
    assert (plain[dead_rows] == 0).all()
    want = _jax_lse(qkv, valid, patch, heads)
    np.testing.assert_allclose(lse[~dead_rows], want[~dead_rows], rtol=LSE_TOL, atol=LSE_TOL)


def test_rows_without_valid_keys():
    """A row whose keys are all invalid gives a zero output and the finite
    lse the tiled kernel gives, -1e30 + log(1e-30) = -1e30 in fp32; beside
    it, rows with valid keys are unchanged."""
    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.normal(size=(48, 32)).astype(np.float32)) for _ in range(3))
    o, lse = _one_pass(q, k, v, torch.zeros(48, dtype=torch.bool), 32 ** -0.5, torch.float32)
    assert (o == 0).all()
    assert torch.isfinite(lse).all()
    tiled = np.float32(-1e30) + np.float32(math.log(1e-30))
    np.testing.assert_allclose(lse.numpy(), np.full(48, tiled), rtol=1e-6)
    kok = torch.arange(48) < 20
    o, lse = _one_pass(q, k, v, kok, 32 ** -0.5, torch.float32)
    s = (q * 32 ** -0.5) @ k[:20].T
    np.testing.assert_allclose(o.numpy(), (torch.softmax(s, 1) @ v[:20]).numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, 1).numpy(), rtol=LSE_TOL)


def test_small_window_bf16_rounding_within_noise_floor():
    """In bf16 the emulation's rounding points (round(q * scale), P rounded
    after it is normalised) give an error against the fp32 result within
    2.5x the plain bf16 version's own (the rule the kernel is held to on the
    card)."""
    n, patch, heads, d = 245, 48, 2, 48
    rng = np.random.default_rng(13)
    qkv = _t(rng.normal(size=(2, n, 3, heads * d)).astype(np.float32)).bfloat16()
    valid = torch.zeros(2, n, dtype=torch.bool)
    valid[0, :200] = True
    valid[1, :n] = True
    got, _, _ = _emulate_small_window_kernel(qkv, valid, patch, heads)
    truth = tfwa.flash_window_attention_plain(qkv.float(), valid, patch, heads)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(tfwa.flash_window_attention_plain(qkv, valid, patch, heads))
    assert floor > 1e-4 and rel(got) <= 2.5 * floor, (rel(got), floor)


@pytest.mark.parametrize("order", tuple(tfwa.SMALL_UNIT_ORDERS))
@pytest.mark.parametrize("units,grid,heads", [(131072, 924, 16), (4096, 1320, 16), (96, 7, 2),
                                              (16, 16, 16), (5, 12, 2), (1, 3, 1),
                                              (150, 7, 5)])
def test_unit_order_visits_every_unit_once(order, units, grid, heads):
    """Each order gives every (window, head) unit to exactly one block, for
    grids smaller and larger than the unit count: H in shares that differ
    by at most one unit, each a run of consecutive units (the heads of a
    window in turn); the others in runs of 1 (A), 2, 4 or 8 (A2, A4, A8) or
    ``heads`` (C) consecutive units, dealt to the blocks in turn."""
    chunk = tfwa.small_chunk(order, heads)
    assert chunk == {"H": 0, "A": 1, "A2": 2, "A4": 4, "A8": 8, "C": heads}[order]
    walks = tfwa.small_unit_order(units, grid, chunk)
    assert len(walks) == grid
    flat = sorted(u for walk in walks for u in walk)
    assert flat == list(range(units))
    if order == "H":
        sizes = [len(w) for w in walks]
        assert max(sizes) - min(sizes) <= 1
        assert all(b - a == 1 for w in walks for a, b in zip(w, w[1:]))
        return
    for b, walk in enumerate(walks):
        assert all(u // chunk % grid == b for u in walk)  # run j goes to block j % grid
        assert walk == sorted(walk)


def test_unit_order_mirrors_the_kernel():
    """The shipped order is one of those measured, and the kernel computes
    each walk as small_unit_order does and refuses a run it was not built
    for."""
    assert tfwa.FWD_SMALL_ORDER in tfwa.SMALL_UNIT_ORDERS
    text = tfwa.SOURCE_SMALL.read_text()
    kernel = ("return chunk ? (first + i / chunk * grid) * chunk + i % chunk : first + i;",
              "lo = (long long)b * units / grid, hi = (long long)(b + 1) * units / grid;",
              "if (chunk < 0 || chunk > MAX_CHUNK) return cudaErrorInvalidValue;")
    assert all(line in text for line in kernel)
    with pytest.raises(ValueError):
        tfwa.small_chunk("B", 16)
