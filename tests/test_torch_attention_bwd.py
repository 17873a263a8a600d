"""Port parity, the attention backward K2: the choice of its variant, and
torch emulations of both bf16 variants' arithmetic (their tiling, their
delta, their rounding points, the tiles they skip and the order of their
sums) against the JAX package's ``_fwa_bwd`` (the Pallas kernel in
interpret mode) and against autograd through the port's plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from scenesplat_tpu.ops import pallas_attn as jfwa  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402

LOG2E = 1.4426950408889634
# fp32: the emulation, the JAX kernel and autograd through the plain
# version differ only by summation order and exp against exp2
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _stage_signatures():
    """(window, head width) of every attention call of the flagship and the
    shipped backbones, each with both storage types."""
    from scenesplat_tpu_torch.entry import FLAGSHIP_BACKBONE, SHIPPED_INFERENCE_BACKBONE

    sigs = set()
    for cfg in (FLAGSHIP_BACKBONE, SHIPPED_INFERENCE_BACKBONE):
        for side in ("enc", "dec"):
            windows = cfg.get(f"{side}_patch_size", (48,) * len(cfg[f"{side}_channels"]))
            for k, c, h in zip(windows, cfg[f"{side}_channels"], cfg[f"{side}_num_head"]):
                sigs.add((k, c // h))
    return sorted((dt, k, d) for k, d in sigs for dt in ("float32", "bfloat16"))


@pytest.mark.parametrize("dtype,window,head_dim", _stage_signatures())
def test_backward_variant_names_a_kernel_the_source_instantiates(dtype, window, head_dim):
    variant = tfwa.backward_variant(getattr(torch, dtype), window, head_dim)
    source, entry = tfwa.BWD_VARIANTS[variant]
    text = source.read_text()
    assert f'extern "C" int {entry}(' in text
    instance = {"fp32": f"launch_bwd_f32<{head_dim}>",
                "bf16_small": f"launch_small_d<{head_dim}>",
                "bf16_large": f"launch_large<{head_dim}>"}[variant]
    assert instance in text
    if dtype == "float32":
        assert variant == "fp32"
    else:  # the flagship decoder's windows of 48 take the one-pass kernel
        assert variant == ("bf16_small" if window <= 64 else "bf16_large")


@pytest.mark.parametrize("window,variant", [
    (1, "bf16_small"), (16, "bf16_small"), (48, "bf16_small"), (tfwa.BWD_SMALL_MAX, "bf16_small"),
    (tfwa.BWD_SMALL_MAX + 1, "bf16_large"), (127, "bf16_large"), (128, "bf16_large"),
    (1024, "bf16_large"), (4097, "bf16_large")])
def test_backward_variant_threshold(window, variant):
    """Every window the forward accepts has exactly one bf16 backward
    variant; the threshold lies at 48 or above and below 128."""
    assert 48 <= tfwa.BWD_SMALL_MAX < 128
    assert tfwa.backward_variant(torch.bfloat16, window, 48) == variant
    assert tfwa.backward_variant(torch.float32, window, 48) == "fp32"


@pytest.mark.parametrize("dtype,window,head_dim,error", [
    ("float64", 48, 16, TypeError), ("bfloat16", 48, 129, ValueError),
    ("float16", 1024, 0, ValueError), ("float32", 48, 256, ValueError),
    ("bfloat16", 0, 16, ValueError), ("bfloat16", -48, 48, ValueError)])
def test_backward_variant_refuses_what_has_no_kernel(dtype, window, head_dim, error):
    with pytest.raises(error):
        tfwa.backward_variant(getattr(torch, dtype), window, head_dim)


def test_backward_source_and_library():
    """The bf16 backward's two variants are sources of their own, each built
    into a library of its own; each C function refuses the other's
    windows."""
    text = tfwa.SOURCE_BWD.read_text()
    large = tfwa.SOURCE_BWD_LARGE.read_text()
    assert tfwa.SOURCE_BWD.name == "flash_window_attn_bwd.cu"
    assert tfwa.SOURCE_BWD_LARGE.name == "flash_window_attn_bwd_large.cu"
    assert tfwa.LIBRARY_BWD.path().name.startswith("libflash_window_attn_bwd_")
    assert tfwa.LIBRARY_BWD_LARGE.path().name.startswith("libflash_window_attn_bwd_large_")
    assert tfwa.LIBRARY_BWD.source == tfwa.SOURCE_BWD != tfwa.LIBRARY.source
    assert tfwa.LIBRARY_BWD_LARGE.source == tfwa.SOURCE_BWD_LARGE
    for src in (text, large):
        assert f"constexpr int SMALL_MAX = {tfwa.BWD_SMALL_MAX};" in src
    assert "K > SMALL_MAX" in text and "K <= SMALL_MAX" in large
    assert "fwa_bwd_large" not in text and "fwa_bwd_small" not in large
    assert "fwa_bwd_dq_bf16_kernel" not in tfwa.SOURCE.read_text()
    assert set(tfwa.flash_window_attention_bwd.variant_launches) == set(tfwa.BWD_VARIANTS)


def _lse(qkv, valid, patch, heads):
    """The forward's natural-log log-sum-exp of each row's scaled scores over
    the valid keys of its window, [B, N, H] fp32 (-inf in dead windows)."""
    b, n, _, c = qkv.shape
    d, p = c // heads, -(-n // patch)
    pad = p * patch - n
    qkv = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    blk = qkv.view(b, p, patch, 3, heads, d).permute(3, 0, 1, 4, 2, 5)
    s = (blk[0] * d ** -0.5).float() @ blk[1].float().transpose(-1, -2)
    s = torch.where(valid.view(b, p, 1, 1, patch), s, float("-inf"))
    return torch.logsumexp(s, -1).permute(0, 1, 3, 2).reshape(b, p * patch, heads)[:, :n]


def _emulate_small_window_bwd(qkv, valid, dout, lse, patch, heads):
    """The one-pass small-window backward's arithmetic in torch ops. Per
    (batch, window, head): the window's rows padded with zeros to R = 16 *
    ceil(K / 16); for each query m-tile of 16 rows, S = round(q * scale) .
    k^T and dP = dO . v^T over all R keys, P = 2^(S log2(e) - lse log2(e))
    on the valid keys of rows inside the window, delta = rowsum(P * dP) in
    fp32, dS = round(P * (dP - delta)), dQ = scale * round(dS) . k summed
    over key steps of 16; then, per key m-tile, dV = sum over query steps of
    16 of round(P)^T . dO and dK = scale * the same of round(dS)^T . q.
    Windows whose slot 0 is padding get zeros; rows past a ragged window's
    end are never touched. Returns (dqkv, dead windows seen)."""
    b, n, _, c = qkv.shape
    d = c // heads
    scale = d ** -0.5
    rows = 16 * -(-patch // 16)
    dt = qkv.dtype
    dqkv = torch.zeros(b, n, 3, c, dtype=dt)
    dead = 0

    def steps(a, b_, axis_len):  # a @ b_, summed over k-steps of 16 in order
        acc = torch.zeros(a.shape[0], b_.shape[1])
        for k0 in range(0, axis_len, 16):
            acc = acc + a[:, k0:k0 + 16] @ b_[k0:k0 + 16]
        return acc

    for bi in range(b):
        for w0 in range(0, n, patch):
            wlen = min(patch, n - w0)
            if not valid[bi, w0]:
                dead += 1
                continue
            kok = torch.zeros(rows, dtype=torch.bool)
            kok[:wlen] = valid[bi, w0:w0 + wlen]
            rok = torch.arange(rows) < wlen
            for h in range(heads):
                cols = slice(h * d, (h + 1) * d)

                def tile(x):  # [wlen, d] -> [rows, d] fp32, zero rows past the end
                    out = torch.zeros(rows, d)
                    out[:wlen] = x.float()
                    return out

                win = qkv[bi, w0:w0 + wlen]
                q, k, v = tile(win[:, 0, cols]), tile(win[:, 1, cols]), tile(win[:, 2, cols])
                qs = (q.to(dt) * scale).to(dt).float()  # round(q * scale)
                g = tile(dout[bi, w0:w0 + wlen, cols])
                l2 = torch.zeros(rows)
                l2[:wlen] = lse[bi, w0:w0 + wlen, h] * LOG2E
                p_all = torch.zeros(rows, rows)
                ds_all = torch.zeros(rows, rows)
                dq = torch.zeros(rows, d)
                for r0 in range(0, rows, 16):
                    m = slice(r0, r0 + 16)
                    s = steps(qs[m], k.T, d)
                    dp = steps(g[m], v.T, d)
                    ok = rok[m, None] & kok[None, :]
                    p = torch.where(ok, torch.exp2(s * LOG2E - l2[m, None]), 0.0)
                    delta = (p * dp).sum(1, keepdim=True)
                    ds = (p * (dp - delta)).to(dt).float()
                    p_all[m], ds_all[m] = p.to(dt).float(), ds
                    dq[m] = scale * steps(ds, k, rows)
                dv = steps(p_all.T, g, rows)
                dk = scale * steps(ds_all.T, q, rows)
                for i, x in enumerate((dq, dk, dv)):
                    dqkv[bi, w0:w0 + wlen, i, cols] = x[:wlen].to(dt)
    return dqkv, dead


def _jax_bwd(qkv, valid, dout, patch, heads):
    """dqkv of the JAX package's _fwa_bwd (the Pallas kernel, interpret
    mode) on the input padded with invalid slots to whole windows."""
    b, n, _, c = qkv.shape
    pad = -n % patch
    qkv_p = np.concatenate([qkv, np.zeros((b, pad, 3, c), np.float32)], 1)
    valid_p = np.concatenate([valid, np.zeros((b, pad), bool)], 1)
    dout_p = np.concatenate([dout, np.zeros((b, pad, c), np.float32)], 1)
    with pltpu.force_tpu_interpret_mode():
        dqkv, _ = jfwa._fwa_bwd(patch, heads, None, (jnp.asarray(qkv_p), jnp.asarray(valid_p)),
                                jnp.asarray(dout_p))
    return np.asarray(dqkv)[:, :n]


@pytest.mark.parametrize("n,patch,heads,d,stops", [
    (192, 48, 2, 16, (192, 48 + 7)),      # whole windows of 48; then dead windows
    (174, 48, 1, 48, (150, 174)),         # ragged last window of 30; a prefix inside a window
    (174, 48, 2, 32, (48 + 20, 161)),     # dead windows after a partial one; prefix in the ragged one
    (150, 64, 2, 16, (150, 64 + 1)),      # windows of 64 (the threshold), ragged last of 22
    (61, 16, 2, 48, (45, 61)),            # one m-tile a window
])
def test_small_window_bwd_arithmetic_matches_jax_and_plain(n, patch, heads, d, stops):
    rng = np.random.default_rng(n + patch + d)
    qkv = rng.normal(size=(2, n, 3, heads * d)).astype(np.float32)
    dout = rng.normal(size=(2, n, heads * d)).astype(np.float32)
    valid = np.zeros((2, n), bool)
    for row, stop in enumerate(stops):
        valid[row, :stop] = True
    assert tfwa.backward_variant(torch.bfloat16, patch, d) == "bf16_small"
    lse = _lse(_t(qkv), _t(valid), patch, heads)
    got, dead = _emulate_small_window_bwd(_t(qkv), _t(valid), _t(dout), lse, patch, heads)
    got = got.numpy()

    ref = _jax_bwd(qkv, valid, dout, patch, heads)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    x = _t(qkv).requires_grad_(True)
    tfwa.flash_window_attention_plain(x, _t(valid), patch, heads).backward(_t(dout))
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=RTOL, atol=ATOL)
    # windows whose slot 0 is padding: zero gradients on every side
    slot0 = np.pad(valid, ((0, 0), (0, -n % patch))).reshape(2, -1, patch)[:, :, :1]
    dead_rows = np.broadcast_to(~slot0, (2, slot0.shape[1], patch)).reshape(2, -1)[:, :n]
    assert dead == (~slot0).sum() and (dead > 0) == dead_rows.any()
    assert (got[dead_rows] == 0).all() and (ref[dead_rows] == 0).all()
    assert np.abs(ref).max() > 1e-2  # non-trivial gradients


def test_small_window_bwd_bf16_rounding_within_noise_floor():
    """In bf16 the emulation's rounding points give an error against the
    fp32 gradient within 2.5x the plain bf16 version's own (the rule the
    kernel is held to on the card)."""
    n, patch, heads, d = 240, 48, 2, 48
    rng = np.random.default_rng(11)
    qkv = _t(rng.normal(size=(2, n, 3, heads * d)).astype(np.float32)).bfloat16()
    dout = _t(rng.normal(size=(2, n, heads * d)).astype(np.float32)).bfloat16()
    valid = torch.zeros(2, n, dtype=torch.bool)
    valid[0, :200] = True
    valid[1, :n] = True
    lse = _lse(qkv, valid, patch, heads)
    got, _ = _emulate_small_window_bwd(qkv, valid, dout, lse, patch, heads)

    def grad(x, g):
        x = x.detach().clone().requires_grad_(True)
        tfwa.flash_window_attention_plain(x, valid, patch, heads).backward(g)
        return x.grad

    truth = grad(qkv.float(), dout.float())

    def rel(a):
        return ((a.float() - truth).norm() / truth.norm()).item()

    floor = rel(grad(qkv, dout))
    assert floor > 1e-4
    assert rel(got) <= 2.5 * floor, (rel(got), floor)


def _emulate_large_window_bwd(qkv, valid, dout, out, lse, patch, heads, lq=128, lt=64):
    """The two-kernel large-window backward's arithmetic in torch ops. Per
    (batch, window, head), K2a: query tiles of ``lq`` rows; delta =
    rowsum(dO * O) in fp32; the window's key tiles of ``lt`` that hold a
    valid key (the others skipped), 32 keys at a time: S = round(q * scale)
    . k^T, P = 2^(S log2(e) - lse log2(e)) on valid keys, dS = round(P *
    (dP - delta)), dQ += dS . k in steps of 16 keys. K2b: key tiles of
    ``lq`` rows (one without a valid key writes zeros); every query tile of
    ``lt``, 32 queries at a time: P^T, dS^T, dV += round(P^T) . dO and dK +=
    dS^T . q in steps of 16 queries; dQ and dK scaled at the end. Returns
    (dqkv, key tiles K2a skipped, key blocks K2b zeroed)."""
    b, n, _, c = qkv.shape
    d = c // heads
    scale = d ** -0.5
    dt = qkv.dtype
    dqkv = torch.zeros(b, n, 3, c, dtype=dt)
    skipped = zeroed = 0

    def steps(a, b_):  # a @ b_, summed over k-steps of 16 in order
        acc = torch.zeros(a.shape[0], b_.shape[1])
        for k0 in range(0, a.shape[1], 16):
            acc = acc + a[:, k0:k0 + 16] @ b_[k0:k0 + 16]
        return acc

    for bi in range(b):
        for w0 in range(0, n, patch):
            wlen = min(patch, n - w0)
            if not valid[bi, w0]:
                continue
            kok = valid[bi, w0:w0 + wlen]
            live = [t for t in range(0, wlen, lt) if kok[t:t + lt].any()]
            for h in range(heads):
                cols = slice(h * d, (h + 1) * d)
                win = qkv[bi, w0:w0 + wlen].float()
                q, k, v = win[:, 0, cols], win[:, 1, cols], win[:, 2, cols]
                qs = (qkv[bi, w0:w0 + wlen, 0, cols] * scale).float()  # round(q * scale)
                g = dout[bi, w0:w0 + wlen, cols].float()
                delta = (g * out[bi, w0:w0 + wlen, cols].float()).sum(1)
                l2 = lse[bi, w0:w0 + wlen, h] * LOG2E
                dq = torch.zeros(wlen, d)
                for q0 in range(0, wlen, lq):
                    rows = slice(q0, min(q0 + lq, wlen))
                    for t in live:
                        for k0 in range(t, min(t + lt, wlen), 32):
                            keys = slice(k0, min(k0 + 32, wlen))
                            s = torch.where(kok[keys], qs[rows] @ k[keys].T, float("-inf"))
                            p = torch.exp2(s * LOG2E - l2[rows, None])
                            dp = g[rows] @ v[keys].T
                            ds = (p * (dp - delta[rows, None])).to(dt).float()
                            dq[rows] += steps(ds, k[keys])
                dk, dv = torch.zeros(wlen, d), torch.zeros(wlen, d)
                for k0 in range(0, wlen, lq):
                    keys = slice(k0, min(k0 + lq, wlen))
                    if not kok[keys].any():
                        zeroed += 1
                        continue
                    for t0 in range(0, wlen, 32):
                        qr = slice(t0, min(t0 + 32, wlen))
                        st = k[keys] @ qs[qr].T
                        pt = torch.where(kok[keys, None], torch.exp2(st * LOG2E - l2[None, qr]),
                                         0.0)
                        dpt = v[keys] @ g[qr].T
                        dst = (pt * (dpt - delta[None, qr])).to(dt).float()
                        dv[keys] += steps(pt.to(dt).float(), g[qr])
                        dk[keys] += steps(dst, q[qr])
                for i, x in enumerate((scale * dq, scale * dk, dv)):
                    dqkv[bi, w0:w0 + wlen, i, cols] = x.to(dt)
            skipped += len(range(0, wlen, lt)) - len(live)
    return dqkv, skipped, zeroed


@pytest.mark.parametrize("patch,heads,d", [(128, 2, 16), (256, 1, 16), (192, 1, 48),
                                           (65, 2, 32)])
def test_large_window_bwd_arithmetic_matches_jax_and_plain(patch, heads, d):
    """Query and key blocks of 128, tiles of 64 walked 32 rows at a time,
    dead key tiles skipped in K2a and key blocks without a valid key zeroed
    in K2b: equal to the JAX kernel and to autograd through the plain
    version (rtol 1e-5 / atol 1e-6), with a ragged last window and valid
    prefixes that end inside a key tile, on a tile edge, one past it, and
    before windows of padding."""
    n = 3 * patch + patch // 2 + 5
    rng = np.random.default_rng(patch + d + 1)
    qkv = rng.normal(size=(4, n, 3, heads * d)).astype(np.float32)
    dout = rng.normal(size=(4, n, heads * d)).astype(np.float32)
    valid = np.zeros((4, n), bool)
    for row, stop in enumerate((int(0.8 * n), patch + 37, patch + 64, patch + 7)):
        valid[row, :stop] = True
    assert tfwa.backward_variant(torch.bfloat16, patch, d) == "bf16_large"
    out = tfwa.flash_window_attention_plain(_t(qkv), _t(valid), patch, heads)
    lse = _lse(_t(qkv), _t(valid), patch, heads)
    got, skipped, zeroed = _emulate_large_window_bwd(_t(qkv), _t(valid), _t(dout), out, lse,
                                                     patch, heads)
    got = got.numpy()
    assert skipped > 0 and (zeroed > 0) == (patch > 128)
    ref = _jax_bwd(qkv, valid, dout, patch, heads)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    x = _t(qkv).requires_grad_(True)
    tfwa.flash_window_attention_plain(x, _t(valid), patch, heads).backward(_t(dout))
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=RTOL, atol=ATOL)
    slot0 = np.pad(valid, ((0, 0), (0, -n % patch))).reshape(4, -1, patch)[:, :, :1]
    dead_rows = np.broadcast_to(~slot0, (4, slot0.shape[1], patch)).reshape(4, -1)[:, :n]
    assert dead_rows.any() and (got[dead_rows] == 0).all() and (ref[dead_rows] == 0).all()
