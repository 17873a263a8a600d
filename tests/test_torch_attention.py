"""Port parity, window attention: the port's plain masked-exp window
attention (the CPU side of the flash-window kernel) against the JAX
package's ``window_attention_reference`` on the same numpy inputs, the
ragged last window, the CPU dispatch rules, the choice of the forward
kernel's variant, and a torch emulation of the large-window kernel's
arithmetic against both."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.ops import window_attention as jwa  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402
from scenesplat_tpu_torch.ops import window_attention as twa  # noqa: E402


def _t(x):
    return torch.from_numpy(np.asarray(x))


def make_inputs(seed, b, n, heads, d):
    """qkv plus a validity mask with partial and fully padded windows:
    padding sorts last, so each row is a valid prefix."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3, heads * d)).astype(np.float32)
    valid = np.zeros((b, n), bool)
    valid[0, : (n * 3) // 4 + 1] = True  # partial last windows
    if b > 1:
        valid[1, : n // 3] = True  # several fully padded windows
    return qkv, valid


def _jax_ref(qkv, valid, patch, heads, dtype=jnp.float32):
    out = jwa.window_attention_reference(
        jnp.asarray(qkv).astype(dtype), jnp.asarray(valid), patch, heads,
        patch_chunk=3)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("patch,heads,d", [
    (32, 4, 8),    # power-of-two window
    (48, 2, 16),   # the shipped decoder window, not a power of two
    (24, 4, 48),   # the flagship dec0 head dim
    (16, 2, 32),
])
def test_plain_matches_jax_reference(patch, heads, d):
    b, n = 2, 6 * patch
    qkv, valid = make_inputs(patch + d, b, n, heads, d)
    ref = _jax_ref(qkv, valid, patch, heads)
    got = twa.window_attention_reference(
        torch.from_numpy(qkv), torch.from_numpy(valid), patch, heads, patch_chunk=4)
    got = got.numpy()
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5, atol=1e-6)
    # fully padded windows give zeros on both sides
    dead = np.zeros_like(valid)
    dead[1, -(-(n // 3) // patch) * patch:] = True
    assert dead.any()
    assert (got[dead] == 0).all() and (ref[dead] == 0).all()


@pytest.mark.parametrize("n,patch", [(100, 48), (61, 16), (47, 48)])
def test_ragged_last_window(n, patch):
    """N % K != 0: the port at N equals the JAX function on the input padded
    with invalid slots up to a whole window, at every valid row."""
    heads, d = 2, 16
    qkv, valid = make_inputs(n, 2, n, heads, d)
    pad = -n % patch
    qkv_p = np.concatenate([qkv, np.zeros((2, pad, 3, heads * d), np.float32)], 1)
    valid_p = np.concatenate([valid, np.zeros((2, pad), bool)], 1)
    ref = _jax_ref(qkv_p, valid_p, patch, heads)[:, :n]
    got = twa.window_attention(torch.from_numpy(qkv), torch.from_numpy(valid),
                               patch, heads).numpy()
    assert got.shape == (2, n, heads * d)
    np.testing.assert_allclose(got[valid], ref[valid], rtol=1e-5, atol=1e-6)


def test_plain_bf16_matches_jax_bf16():
    """bf16 storage: both sides round q*scale and P to bf16 and accumulate
    in fp32, so they differ only by fp32 summation order and the few bf16
    roundings that order flips: within one bf16 step (2**-8) of the value."""
    patch, heads, d = 32, 4, 16
    qkv, valid = make_inputs(7, 2, 4 * patch, heads, d)
    ref = _jax_ref(qkv, valid, patch, heads, dtype=jnp.bfloat16)
    got = twa.window_attention_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(valid), patch, heads)
    np.testing.assert_allclose(got.float().numpy()[valid], ref[valid],
                               rtol=2 ** -7, atol=2 ** -8)


def test_dispatch_on_cpu():
    qkv, valid = make_inputs(3, 1, 64, 2, 8)
    q, v = torch.from_numpy(qkv), torch.from_numpy(valid)
    before = tfwa.flash_window_attention.launches
    plain = twa.window_attention(q, v, 16, 2, use_kernel=False)
    # the wrapper takes the plain version for CPU tensors, without a launch
    np.testing.assert_array_equal(twa.window_attention(q, v, 16, 2).numpy(),
                                  plain.numpy())
    np.testing.assert_array_equal(tfwa.flash_window_attention(q, v, 16, 2).numpy(),
                                  plain.numpy())
    assert tfwa.flash_window_attention.launches == before
    with pytest.raises(ValueError):
        twa.window_attention(q, v, 16, 2, use_kernel=True)


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
def test_forward_variant_names_a_kernel_the_source_instantiates(dtype, window, head_dim):
    variant = tfwa.forward_variant(getattr(torch, dtype), window, head_dim)
    source, entry = tfwa.VARIANTS[variant]
    text = source.read_text()
    assert f'extern "C" int {entry}(' in text
    instance = {"fp32": f"launch_f32<{head_dim}>",
                "bf16_small": f"launch_d<{head_dim}>",
                "bf16_tiled": f"launch_tiled<{head_dim}>",
                "bf16_large": f"launch<{head_dim}>"}[variant]
    assert instance in text
    if dtype == "float32":
        assert variant == "fp32"
    elif window <= 64:  # the decoder's windows of 48: the one-pass kernel
        assert variant == "bf16_small"
    else:  # windows of 128 to 4096 slots are bound by operations
        assert variant == ("bf16_large" if 128 <= window <= 4096 else "bf16_tiled")


@pytest.mark.parametrize("dtype,window,head_dim,error", [
    ("float64", 1024, 16, TypeError), ("bfloat16", 1024, 129, ValueError),
    ("float32", 48, 0, ValueError), ("bfloat16", 0, 16, ValueError),
    ("bfloat16", 48, 256, ValueError), ("float16", 64, 129, ValueError),
    ("float64", 48, 48, TypeError), ("bfloat16", -48, 48, ValueError)])
def test_forward_variant_refuses_what_has_no_kernel(dtype, window, head_dim, error):
    with pytest.raises(error):
        tfwa.forward_variant(getattr(torch, dtype), window, head_dim)


def test_forward_variant_threshold():
    """Every bf16 window has exactly one forward: the one-pass kernel up to
    64 slots, the large-window one from 128 to 4096, the tiled one between
    and above; fp32 has one kernel at every window."""
    windows = (1, 16, 48, 64, 65, 127, 128, 4096, 4097)
    picks = [tfwa.forward_variant(torch.bfloat16, k, 48) for k in windows]
    assert picks == ["bf16_small"] * 4 + ["bf16_tiled"] * 2 + ["bf16_large"] * 2 + [
        "bf16_tiled"]
    assert tfwa.FWD_SMALL_MAX == 64 == tfwa.BWD_SMALL_MAX
    assert {tfwa.forward_variant(torch.float32, k, 48) for k in windows} == {"fp32"}
    assert set(tfwa.VARIANTS) == set(tfwa.flash_window_attention.variant_launches)
    assert "fwa_fwd_large" in tfwa.SOURCE_LARGE.read_text()
    assert tfwa.LIBRARY_LARGE.path().name.startswith("libflash_window_attn_fwd_")


LOG2E = 1.4426950408889634


def _emulate_large_window_kernel(qkv, valid, patch, heads, mq=128, mk=64):
    """The large-window forward's arithmetic in torch ops: per (batch,
    window, head) query tiles of ``mq`` rows walk the window's live key
    tiles of ``mk`` (tiles without a valid key are skipped) with an online
    softmax in the exp2 domain, P rounded to the storage type before P . V,
    the running maximum kept in the natural domain, lse = max + log(sum).
    Returns (out, lse, tiles skipped)."""
    b, n, _, c = qkv.shape
    d = c // heads
    scale = d ** -0.5
    out = torch.zeros(b, n, c, dtype=qkv.dtype)
    lse = torch.zeros(b, n, heads)
    skipped = 0
    for bi in range(b):
        for w0 in range(0, n, patch):
            wlen = min(patch, n - w0)
            vw = valid[bi, w0:w0 + wlen]
            if not vw[0]:
                continue  # a window of padding writes zeros
            tiles = range(0, wlen, mk)
            live = [t for t in tiles if vw[t:t + mk].any()]
            skipped += len(tiles) - len(live)
            for h in range(heads):
                cols = slice(h * d, (h + 1) * d)
                win = qkv[bi, w0:w0 + wlen]
                q = (win[:, 0, cols] * scale).float()  # rounds to the storage type
                k, v = win[:, 1, cols].float(), win[:, 2, cols].float()
                for q0 in range(0, wlen, mq):
                    rows = slice(q0, min(q0 + mq, wlen))
                    m = torch.full((rows.stop - q0,), -1e30)
                    l = torch.zeros_like(m)
                    o = torch.zeros(rows.stop - q0, d)
                    for t in live:
                        s = q[rows] @ k[t:t + mk].T
                        s = torch.where(vw[t:t + mk], s, float("-inf"))
                        m_new = torch.maximum(m, s.amax(1))
                        corr = torch.exp2((m - m_new) * LOG2E)
                        p = torch.exp2(s * LOG2E - (m_new * LOG2E)[:, None])
                        l = l * corr + p.sum(1)
                        o = o * corr[:, None] + p.to(qkv.dtype).float() @ v[t:t + mk]
                        m = m_new
                    l = l.clamp(min=1e-30)
                    out[bi, w0 + q0:w0 + rows.stop, cols] = (o / l[:, None]).to(qkv.dtype)
                    lse[bi, w0 + q0:w0 + rows.stop, h] = m + torch.log(l)
    return out, lse, skipped


@pytest.mark.parametrize("patch,heads,d", [(128, 2, 16), (256, 2, 16), (128, 1, 48),
                                           (256, 1, 32)])
def test_large_window_arithmetic_matches_plain_and_jax(patch, heads, d):
    """Query tiles of 128, key tiles of 64 with an exp2 online softmax and
    dead tiles skipped: equal to the plain version and to the JAX reference
    (output rtol 1e-5 / atol 1e-6, log-sum-exp 1e-5) with a ragged last
    window and valid prefixes that end inside a key tile, on a tile edge,
    one past it, and before a dead window."""
    n = 3 * patch + patch // 2 + 5
    rng = np.random.default_rng(patch + d)
    qkv = rng.normal(size=(4, n, 3, heads * d)).astype(np.float32)
    valid = np.zeros((4, n), bool)
    for row, stop in enumerate((int(0.8 * n), patch + 37, patch + 64, patch + 65)):
        valid[row, :stop] = True
    got, lse, skipped = _emulate_large_window_kernel(_t(qkv), _t(valid), patch, heads)
    assert skipped > 0  # dead key tiles inside live windows were left out
    plain = tfwa.flash_window_attention_plain(_t(qkv), _t(valid), patch, heads)
    np.testing.assert_allclose(got.numpy()[valid], plain.numpy()[valid], rtol=1e-5, atol=1e-6)
    pad = -n % patch
    qkv_p = np.concatenate([qkv, np.zeros((4, pad, 3, heads * d), np.float32)], 1)
    valid_p = np.concatenate([valid, np.zeros((4, pad), bool)], 1)
    ref = _jax_ref(qkv_p, valid_p, patch, heads)[:, :n]
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], rtol=1e-5, atol=1e-6)
    # windows whose slot 0 is padding: zeros, as the plain version and JAX give
    slot0 = valid_p.reshape(4, -1, patch)[:, :, :1]
    dead = np.broadcast_to(~slot0, (4, slot0.shape[1], patch)).reshape(4, -1)[:, :n]
    assert dead.any() and (got.numpy()[dead] == 0).all() and (ref[dead] == 0).all()
    # the natural-log log-sum-exp of the scaled scores over the valid keys
    blk = jnp.asarray(qkv_p).reshape(4, -1, patch, 3, heads, d)
    scores = jnp.einsum("bpqhd,bpkhd->bphqk", blk[:, :, :, 0] * d ** -0.5, blk[:, :, :, 1])
    scores = jnp.where(jnp.asarray(valid_p).reshape(4, -1, 1, 1, patch), scores, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(scores, axis=-1)).transpose(0, 1, 3, 2)
    want = want.reshape(4, -1, heads)[:, :n]
    np.testing.assert_allclose(lse.numpy()[~dead], want[~dead], rtol=1e-5, atol=1e-5)


def test_kernel_source_and_build_command():
    """The kernel ships as CUDA C++ for sm_90a with a plain C entry point
    that the ctypes binding declares; the library name tracks the source."""
    from scenesplat_tpu_torch.ops import _build

    src = tfwa.SOURCE.read_text()
    assert 'extern "C" int fwa_fwd(' in src
    assert "__global__" in src
    cmd = _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in cmd and "-shared" in cmd
    path = tfwa.LIBRARY.path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path.name == tfwa.LIBRARY.path().name
    # the one-pass forward: a source and a library of its own, its C entry
    # taking the run of units a block is dealt, its window limit the wrapper's
    small = tfwa.SOURCE_SMALL.read_text()
    assert tfwa.SOURCE_SMALL.name == "flash_window_attn_fwd_small.cu"
    assert 'extern "C" int fwa_fwd_small(' in small and "int chunk, void* stream)" in small
    assert 'extern "C" int fwa_fwd_small_residency(' in small
    assert f"constexpr int SMALL_MAX = {tfwa.FWD_SMALL_MAX};" in small and "K > SMALL_MAX" in small
    assert "fwa_fwd_small" not in src
    lib = tfwa.LIBRARY_SMALL.path()
    assert lib.parent == _build.BUILD_DIR and lib.name.startswith("libflash_window_attn_fwd_small_")
    assert tfwa.LIBRARY_SMALL.source == tfwa.SOURCE_SMALL != tfwa.LIBRARY.source
    assert tfwa.VARIANTS["bf16_small"] == (tfwa.SOURCE_SMALL, "fwa_fwd_small")
    assert tfwa.VARIANTS["bf16_tiled"] == (tfwa.SOURCE, "fwa_fwd")
