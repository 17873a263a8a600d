"""Port parity, window attention: the port's plain masked-exp window
attention (the CPU side of the flash-window kernel) against the JAX
package's ``window_attention_reference`` on the same numpy inputs, the
ragged last window, and the CPU dispatch rules."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.ops import window_attention as jwa  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402
from scenesplat_tpu_torch.ops import window_attention as twa  # noqa: E402


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
