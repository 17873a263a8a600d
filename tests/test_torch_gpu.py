"""The flash-window attention kernels (K1 forward, K2 backward) on a CUDA
card against their plain version and autograd through it (no JAX
involved). Every test skips without a card; on one, run

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

(--noconftest: the suite's conftest sets up JAX, which a CUDA machine need
not have)."""

import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu_torch.ops import flash_window_attn as fwa  # noqa: E402
from scenesplat_tpu_torch.ops import window_attention as wa  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cuda, b, n, c, k, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, n, 3, c, generator=gen, device=cuda)
    valid = torch.zeros(b, n, dtype=torch.bool, device=cuda)
    valid[0, : (3 * n) // 4 + 1] = True  # partial last window
    if b > 1:
        valid[1, : min(n, k + 3)] = True  # then fully padded windows
    return qkv, valid


@pytest.mark.parametrize("k,c,h", [
    (1024, 32, 2), (1024, 64, 4), (1024, 128, 8), (1024, 256, 16),
    (1024, 768, 16), (1024, 512, 16), (48, 768, 16), (48, 256, 16), (16, 32, 2),
])
def test_kernel_fp32_matches_plain(cuda, k, c, h):
    n = 2 * k + k // 3 + 1  # ragged last window
    qkv, valid = _inputs(cuda, 2, n, c, k)
    before = fwa.flash_window_attention.launches
    got = fwa.flash_window_attention(qkv, valid, k, h)
    assert fwa.flash_window_attention.launches == before + 1
    ref = fwa.flash_window_attention_plain(qkv, valid, k, h)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got[valid] - ref[valid]).abs().max().item() <= 1e-4


@pytest.mark.parametrize("k,c,h", [(1024, 32, 2), (1024, 768, 16), (48, 512, 16)])
def test_kernel_bf16_within_noise_floor(cuda, k, c, h):
    """bf16: the kernel's error against the fp32 plain result may be at most
    2.5x the plain bf16 version's own (tests/test_attention.py's rule)."""
    n = 3 * k + 5
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=1)
    x16 = qkv.bfloat16()
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h))
    err = rel(fwa.flash_window_attention(x16, valid, k, h))
    assert floor > 1e-4
    assert err <= 2.5 * floor, (err, floor)


def test_padded_windows_write_zeros(cuda):
    k, c, h = 64, 64, 4
    qkv, valid = _inputs(cuda, 2, 5 * k, c, k)
    got = fwa.flash_window_attention(qkv, valid, k, h)
    assert (got[1, 2 * k:] == 0).all()


def test_dispatch_and_checks(cuda):
    qkv, valid = _inputs(cuda, 1, 256, 64, 64)
    before = fwa.flash_window_attention.launches
    wa.window_attention(qkv, valid, 64, 4, use_kernel=False)
    assert fwa.flash_window_attention.launches == before
    wa.window_attention(qkv, valid, 64, 4)
    assert fwa.flash_window_attention.launches == before + 1
    with pytest.raises(TypeError):
        fwa.flash_window_attention(qkv.half(), valid, 64, 4)
    with pytest.raises(ValueError):
        fwa.flash_window_attention(qkv[:, ::2], valid[:, ::2], 64, 4)
    with pytest.raises(ValueError):
        fwa.flash_window_attention(qkv, valid, 64, 3)  # C % H != 0
    with pytest.raises(ValueError):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 40 * 4, device=cuda),
                                   valid, 64, 4)  # no instance for head dim 40
    with pytest.raises(ValueError):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 32, device=cuda).bfloat16(),
                                   valid, 64, 4)  # head dim 8


def _grads(fn, qkv, valid, k, h, dout):
    x = qkv.detach().clone().requires_grad_(True)
    out = fn(x, valid, k, h)
    out.backward(dout)
    return out.detach(), x.grad


@pytest.mark.parametrize("k,c,h", [
    (1024, 32, 2), (1024, 256, 16), (1024, 512, 16), (1024, 768, 16),
    (48, 768, 16), (48, 256, 16), (64, 96, 2),
])
def test_backward_fp32_matches_plain_autograd(cuda, k, c, h):
    """K2 through the autograd Function against autograd through the plain
    version: max abs error of dq, dk, dv <= 1e-4 x max |plain grad|;
    padded windows get zero gradients."""
    n = 2 * k + k // 3 + 1  # ragged last window
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=2)
    dout = torch.randn(2, n, c, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(3))
    f0, b0 = fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches
    out, g = _grads(fwa.flash_window_attention, qkv, valid, k, h, dout)
    assert fwa.flash_window_attention.launches == f0 + 1
    assert fwa.flash_window_attention_bwd.launches == b0 + 1
    ref_out, ref = _grads(fwa.flash_window_attention_plain, qkv, valid, k, h, dout)
    torch.cuda.synchronize()
    assert torch.isfinite(g).all()
    assert (out[valid] - ref_out[valid]).abs().max().item() <= 1e-4
    for i in range(3):  # dq, dk, dv
        bound = 1e-4 * ref[:, :, i].abs().max().item()
        assert (g[:, :, i] - ref[:, :, i]).abs().max().item() <= bound, i
    dead = torch.zeros_like(valid)
    dead[1, -(-(k + 3) // k) * k:] = True
    assert dead.any() and (g[dead] == 0).all()


@pytest.mark.parametrize("k,c,h", [(1024, 32, 2), (1024, 768, 16), (48, 512, 16)])
def test_backward_bf16_within_noise_floor(cuda, k, c, h):
    """bf16 gradients: the kernels' relative error against the fp32 plain
    gradient may be at most 2.5x the plain bf16 version's own."""
    n = 3 * k + 5
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=4)
    x16 = qkv.bfloat16()
    dout = torch.randn(2, n, c, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(5)).bfloat16()
    _, truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                      dout.float())

    def rel(a):
        return ((a.float() - truth).norm() / truth.norm()).item()

    floor = rel(_grads(fwa.flash_window_attention_plain, x16, valid, k, h, dout)[1])
    err = rel(_grads(fwa.flash_window_attention, x16, valid, k, h, dout)[1])
    assert floor > 1e-4
    assert err <= 2.5 * floor, (err, floor)


def test_grad_fn_only_when_recording(cuda):
    """The kernel output carries a grad_fn whenever grad is enabled and qkv
    requires grad; under no_grad / inference_mode only K1 runs, without
    the log-sum-exp."""
    qkv, valid = _inputs(cuda, 1, 256, 64, 64)
    x = qkv.requires_grad_(True)
    assert fwa.flash_window_attention(x, valid, 64, 4).grad_fn is not None
    b0 = fwa.flash_window_attention_bwd.launches
    with torch.no_grad():
        assert fwa.flash_window_attention(x, valid, 64, 4).grad_fn is None
    with torch.inference_mode():
        assert fwa.flash_window_attention(x, valid, 64, 4).grad_fn is None
    assert fwa.flash_window_attention_bwd.launches == b0
