"""The hand-written kernels on a CUDA card: the flash-window attention
kernels (K1 forward, K2 backward) against their plain version and autograd
through it, and the bitonic row sort (K3) against its plain version (no JAX
involved). Every test skips without a card; on one, run

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

(--noconftest: the suite's conftest sets up JAX, which a CUDA machine need
not have)."""

import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu_torch.ops import bitonic_sort as bs  # noqa: E402
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


def _sort_operands(cuda, b, n, num_ops, seed, ties=False):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    lo, hi = (0, 8) if ties else (-2 ** 31, 2 ** 31 - 1)  # negative: the high unsigned half
    ops = [torch.randint(lo, hi, (b, n), generator=gen, device=cuda, dtype=torch.int32)
           for _ in range(num_ops - 1)]
    return ops + [torch.arange(n, dtype=torch.int32, device=cuda).expand(b, n).contiguous()]


@pytest.mark.parametrize("b,n,num_ops,num_keys,ties", [
    (1, 1000, 2, 1, False), (4, 1024, 3, 2, False), (3, 4095, 3, 3, True),
    (2, 4097, 2, 2, True), (12, 5000, 3, 1, True), (4, 24576, 3, 3, False),
    (4, 196608, 3, 3, False), (1, 1 << 20, 3, 3, True), (2, 70000, 3, 2, True),
])
def test_bitonic_sort_equals_plain_exactly(cuda, b, n, num_ops, num_keys, ties):
    """K3 and its plain version run one network on identically padded rows:
    every operand equal, payloads included, ties or not."""
    ops = _sort_operands(cuda, b, n, num_ops, seed=n + num_keys, ties=ties)
    kept = [o.clone() for o in ops]
    calls, kernels = bs.bitonic_sort.launches, bs.bitonic_sort.kernel_launches
    got = bs.bitonic_sort(ops, num_keys)
    torch.cuda.synchronize()
    assert bs.bitonic_sort.launches == calls + 1
    assert bs.bitonic_sort.kernel_launches == kernels + bs.kernel_launches(n)
    ref = bs.bitonic_sort_reference(ops, num_keys)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    for o, k in zip(ops, kept):
        assert torch.equal(o, k)  # the inputs are left alone
    # and it is the sort of the keys: against torch.sort on the combined key
    if num_keys <= 2:
        def combined(keys):
            out = torch.zeros_like(keys[0], dtype=torch.int64)
            for k in keys:
                out = (out << 32) | (k.to(torch.int64) & 0xFFFFFFFF)
            return out ^ (-(1 << 63) if num_keys == 2 else 0)  # unsigned order of 64 bits
        assert torch.equal(combined(got[:num_keys]),
                           torch.sort(combined(ops[:num_keys]), dim=-1).values)


def test_sort_int64_switch_on_equals_torch_sort_on_card(cuda, monkeypatch):
    gen = torch.Generator(device=cuda).manual_seed(7)
    code = torch.randint(0, 1 << 30, (4, 1, 50000), generator=gen, device=cuda)  # ties likely
    code[..., -5000:] = 1 << 62  # a sentinel tail
    monkeypatch.delenv(bs.ENV_SWITCH, raising=False)
    values, order = bs.sort_int64(code)
    monkeypatch.setenv(bs.ENV_SWITCH, "1")
    before = bs.bitonic_sort.launches
    values_on, order_on = bs.sort_int64(code)
    assert bs.bitonic_sort.launches == before + 1
    assert torch.equal(values, values_on) and torch.equal(order, order_on)


def test_bitonic_sort_no_fallback(cuda, monkeypatch):
    """With the switch on and CUDA tensors the kernel runs or the call
    raises: a kernel made to fail is not replaced by torch.sort or the
    plain version."""
    class Broken:
        @staticmethod
        def bitonic_sort_rows(*args):
            return 98  # cudaErrorInvalidDeviceFunction

    monkeypatch.setenv(bs.ENV_SWITCH, "1")
    monkeypatch.setattr(bs.LIBRARY, "load", lambda: Broken)
    code = torch.arange(2000, device=cuda).flip(0)[None]
    before = bs.bitonic_sort.launches
    with pytest.raises(RuntimeError):
        bs.sort_int64(code)
    assert bs.bitonic_sort.launches == before
    with pytest.raises(TypeError):
        bs.bitonic_sort([code], 1)  # int64 operands


def test_knn_on_card_equals_ckdtree(cuda):
    """The voting's neighbour search: brute force on the card picks the
    cKDTree's neighbours, nearest first (random coordinates: no ties)."""
    import numpy as np

    from scenesplat_tpu_torch.ops.knn import knn

    rng = np.random.default_rng(0)
    data = rng.uniform(0, 6, (30000, 3)).astype(np.float32)
    query = rng.uniform(0, 6, (4000, 3)).astype(np.float32)
    got, ref = knn(data, query, 25, device=cuda), knn(data, query, 25, device="cpu")
    assert got.shape == ref.shape == (4000, 25) and got.dtype == ref.dtype
    # fp32 on the card, fp64 in the tree: a pair of neighbours closer in
    # distance than fp32 resolves may swap places
    assert (got == ref).mean() > 0.999
    assert (np.sort(got, 1) == np.sort(ref, 1)).mean() > 0.9999
    assert knn(data[:7], query, 25, device=cuda).shape == (4000, 7)
