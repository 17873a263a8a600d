"""The hand-written kernels on a CUDA card: the flash-window attention
kernels (K1 forward, K2 backward) against their plain version and autograd
through it, the bitonic row sort (K3) and the farthest point sampling
kernel against their plain versions (no JAX involved). Every test skips without a card; on one, run

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py -q

(--noconftest: the suite's conftest sets up JAX, which a CUDA machine need
not have)."""

import re

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
    # the semseg files' new signatures: 32 heads at stage 4, 4 heads at C = 64
    (1024, 512, 32), (48, 64, 4),
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


def _plain_lse(qkv, valid, k, h):
    """Natural-log log-sum-exp of the scaled scores over each row's valid
    keys, [B, N, H] fp32 (N a multiple of k)."""
    b, n, _, c = qkv.shape
    d = c // h
    blk = qkv.view(b, n // k, k, 3, h, d).permute(3, 0, 1, 4, 2, 5)
    s = (blk[0] * d ** -0.5).float() @ blk[1].float().transpose(-1, -2)
    s = torch.where(valid.view(b, n // k, 1, 1, k), s, float("-inf"))
    return torch.logsumexp(s, -1).permute(0, 1, 3, 2).reshape(b, n, h)


@pytest.mark.parametrize("k", [128, 256, 1024])
@pytest.mark.parametrize("c,h", [(768, 16), (512, 16), (32, 2), (512, 32), (64, 4)])
def test_large_window_bf16_variant(cuda, k, c, h):
    """The large-window bf16 forward: noise-floor rule, zeros in windows of
    padding, the log-sum-exp against the plain one, with valid prefixes that
    end inside a key tile, on a tile edge, one past it and in a dead
    window; K2 fed with its lse stays within the gradient noise floor."""
    assert fwa.forward_variant(torch.bfloat16, k, c // h) == "bf16_large"
    n = 4 * k
    gen = torch.Generator(device=cuda).manual_seed(k + c)
    x16 = torch.randn(4, n, 3, c, generator=gen, device=cuda).bfloat16()
    valid = torch.zeros(4, n, dtype=torch.bool, device=cuda)
    for row, stop in enumerate((k + 37, 2 * k + 64, 65, n)):
        valid[row, :stop] = True
    large = fwa.flash_window_attention.variant_launches["bf16_large"]
    out, lse = fwa._forward(x16, valid, k, h, (c // h) ** -0.5, True)[:2]
    assert fwa.flash_window_attention.variant_launches["bf16_large"] == large + 1
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h))
    assert floor > 1e-4 and rel(out) <= 2.5 * floor
    live = valid.view(4, n // k, k)[:, :, :1].expand(4, n // k, k).reshape(4, n)
    assert (~live).any() and (out[~live] == 0).all()
    assert (lse - _plain_lse(x16, valid, k, h))[live].abs().max().item() <= 1e-4

    dout = torch.randn(4, n, c, generator=gen, device=cuda).bfloat16()
    _, g_truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                        dout.float())

    def grel(a):
        return ((a.float() - g_truth).norm() / g_truth.norm()).item()

    g_floor = grel(_grads(fwa.flash_window_attention_plain, x16, valid, k, h, dout)[1])
    dqkv = fwa.flash_window_attention_bwd(x16, valid, out, lse, dout, k, h, (c // h) ** -0.5)
    assert grel(dqkv) <= 2.5 * g_floor
    assert (dqkv[~live] == 0).all()


def _small_inputs(cuda, k, c, seed):
    """bf16 qkv [4, N, 3, c] for windows of k with a ragged last window, and
    valid prefixes: inside a window, then windows of padding; inside the
    ragged last window; one slot past the first window; all."""
    n = 3 * k + k // 2 + 5
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x16 = torch.randn(4, n, 3, c, generator=gen, device=cuda).bfloat16()
    valid = torch.zeros(4, n, dtype=torch.bool, device=cuda)
    for row, stop in enumerate((k + 7, n - 3, k + 1, n)):
        valid[row, :stop] = True
    p = -(-n // k)
    slot0 = torch.nn.functional.pad(valid, (0, p * k - n)).view(4, p, k)[:, :, :1]
    live = slot0.expand(4, p, k).reshape(4, p * k)[:, :n]
    return n, x16, valid, live


@pytest.mark.parametrize("k", [16, 32, 48, 64])
@pytest.mark.parametrize("c,h", [(768, 16), (512, 16), (256, 16), (32, 2), (64, 4), (128, 8)])
def test_small_window_bf16_variant(cuda, k, c, h):
    """The one-pass bf16 forward at windows up to 64: noise-floor rule, zeros
    in windows of padding, a ragged last window, the log-sum-exp against the
    plain one, the output bit-equal with and without it; K2 fed with its
    lse stays within the gradient noise floor."""
    assert fwa.forward_variant(torch.bfloat16, k, c // h) == "bf16_small"
    n, x16, valid, live = _small_inputs(cuda, k, c, seed=k + c)
    small = fwa.flash_window_attention.variant_launches["bf16_small"]
    out, lse = fwa._forward(x16, valid, k, h, (c // h) ** -0.5, True)[:2]
    again = fwa.flash_window_attention(x16, valid, k, h)
    assert fwa.flash_window_attention.variant_launches["bf16_small"] == small + 2
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h))
    assert floor > 1e-4 and rel(out) <= 2.5 * floor, (rel(out), floor)
    assert torch.isfinite(out).all()
    assert (~live).any() and (out[~live] == 0).all()
    lse_plain = _plain_lse(torch.nn.functional.pad(x16, (0, 0, 0, 0, 0, -n % k)),
                           torch.nn.functional.pad(valid, (0, -n % k)), k, h)[:, :n]
    assert (lse - lse_plain)[live].abs().max().item() <= 1e-4

    dout = torch.randn(4, n, c, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(k)).bfloat16()
    _, g_truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                        dout.float())

    def grel(a):
        return ((a.float() - g_truth).norm() / g_truth.norm()).item()

    g_floor = grel(_grads(fwa.flash_window_attention_plain, x16, valid, k, h, dout)[1])
    dqkv = fwa.flash_window_attention_bwd(x16, valid, out, lse, dout, k, h, (c // h) ** -0.5)
    assert grel(dqkv) <= 2.5 * g_floor
    assert (dqkv[~live] == 0).all()


@pytest.mark.parametrize("k,variant", [(64, "bf16_small"), (65, "bf16_tiled"),
                                       (127, "bf16_tiled"), (128, "bf16_large")])
def test_forward_variants_either_side_of_small_max(cuda, k, variant):
    """Windows on either side of FWD_SMALL_MAX = 64 and of 128 take the
    variant forward_variant names, each within the bf16 noise floor, with
    zeros in windows of padding and the lse against the plain one."""
    assert fwa.FWD_SMALL_MAX == 64
    c, h = 512, 16
    assert fwa.forward_variant(torch.bfloat16, k, c // h) == variant
    n, x16, valid, live = _small_inputs(cuda, k, c, seed=k)
    before = dict(fwa.flash_window_attention.variant_launches)
    out, lse = fwa._forward(x16, valid, k, h, (c // h) ** -0.5, True)[:2]
    after = fwa.flash_window_attention.variant_launches
    assert {v: after[v] - before[v] for v in after} == {
        v: int(v == variant) for v in fwa.VARIANTS}
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h))
    assert floor > 1e-4 and rel(out) <= 2.5 * floor, (rel(out), floor)
    assert (out[~live] == 0).all()
    lse_plain = _plain_lse(torch.nn.functional.pad(x16, (0, 0, 0, 0, 0, -n % k)),
                           torch.nn.functional.pad(valid, (0, -n % k)), k, h)[:, :n]
    assert (lse - lse_plain)[live].abs().max().item() <= 1e-4


@pytest.mark.parametrize("k,c,h", [(48, 768, 16), (48, 64, 4)])
def test_small_forward_unit_orders_agree(cuda, k, c, h):
    """Every unit order of the one-pass forward gives the same bits (the
    order moves no arithmetic), at a grid smaller than the unit count, with
    16 heads and with the semseg decoder's 4 (runs of two heads: two runs a
    window); the C function refuses an order, a window and a head width it
    lacks."""
    n, x16, valid, live = _small_inputs(cuda, k, c, seed=3)
    lib, stream = fwa.LIBRARY_SMALL.load(), torch.cuda.current_stream().cuda_stream
    outs = []
    for order in fwa.SMALL_UNIT_ORDERS:
        out = torch.empty(4, n, c, dtype=torch.bfloat16, device=cuda)
        lse = torch.empty(4, n, h, device=cuda)
        assert lib.fwa_fwd_small(x16.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                 lse.data_ptr(), 1, 4, n, c, h, k, (c // h) ** -0.5,
                                 fwa.small_chunk(order, h), stream) == 0
        outs.append((out, lse))
    torch.cuda.synchronize()
    # the lse of a window of padding is not written
    for out, lse in outs[1:]:
        assert torch.equal(outs[0][0], out) and torch.equal(outs[0][1][live], lse[live])
    assert lib.fwa_fwd_small_residency(c // h, k) >= 1
    p = x16.data_ptr()
    for kk, cc, chunk in ((k, c, 1025), (k, c, -1), (fwa.FWD_SMALL_MAX + 1, c, 1),
                          (k, 40 * h, 1)):
        assert lib.fwa_fwd_small(p, valid.data_ptr(), p, None, 1, 4, n, cc, h, kk, 0.25, chunk,
                                 stream) != 0


def test_small_forward_no_fallback(cuda, monkeypatch):
    """A refused launch or a failed build of the one-pass forward raises;
    neither the tiled kernel nor the plain version runs in its place."""
    class Refuses:
        @staticmethod
        def fwa_fwd_small(*args):
            return 1  # cudaErrorInvalidValue

    def no_compiler():
        raise RuntimeError("nvcc not found")

    x16 = torch.randn(1, 480, 3, 64, device=cuda).bfloat16()
    valid = torch.ones(1, 480, dtype=torch.bool, device=cuda)
    fwa.flash_window_attention(x16, valid, 48, 4)  # builds and runs
    before = dict(fwa.flash_window_attention.variant_launches)
    with monkeypatch.context() as patch:
        patch.setattr(fwa.LIBRARY_SMALL, "load", lambda: Refuses)
        with pytest.raises(RuntimeError, match="bf16_small"):
            fwa.flash_window_attention(x16, valid, 48, 4)
    with monkeypatch.context() as patch:
        patch.setattr(fwa.LIBRARY_SMALL, "_lib", None)
        patch.setattr(fwa.LIBRARY_SMALL, "build", no_compiler)
        with pytest.raises(RuntimeError):
            fwa.flash_window_attention(x16, valid, 48, 4)
    assert fwa.flash_window_attention.variant_launches == before


def test_attention_no_fallback(cuda, monkeypatch):
    """On CUDA tensors a variant's kernel launches or the call raises: a
    failed launch or a failed build is not replaced by the other variant
    or the plain version."""
    class Refuses:
        @staticmethod
        def fwa_fwd_large(*args):
            return 1  # cudaErrorInvalidValue

    x16 = torch.randn(1, 512, 3, 64, device=cuda).bfloat16()
    valid = torch.ones(1, 512, dtype=torch.bool, device=cuda)
    fwa.flash_window_attention(x16, valid, 128, 4)  # builds and runs
    before = fwa.flash_window_attention.launches
    with monkeypatch.context() as patch:
        patch.setattr(fwa.LIBRARY_LARGE, "load", lambda: Refuses)
        with pytest.raises(RuntimeError):
            fwa.flash_window_attention(x16, valid, 128, 4)

    def no_compiler():
        raise RuntimeError("nvcc not found")

    with monkeypatch.context() as patch:
        patch.setattr(fwa.LIBRARY_LARGE, "_lib", None)
        patch.setattr(fwa.LIBRARY_LARGE, "build", no_compiler)
        with pytest.raises(RuntimeError):
            fwa.flash_window_attention(x16, valid, 128, 4)
    assert fwa.flash_window_attention.launches == before
    # the C function refuses a window its tile list cannot hold
    rc = fwa.LIBRARY_LARGE.load().fwa_fwd_large(
        x16.data_ptr(), valid.data_ptr(), x16.data_ptr(), None, 1, 1, 512, 64, 4, 8192, 0.25,
        torch.cuda.current_stream().cuda_stream)
    assert rc != 0

    # the backward, both bf16 variants: a refused launch or a failed build
    # raises out of the autograd backward, and nothing else runs in its place
    class RefusesBwd:
        @staticmethod
        def fwa_bwd_small(*args):
            return 1

        fwa_bwd_large = fwa_bwd_small

    dout = torch.randn(1, 512, 64, device=cuda).bfloat16()
    for k, library in ((48, fwa.LIBRARY_BWD), (128, fwa.LIBRARY_BWD_LARGE)):
        variant = fwa.backward_variant(torch.bfloat16, k, 16)
        x = x16.detach().clone().requires_grad_(True)
        fwa.flash_window_attention(x, valid, k, 4).backward(dout)  # builds and runs
        b0 = dict(fwa.flash_window_attention_bwd.variant_launches)
        with monkeypatch.context() as patch:
            patch.setattr(library, "load", lambda: RefusesBwd)
            with pytest.raises(RuntimeError, match=variant):
                fwa.flash_window_attention(x, valid, k, 4).backward(dout)
        with monkeypatch.context() as patch:
            patch.setattr(library, "_lib", None)
            patch.setattr(library, "build", no_compiler)
            with pytest.raises(RuntimeError):
                fwa.flash_window_attention(x, valid, k, 4).backward(dout)
        assert fwa.flash_window_attention_bwd.variant_launches == b0
    # each C function refuses the other's windows and head widths it lacks
    stream = torch.cuda.current_stream().cuda_stream
    p = x16.data_ptr()
    for k, c in ((fwa.BWD_SMALL_MAX + 1, 64), (48, 160)):
        assert fwa.LIBRARY_BWD.load().fwa_bwd_small(p, valid.data_ptr(), p, p, p, 1, 1, 512, c,
                                                    4, k, 0.25, stream) != 0
    for k, c in ((fwa.BWD_SMALL_MAX, 64), (128, 160)):
        assert fwa.LIBRARY_BWD_LARGE.load().fwa_bwd_large(
            p, valid.data_ptr(), p, p, p, p, p, 1, 1, 512, c, 4, k, 0.25, stream) != 0


@pytest.mark.parametrize("k", [48, 1024])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("d", [8, 24, 40, 64, 96, 128])
def test_head_widths_and_float16_match_plain(cuda, d, dtype, k):
    """K1 and K2 at head widths the wrapper pads (8, 24, 40) and the wider
    instantiated ones, in every storage type: fp32 to 1e-4 (the forward)
    and 1e-4 of each gradient's largest magnitude; bf16 and fp16 within 2.5
    times the plain version's own error in that type; on the variant and
    padded width the dispatch names."""
    dt, h = getattr(torch, dtype), 2
    c, n = h * d, 2 * k + k // 3 + 1
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=d)
    x = qkv.to(dt)
    dout = torch.randn(2, n, c, device=cuda).to(dt)
    key = (fwa.forward_variant(dt, k, d), dtype, fwa.padded_head_dim(d))
    before = fwa.flash_window_attention.width_launches.get(key, 0)

    def grads(fn, t, g):
        t = t.detach().clone().requires_grad_(True)
        out = fn(t, valid, k, h)
        out.backward(g)
        return out.detach(), t.grad

    out, g = grads(fwa.flash_window_attention, x, dout)
    assert fwa.flash_window_attention.width_launches[key] == before + 1
    if dt == torch.float32:
        ref_out, ref = grads(fwa.flash_window_attention_plain, x, dout)
        assert (out - ref_out)[valid].abs().max().item() <= 1e-4
        for i in range(3):
            assert (g[:, :, i] - ref[:, :, i]).abs().max() <= 1e-4 * ref[:, :, i].abs().max()
        return
    t_out, truth = grads(fwa.flash_window_attention_plain, x.float(), dout.float())
    p_out, p_g = grads(fwa.flash_window_attention_plain, x, dout)

    def rel(a, b):
        return ((a[valid].float() - b[valid]).norm() / b[valid].norm()).item()

    for got, plain, want in ((out, p_out, t_out), (g, p_g, truth)):
        floor = rel(plain, want)
        assert floor > 1e-5 and rel(got, want) <= 2.5 * floor, (rel(got, want), floor)


def test_head_width_and_type_without_a_kernel_raise(cuda):
    """A CUDA call at a head width above 128 or in float64 raises; nothing
    stands in for the kernel."""
    valid = torch.ones(1, 256, dtype=torch.bool, device=cuda)
    before = fwa.flash_window_attention.launches
    with pytest.raises(ValueError, match="128"):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 2 * 129, device=cuda), valid, 64, 2)
    with pytest.raises(TypeError):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 64, device=cuda).double(), valid,
                                   64, 2)
    assert fwa.flash_window_attention.launches == before


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
        fwa.flash_window_attention(qkv.double(), valid, 64, 4)
    with pytest.raises(ValueError):
        fwa.flash_window_attention(qkv[:, ::2], valid[:, ::2], 64, 4)
    with pytest.raises(ValueError):
        fwa.flash_window_attention(qkv, valid, 64, 3)  # C % H != 0
    with pytest.raises(ValueError):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 132 * 4, device=cuda),
                                   valid, 64, 4)  # head dim 132, above the cap of 128
    with pytest.raises(ValueError):
        fwa.flash_window_attention(torch.randn(1, 256, 3, 256 * 4, device=cuda).bfloat16(),
                                   valid, 64, 4)  # head dim 256


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


# the flagship's attention signatures on a tensor-parallel rank at model 2:
# H / 2 heads of the unchanged head width (encoder windows of 1024, the
# flagship file's decoder windows of 48)
TP_LOCAL = [(1024, 16, 1), (1024, 32, 2), (1024, 64, 4), (1024, 128, 8),
            (48, 384, 8), (48, 256, 8), (48, 128, 8)]


@pytest.mark.parametrize("k,c,h", TP_LOCAL)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_local_heads_match_plain(cuda, k, c, h, dtype):
    """K1 and K2 at a tensor-parallel rank's heads: fp32 within 1e-4 of
    the plain version's output and of autograd through it (of each
    gradient's largest magnitude); bf16 within 2.5 times the plain bf16
    version's own distance from the fp32 truth, output and gradients."""
    n = 2 * k + k // 3 + 1
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=4)
    dout = torch.randn(2, n, c, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(5))
    f0, b0 = fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches
    out, g = _grads(fwa.flash_window_attention, qkv.to(dtype), valid, k, h, dout.to(dtype))
    assert (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches) == (
        f0 + 1, b0 + 1)
    if dtype == torch.float32:
        ref_out, ref = _grads(fwa.flash_window_attention_plain, qkv, valid, k, h, dout)
        assert (out[valid] - ref_out[valid]).abs().max().item() <= 1e-4
        for i in range(3):
            assert (g[:, :, i] - ref[:, :, i]).abs().max().item() <= (
                1e-4 * ref[:, :, i].abs().max().item()), i
        return
    x16, d16 = qkv.bfloat16(), dout.bfloat16()
    truth_out, truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                              d16.float())
    floor_out, floor = _grads(fwa.flash_window_attention_plain, x16, valid, k, h, d16)

    def rel(a, b):
        return ((a.float() - b).norm() / b.norm()).item()

    assert rel(out[valid], truth_out[valid]) <= 2.5 * rel(floor_out[valid], truth_out[valid])
    assert rel(g, truth) <= 2.5 * rel(floor, truth)


@pytest.mark.parametrize("n,k,c,h", [(49152, 1024, 32, 2), (6144, 1024, 256, 16),
                                     (49152, 48, 768, 16), (3000, 1024, 64, 4)])
@pytest.mark.parametrize("parts", [2, 4])
def test_cp_rank_windows_match_whole_row(cuda, n, k, c, h, parts):
    """Context parallel: K1 and K2 on each seq rank's whole windows
    (``rank_windows``; at 3,000 slots and 4 parts the last rank has none)
    give, put together, the whole row's kernel output and gradients (to
    1e-6 of their largest magnitude), and
    each part's launch matches the plain version on that part within
    1e-4 (fp32)."""
    qkv, valid = _inputs(cuda, 2, n, c, k, seed=6)
    dout = torch.randn(2, n, c, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(7))
    whole_out, whole = _grads(fwa.flash_window_attention, qkv, valid, k, h, dout)
    outs, grads = [], []
    for i in range(parts):
        lo, hi = wa.rank_windows(n, k, parts, i)
        if hi == lo:
            continue
        part = [t[:, lo:hi].contiguous() for t in (qkv, valid, dout)]
        out, g = _grads(fwa.flash_window_attention, *part[:2], k, h, part[2])
        ref_out, ref = _grads(fwa.flash_window_attention_plain, *part[:2], k, h, part[2])
        assert (out[part[1]] - ref_out[part[1]]).abs().max().item() <= 1e-4
        assert (g - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
        outs.append(out)
        grads.append(g)
    got_out, got = torch.cat(outs, 1), torch.cat(grads, 1)
    assert (got_out[valid] - whole_out[valid]).abs().max().item() <= 1e-6
    assert (got - whole).abs().max().item() <= 1e-6 * whole.abs().max().item()


BWD_FP32_RTOL = 1e-4  # fp32 gradients: max abs error over the largest plain gradient


@pytest.mark.parametrize("k", [48, 64, 65, 128, 1024])
@pytest.mark.parametrize("c,h", [(768, 16), (512, 16), (32, 2), (512, 32), (64, 4)])
def test_backward_variants_either_side_of_threshold(cuda, k, c, h):
    """Windows of 48 and 64 (the threshold) take the one-pass bf16
    backward, 65 and more the two-kernel one: each within 2.5x the plain bf16
    gradient error, fp32 within BWD_FP32_RTOL, with a ragged last window, a
    valid prefix that ends inside a window and windows of padding (zero
    gradients)."""
    assert fwa.BWD_SMALL_MAX == 64
    n = 3 * k + k // 2 + 5
    gen = torch.Generator(device=cuda).manual_seed(k + c)
    qkv = torch.randn(2, n, 3, c, generator=gen, device=cuda)
    dout = torch.randn(2, n, c, generator=gen, device=cuda)
    valid = torch.zeros(2, n, dtype=torch.bool, device=cuda)
    valid[0, : int(0.8 * n)] = True
    valid[1, : k + 7] = True
    dead = torch.zeros_like(valid)
    dead[1, 2 * k:] = True

    bwd = fwa.flash_window_attention_bwd
    f0 = bwd.variant_launches["fp32"]
    _, g = _grads(fwa.flash_window_attention, qkv, valid, k, h, dout)
    _, ref = _grads(fwa.flash_window_attention_plain, qkv, valid, k, h, dout)
    assert bwd.variant_launches["fp32"] == f0 + 1
    for i in range(3):
        bound = BWD_FP32_RTOL * ref[:, :, i].abs().max().item()
        assert (g[:, :, i] - ref[:, :, i]).abs().max().item() <= bound, i
    assert (g[dead] == 0).all()

    x16, d16 = qkv.bfloat16(), dout.bfloat16()
    variant = fwa.backward_variant(torch.bfloat16, k, c // h)
    assert variant == ("bf16_small" if k <= 64 else "bf16_large")
    _, truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h, d16.float())

    def rel(a):
        return ((a.float() - truth).norm() / truth.norm()).item()

    floor = rel(_grads(fwa.flash_window_attention_plain, x16, valid, k, h, d16)[1])
    v0 = bwd.variant_launches[variant]
    g16 = _grads(fwa.flash_window_attention, x16, valid, k, h, d16)[1]
    torch.cuda.synchronize()
    assert bwd.variant_launches[variant] == v0 + 1
    assert torch.isfinite(g16).all() and (g16[dead] == 0).all()
    assert floor > 1e-4 and rel(g16) <= 2.5 * floor, (rel(g16), floor)


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


# the encoder stages of a local crop of the SSL files (25,600 points, windows
# of 1024, capacities 1/2 to 1/16 rounded up to whole windows): (N, C, H)
SSL_LOCAL_STAGES = [(25600, 32, 2), (13312, 64, 4), (7168, 128, 8), (4096, 256, 16),
                    (2048, 512, 32)]


@pytest.mark.parametrize("n,c,h", SSL_LOCAL_STAGES)
def test_ssl_local_crop_stages(cuda, n, c, h):
    """K1 and K2 in bf16 at a local crop's stage shapes (whole windows of
    1024, stage 4 two of them): the forward with lse within the noise floor
    and its output equal to the one without lse (the teacher's launch),
    the lse against the plain one, K2 within the gradient noise floor, zeros
    in windows of padding."""
    k = 1024
    gen = torch.Generator(device=cuda).manual_seed(n + c)
    x16 = torch.randn(2, n, 3, c, generator=gen, device=cuda).bfloat16()
    dout = torch.randn(2, n, c, generator=gen, device=cuda).bfloat16()
    valid = torch.zeros(2, n, dtype=torch.bool, device=cuda)
    valid[0, : n - 700] = True  # a partial last window
    valid[1, : k + 300] = True  # then windows of padding (one at stage 4)
    live = valid.view(2, n // k, k)[:, :, :1].expand(2, n // k, k).reshape(2, n)
    lse_before = fwa.flash_window_attention.lse_variant_launches["bf16_large"]
    out, lse = fwa._forward(x16, valid, k, h, (c // h) ** -0.5, True)[:2]
    assert fwa.flash_window_attention.lse_variant_launches["bf16_large"] == lse_before + 1
    assert torch.equal(out, fwa.flash_window_attention(x16, valid, k, h))
    assert fwa.flash_window_attention.lse_variant_launches["bf16_large"] == lse_before + 1
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(a):
        return ((a[valid].float() - truth).norm() / truth.norm()).item()

    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h))
    assert floor > 1e-4 and rel(out) <= 2.5 * floor
    assert (out[~live] == 0).all()
    assert (lse - _plain_lse(x16, valid, k, h))[live].abs().max().item() <= 1e-4

    _, g_truth = _grads(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                        dout.float())

    def grel(a):
        return ((a.float() - g_truth).norm() / g_truth.norm()).item()

    g_floor = grel(_grads(fwa.flash_window_attention_plain, x16, valid, k, h, dout)[1])
    g = _grads(fwa.flash_window_attention, x16, valid, k, h, dout)[1]
    assert g_floor > 1e-4 and grel(g) <= 2.5 * g_floor
    assert (g[~live] == 0).all()


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


@pytest.mark.parametrize("condition", ["ScanNetGS", "ScanNetPPGS"])
def test_ppt_step_kernels_match_plain(cuda, condition):
    """One fp32 Point Prompt Training loss (PPT-v1m2 over a small
    PDNorm-conditioned PT-v3m1, the backbone's conditions in the other
    order) with K1 / K2 against the plain attention: the loss to 1e-5 and
    each gradient to 1e-4 of its norm; the other condition's norms and head
    take no gradient on either path."""
    from scenesplat_tpu_torch.engines.train_step import ppt_loss
    from scenesplat_tpu_torch.models import PointBatch, build_model
    from scenesplat_tpu_torch.models.losses.misc import CrossEntropyLoss

    gen = torch.Generator().manual_seed(3)
    grid = torch.unique(torch.randint(0, 40, (3000, 3), generator=gen), dim=0)[:2048]
    n = grid.shape[0]
    point = PointBatch(coord=(grid.float() * 0.02)[None].to(cuda),
                       feat=torch.randn(1, n, 6, generator=gen).to(cuda),
                       grid_coord=grid[None].to(cuda), mask=torch.ones(1, n, dtype=torch.bool,
                                                                       device=cuda))
    segment = torch.randint(0, 5, (1, n), generator=gen).to(cuda)

    def step(use_kernel):
        model = build_model(dict(
            type="PPT-v1m2", backbone_out_channels=32, context_channels=32,
            conditions=("ScanNetGS", "ScanNetPPGS"), num_classes=(5, 8),
            backbone=dict(type="PT-v3m1", in_channels=6, order=("z", "z-trans"), stride=(2,),
                          enc_depths=(1, 1), enc_channels=(32, 64), enc_num_head=(2, 4),
                          enc_patch_size=(128, 128), dec_depths=(1,), dec_channels=(32,),
                          dec_num_head=(2,), dec_patch_size=(48,), drop_path=0.0,
                          shuffle_orders=False, stage_capacity=(1.0,),
                          pdnorm_conditions=("ScanNetPPGS", "ScanNetGS"), context_channels=32,
                          use_kernel=use_kernel, seed=1))).to(cuda).train()
        batch = dict(coord=point.coord, feat=point.feat, grid_coord=point.grid_coord,
                     mask=point.mask, segment=segment, condition=condition)
        loss, _ = ppt_loss(model, CrossEntropyLoss(ignore_index=-1), batch)
        loss.backward()
        return loss.item(), {k: p.grad for k, p in model.named_parameters()
                             if p.grad is not None}

    before = fwa.flash_window_attention.launches
    loss_k, grads_k = step(None)
    assert fwa.flash_window_attention.launches == before + 3
    loss_p, grads_p = step(False)
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    assert sorted(grads_k) == sorted(grads_p)
    inactive = 1 - ("ScanNetGS", "ScanNetPPGS").index(condition)
    assert f"seg_heads.{inactive}.weight" not in grads_k
    active = ("ScanNetPPGS", "ScanNetGS").index(condition)  # in the backbone's order
    pdnorms = (re.search(r"\.norm\.(\d+)\.(weight|bias)$", k) for k in grads_k)
    assert {int(m.group(1)) for m in pdnorms if m} == {active}
    total = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_p.values()]))
    for k, g in grads_p.items():
        if g.norm() > 1e-7 * total:
            assert (grads_k[k] - g).norm() <= 1e-4 * g.norm(), k


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


@pytest.mark.parametrize("shape", [(4, 1, 50000), (1, 1000), (3, 4097), (4, 196608),
                                   (1, 1 << 20), (2, 3, 24576)])
def test_sort_int64_switch_on_equals_torch_sort_on_card(cuda, monkeypatch, shape):
    """K3's int64 entry: one call, the schedule's launches, and the sorted
    codes and stable order of torch.sort, ties and a sentinel tail included."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    code = torch.randint(0, 1 << 30, shape, generator=gen, device=cuda)  # ties likely
    code[..., -(shape[-1] // 10):] = 1 << 62  # a sentinel tail
    kept = code.clone()
    monkeypatch.delenv(bs.ENV_SWITCH, raising=False)
    values, order = bs.sort_int64(code)
    monkeypatch.setenv(bs.ENV_SWITCH, "1")
    before, kernels = bs.bitonic_sort.launches, bs.bitonic_sort.kernel_launches
    values_on, order_on = bs.sort_int64(code)
    assert bs.bitonic_sort.launches == before + 1
    assert bs.bitonic_sort.kernel_launches == kernels + bs.kernel_launches(shape[-1])
    assert torch.equal(values, values_on) and torch.equal(order, order_on)
    assert order_on.dtype == torch.int64 and torch.equal(code, kept)
    assert bs.kernel_launches(1 << 18) <= 10


def test_bitonic_sort_no_fallback(cuda, monkeypatch):
    """With the switch on and CUDA tensors the kernel runs or the call
    raises: a kernel made to fail is not replaced by torch.sort or the
    plain version."""
    class Broken:
        @staticmethod
        def bitonic_sort_rows(*args):
            return 98  # cudaErrorInvalidDeviceFunction

        bitonic_sort_codes = bitonic_sort_rows

    monkeypatch.setenv(bs.ENV_SWITCH, "1")
    monkeypatch.setattr(bs.LIBRARY, "load", lambda: Broken)
    code = torch.arange(2000, device=cuda).flip(0)[None]
    before = bs.bitonic_sort.launches
    with pytest.raises(RuntimeError):
        bs.sort_int64(code)
    ops = [code.int(), torch.arange(2000, dtype=torch.int32, device=cuda)[None]]
    with pytest.raises(RuntimeError):
        bs.bitonic_sort(ops, 1)
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


def _voxel_rows(seed, rows=2, n=6000, extent=48, duplicates=50):
    """Unique random voxels a row plus ``duplicates`` repeated ones (Mix3D
    merges hold such) and a padding tail of 64: (grid [rows, n', 3] int64,
    mask)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    grids, masks = [], []
    for _ in range(rows):
        flat = rng.choice(extent ** 3, n, replace=False)
        g = np.stack(np.unravel_index(flat, (extent,) * 3), -1)
        g = np.concatenate([g, g[:duplicates], np.zeros((64, 3), np.int64)])
        grids.append(g)
        masks.append(np.arange(len(g)) < n + duplicates)
    return torch.from_numpy(np.stack(grids)), torch.from_numpy(np.stack(masks))


def test_sparse_convs_on_card_equal_cpu(cuda):
    """SpUNet's strided and inverse convs over one pooling plan: values and
    the gradients of the features and both kernels on the card equal the
    CPU's within 1e-5 of each tensor's largest magnitude (fp32; the card's
    scatter-add sums in another order)."""
    from scenesplat_tpu_torch.ops.segops import build_pooling_plan
    from scenesplat_tpu_torch.ops.serialization import serialize
    from scenesplat_tpu_torch.ops.sparse_conv import inverse_conv_apply, strided_conv_apply

    grid, mask = _voxel_rows(3)
    gen = torch.Generator().manual_seed(4)
    feat = torch.randn(*mask.shape, 32, generator=gen)
    k_down, k_up = torch.randn(8, 32, 64, generator=gen), torch.randn(8, 64, 16, generator=gen)
    cot = torch.randn(*mask.shape, 16, generator=gen)

    def run(device):
        g, m = grid.to(device), mask.to(device)
        plan = build_pooling_plan(serialize(g, m, ("z",), 16), m, mask.shape[1], 1)
        leaves = [t.to(device).requires_grad_() for t in (feat, k_down, k_up)]
        down = strided_conv_apply(leaves[0], plan, g, leaves[1])
        up = inverse_conv_apply(down, plan, g, leaves[2], mask=m)
        (up * cot.to(device)).sum().backward()
        return [t.detach().cpu() for t in (down, up)] + [t.grad.cpu() for t in leaves]

    for got, ref, what in zip(run(cuda), run("cpu"), ("down", "up", "dfeat", "dk_down", "dk_up")):
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), what


def test_pointgroup_cluster_on_card_equals_cpu(cuda, monkeypatch):
    """Cluster ids and count on the card equal the CPU's exactly (the same
    float32 cells and distances), on scattered points and on piles of
    hundreds of points in one cell, in one chunk of pairs and in many."""
    import numpy as np

    from scenesplat_tpu_torch.ops import cluster

    rng = np.random.default_rng(5)
    piles = [rng.uniform(0, 40, 3) + 0.3 * rng.random((int(s), 3))
             for s in rng.integers(20, 900, 40)]
    coord = np.concatenate(piles + [rng.uniform(0, 40, (20000, 3))]).astype(np.float32)
    labels = rng.integers(0, 4, len(coord)).astype(np.int32)
    c, lab = torch.from_numpy(coord), torch.from_numpy(labels)
    for chunk in (1 << 23, 1 << 16):
        monkeypatch.setattr(cluster, "PAIRS_PER_CHUNK", chunk)
        got, n_got = cluster.pointgroup_cluster(c.to(cuda), lab.to(cuda), 1.5, 50)
        ref, n_ref = cluster.pointgroup_cluster(c, lab, 1.5, 50)
        assert n_got == n_ref > 10 and torch.equal(got.cpu(), ref)


def _fps_rows(cuda, b, n, seed, pad=0, spread=4.0, lattice=False):
    """Rows of n points uniform in a ``spread`` metre cube (one point
    duplicated: a tie), the last ``pad`` slots of the last row padded and
    a few slots at the start of row 0 padded (its first valid point is not
    slot 0). ``lattice``: the points of a 12.5 cm lattice (exact in fp32),
    slot by slot along its rows, where distances tie everywhere (row 1
    shifted by 3 slots)."""
    if lattice:
        side = round(n ** (1 / 3)) + 1
        g = torch.arange(n + 3, device=cuda)
        cells = torch.stack([g // (side * side), (g // side) % side, g % side], -1) * 0.125
        coord = torch.stack([cells[:n], cells[3:]]).float()[:b]
    else:
        gen = torch.Generator(device=cuda).manual_seed(seed)
        coord = torch.rand(b, n, 3, generator=gen, device=cuda) * spread
        if n > 7:
            coord[:, 7] = coord[:, 3]
    mask = torch.ones(b, n, dtype=torch.bool, device=cuda)
    mask[0, :3] = False
    if pad:
        mask[-1, n - pad:] = False
    return coord, mask


def _edges():
    """(b, n, m, pad, lattice) at each block count's capacity and one point
    more (the kernel's blocks a row: ops/fps.py:blocks_per_row), and past
    16 blocks' into the scratch row."""
    from scenesplat_tpu_torch.ops import fps

    cases = []
    for blocks in fps.CLUSTER_SIZES:
        for extra in (0, 1):
            cases.append((2, blocks * fps.BLOCK_POINTS + extra, 300, 17, False))
    cases.append((2, 16 * fps.BLOCK_POINTS + 40000, 400, 3, False))
    return cases


@pytest.mark.parametrize("b,n,m,pad,lattice", [
    (2, 102912, 25729, 0, False),  # the Stratified Transformer's stem at the train rows
    (2, 25729, 6433, 1000, False),  # its first stage (about 6,433 of 25,729 valid)
    (2, 1609, 403, 100, False), (1, 5, 9, 0, False),  # a later stage; more samples than points
    (2, 120000, 2000, 3, False),  # 8 blocks a row
    (3, 4096, 1024, 256, False),  # PTv1's first transition at a test size
    (2, 4097, 300, 17, False),  # one block of 1024 threads; 4,096 and below take 256
    # lattice rows: every distance ties, a padded tail; 16 blocks, 4 and 1
    (2, 205824, 600, 40000, True), (2, 51457, 600, 2000, True), (2, 4096, 600, 96, True),
] + _edges())
def test_fps_kernel_ids_equal_plain_loop(cuda, b, n, m, pad, lattice):
    from scenesplat_tpu_torch.ops import fps
    from scenesplat_tpu_torch.ops import pointops as po

    coord, mask = _fps_rows(cuda, b, n, seed=n, pad=pad, lattice=lattice)
    before = fps.farthest_point_sampling_cuda.launches
    got, got_mask = po.farthest_point_sampling(coord, mask, m)
    assert fps.farthest_point_sampling_cuda.launches == before + 1
    want = po.farthest_point_sampling_reference(coord, mask, m)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got_mask.cpu(), po._sample_mask(mask.cpu(), m))


def test_fps_kernel_block_points(cuda):
    """The source's points a block equal the wrapper's, which picks the
    blocks a row by them."""
    from scenesplat_tpu_torch.ops import fps

    assert fps.LIBRARY.load().fps_block_points() == fps.BLOCK_POINTS


def test_fps_kernel_row_without_valid_points(cuda):
    from scenesplat_tpu_torch.ops import pointops as po

    coord, mask = _fps_rows(cuda, 2, 300, seed=1)
    mask[1] = False
    got, _ = po.farthest_point_sampling(coord, mask, 20)
    assert torch.equal(got, po.farthest_point_sampling_reference(coord, mask, 20))
