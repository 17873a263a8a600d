"""Port parity, window attention at any head width up to 128 and in
float16: the port's plain attention against the JAX package's
``window_attention`` (its jnp path, as the JAX tests run it on the CPU) at
head widths the kernels pad (8, 24, 40) and at widths they take as they are
(64, 128), forward and gradients, in fp32, bf16 and fp16; the wrapper's
head pad and slice against the unpadded plain version; the variant and
padded width every head width from 1 to 128 and every storage type gets,
read from the sources; and a two-stage PT-v3m1 with heads of width 64 and
24 against the JAX model. About 50 s alone on one worker."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.ops import window_attention as jwa  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as tfwa  # noqa: E402
from scenesplat_tpu_torch.ops import window_attention as twa  # noqa: E402

WIDTHS = (8, 24, 40, 64, 128)
PATCH, HEADS, N = 16, 2, 64  # four windows a row
ATOL = 1e-5  # fp32, forward and gradients
NOISE_FACTOR = 2.5  # bf16 and fp16: the noise-floor rule of tests/test_attention.py
JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _inputs(seed, d, b=2, n=N, heads=HEADS):
    """qkv, a validity mask with a partial and a fully padded window (each
    row a valid prefix) and an output gradient, fp32 numpy."""
    rng = np.random.default_rng(seed)
    qkv = rng.normal(size=(b, n, 3, heads * d)).astype(np.float32)
    valid = np.zeros((b, n), bool)
    valid[0, : (3 * n) // 4 + 3] = True
    valid[1, : PATCH + 5] = True
    dout = rng.normal(size=(b, n, heads * d)).astype(np.float32)
    return qkv, valid, dout


def _jax(qkv, valid, dout, dtype=jnp.float32):
    """The JAX package's window_attention on its jnp path: output and the
    gradient of sum(out * dout) with respect to qkv, as fp32 numpy."""
    def f(x):
        return jwa.window_attention(x, jnp.asarray(valid), PATCH, HEADS, use_pallas=False)

    x = jnp.asarray(qkv).astype(dtype)
    out, vjp = jax.vjp(f, x)
    (grad,) = vjp(jnp.asarray(dout).astype(dtype))
    return np.asarray(out.astype(jnp.float32)), np.asarray(grad.astype(jnp.float32))


def _torch(qkv, valid, dout, dtype=torch.float32):
    """The port's window_attention on CPU tensors (the plain version):
    output and d sum(out * dout) / d qkv, as fp32 numpy."""
    x = torch.from_numpy(qkv).to(dtype).requires_grad_(True)
    out = twa.window_attention(x, torch.from_numpy(valid), PATCH, HEADS)
    out.backward(torch.from_numpy(dout).to(dtype))
    return out.detach().float().numpy(), x.grad.float().numpy()


@pytest.mark.parametrize("d", WIDTHS)
def test_plain_matches_jax_at_head_width_fp32(d):
    qkv, valid, dout = _inputs(d, d)
    ref_out, ref_g = _jax(qkv, valid, dout)
    out, g = _torch(qkv, valid, dout)
    np.testing.assert_allclose(out[valid], ref_out[valid], rtol=ATOL, atol=ATOL)
    np.testing.assert_allclose(g, ref_g, rtol=ATOL, atol=ATOL)
    assert np.abs(g).max() > 0.1  # the gradients are not all zero


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", WIDTHS)
def test_plain_matches_jax_at_head_width_low_precision(d, dtype):
    """bf16 and fp16 storage: the two packages round at the same places
    (q * scale and P to the storage type, fp32 sums) but not in the same
    order, so each is held to the fp32 result: the port's relative error of
    the output and of the gradient may be at most 2.5 times the JAX
    package's own."""
    qkv, valid, dout = _inputs(d + 1, d)
    # the truth: fp32 on the values the storage type holds
    held = torch.from_numpy(qkv).to(dtype).float().numpy()
    held_dout = torch.from_numpy(dout).to(dtype).float().numpy()
    t_out, t_g = _jax(held, valid, held_dout)
    j_out, j_g = _jax(qkv, valid, dout, JAX_DTYPES[dtype])
    out, g = _torch(qkv, valid, dout, dtype)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    for what, got, ref, truth in (("output", out[valid], j_out[valid], t_out[valid]),
                                  ("gradient", g, j_g, t_g)):
        floor = rel(ref, truth)
        assert floor > 1e-5, f"{what}: low-precision path not exercised"
        assert rel(got, truth) <= NOISE_FACTOR * floor, (what, rel(got, truth), floor)


def _fake_kernels(monkeypatch):
    """The kernels' C calls replaced by the plain version at the width the
    wrapper hands them, so the wrapper's pad, slice and autograd run on the
    CPU exactly as on a card."""
    def fwd(qkv, valid, k, h, scale, with_lse):
        out = tfwa.flash_window_attention_plain(qkv, valid, k, h, scale)
        lse = torch.zeros(*qkv.shape[:2], h) if with_lse else None
        return out, lse, tfwa.forward_variant(qkv.dtype, k, qkv.shape[-1] // h)

    def bwd(qkv, valid, out, lse, dout, k, h, scale):
        assert qkv.shape[-1] // h in tfwa.HEAD_DIMS and dout.shape[-1] == qkv.shape[-1]
        x = qkv.detach().requires_grad_(True)
        with torch.enable_grad():
            tfwa.flash_window_attention_plain(x, valid, k, h, scale).backward(dout)
        return x.grad, tfwa.backward_variant(qkv.dtype, k, qkv.shape[-1] // h)

    monkeypatch.setattr(tfwa, "_launch_fwd_kernel", fwd)
    monkeypatch.setattr(tfwa, "_launch_bwd", bwd)


@pytest.mark.parametrize("d", [1, 8, 24, 40, 56, 100, 127])
def test_wrapper_pad_and_slice_equal_the_unpadded_plain_version(d, monkeypatch):
    """A head width off the instantiated ones runs on the next one with
    zero lanes: the output, the log-sum-exp's caller and the gradients
    equal the plain version at the real width to fp32 rounding, the scale
    follows the real width, and the counters record the padded width."""
    _fake_kernels(monkeypatch)
    qkv, valid, dout = _inputs(d + 2, d, n=53)
    dp = tfwa.padded_head_dim(d)
    assert dp > d and dp in tfwa.HEAD_DIMS
    x = torch.from_numpy(qkv).requires_grad_(True)
    before = tfwa.flash_window_attention.width_launches.get(("fp32", "float32", dp), 0)
    padded = tfwa.flash_window_attention_bwd.padded_launches
    out = tfwa._FlashWindowAttention.apply(x, torch.from_numpy(valid), PATCH, HEADS, d ** -0.5)
    out.backward(torch.from_numpy(dout))
    ref_x = torch.from_numpy(qkv).requires_grad_(True)
    ref = tfwa.flash_window_attention_plain(ref_x, torch.from_numpy(valid), PATCH, HEADS)
    ref.backward(torch.from_numpy(dout))
    assert out.shape == ref.shape and x.grad.shape == ref_x.grad.shape
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), ref_x.grad.numpy(), rtol=1e-6, atol=1e-7)
    assert tfwa.flash_window_attention.width_launches[("fp32", "float32", dp)] == before + 1
    assert tfwa.flash_window_attention_bwd.padded_launches == padded + 1
    # the pad itself: zero lanes past D, and unpad its inverse
    p = tfwa.pad_heads(torch.from_numpy(qkv), HEADS, dp)
    lanes = p.view(*p.shape[:-1], HEADS, dp)
    assert (lanes[..., d:] == 0).all() and p.is_contiguous()
    assert torch.equal(tfwa.unpad_heads(p, HEADS, d), torch.from_numpy(qkv))


def _dispatch_text(variant, dp, table):
    """The line of the variant's source that launches width ``dp``."""
    return {"fp32": f"launch_f32<{dp}>", "bf16_small": f"launch_d<{dp}>",
            "bf16_tiled": f"launch_tiled<{dp}>", "bf16_large": f"launch<{dp}>",
            "fp32_bwd": f"launch_bwd_f32<{dp}>", "bf16_small_bwd": f"launch_small_d<{dp}>",
            "bf16_large_bwd": f"launch_large<{dp}>"}[variant + table]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_every_width_and_type_names_an_instantiated_kernel(dtype):
    """For every head width from 1 to 128, every storage type and windows on
    both sides of every threshold, forward_variant and backward_variant
    name a variant whose source dispatches the padded width (a case of its
    C entry's switch that launches that instance) and takes the type's
    code; widths above 128 raise."""
    dt = getattr(torch, dtype)
    code = tfwa._DTYPES[dt]
    for d in range(1, tfwa.MAX_HEAD_DIM + 1):
        dp = tfwa.padded_head_dim(d)
        assert dp >= d and dp % 16 == 0 and dp - d < 32
        for k in (1, 16, 48, 64, 65, 127, 128, 1024, 4096, 4097):
            for table, variants, pick in (("", tfwa.VARIANTS, tfwa.forward_variant),
                                          ("_bwd", tfwa.BWD_VARIANTS, tfwa.backward_variant)):
                variant = pick(dt, k, d)
                assert (variant == "fp32") == (dtype == "float32")
                source, entry = variants[variant]
                text = source.read_text()
                body = text[text.index(f'extern "C" int {entry}('):]
                body = body[:body.index("\n}\n")]
                case = body[body.index(f"case {dp}:"):]
                assert _dispatch_text(variant, dp, table) in case.split("case ")[1]
                if code:  # the type's code reaches the C entry
                    assert "dtype" in body
    for d in (129, 256):
        with pytest.raises(ValueError, match="128"):
            tfwa.forward_variant(dt, 48, d)
        with pytest.raises(ValueError, match="128"):
            tfwa.backward_variant(dt, 48, d)


@pytest.mark.parametrize("source", ["SOURCE", "SOURCE_SMALL", "SOURCE_LARGE", "SOURCE_BWD",
                                    "SOURCE_BWD_LARGE"])
def test_sources_instantiate_both_16_bit_types(source):
    """Each source's 16-bit kernels take bf16 and fp16 through one template:
    the .bf16 and the .f16 form of the tensor-core product (in the header
    every source includes), and a launcher that picks the type by the code
    the wrapper passes (1 bf16, 2 fp16)."""
    text = getattr(tfwa, source).read_text()
    common = (tfwa.CSRC / "fwa_common.cuh").read_text()
    assert '#include "fwa_common.cuh"' in text and "struct Elem<" not in text
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in common
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in common
    assert "if (dtype == 1)" in text and "if (dtype == 2)" in text


def test_library_name_hashes_the_included_header(tmp_path):
    """A library's name changes with the header its source includes, so an
    edited header rebuilds every library that includes it."""
    from scenesplat_tpu_torch.ops._build import KernelLibrary

    (tmp_path / "common.cuh").write_text("// one\n")
    (tmp_path / "kernel.cu").write_text('#include <stdint.h>\n#include "common.cuh"\n')
    lib = KernelLibrary(tmp_path / "kernel.cu", lambda _: None)
    before = lib.path().name
    (tmp_path / "common.cuh").write_text("// two\n")
    assert lib.path().name != before and lib.path().name.startswith("libkernel_")
    assert tfwa._DTYPES == {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def test_two_stage_ptv3_with_wide_heads_matches_jax():
    """A two-stage PT-v3m1 whose heads are 64 lanes wide in the first stage
    and 24 in the second and in the decoder (JAX weights carried through
    utils/weights.py:state_dict_from_flax) against the JAX model's forward,
    fp32, at the export bridge's bar."""
    from tests.test_full_model_golden import MINI
    from tests.test_torch_model import ATOL as M_ATOL, RTOL as M_RTOL
    from tests.test_torch_model import _case, _jax_forward, _torch_forward, _torch_model

    cfg = dict(MINI, enc_channels=(64, 48), enc_num_head=(1, 2), dec_channels=(48,),
               dec_num_head=(2,))
    heads = [c // h for c, h in zip(cfg["enc_channels"] + cfg["dec_channels"],
                                    cfg["enc_num_head"] + cfg["dec_num_head"])]
    assert heads == [64, 24, 24]
    case = _case(cfg, (0.5,), seed=11, pad=16)
    ref = _jax_forward(case)
    model = _torch_model(cfg, (0.5,), case["params"], case["stats"])
    got, out = _torch_forward(model, case["coord"], case["grid"], case["feat"], case["mask"])
    m = case["mask"]
    np.testing.assert_allclose(got[m], ref[m], rtol=M_RTOL, atol=M_ATOL)
    assert all(int(p.n_overflow.max()) == 0 for p in out.plans)
