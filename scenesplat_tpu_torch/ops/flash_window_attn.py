"""Flash-window attention, forward and backward: the hand-written Hopper
kernels and their plain PyTorch version.

The forward kernel K1 replaces the TPU kernel
``scenesplat_tpu/ops/pallas_attn.py:_fwd_kernel`` (entered through
``_fwa_fwd``), the backward K2 (``csrc/flash_window_attn.cu`` for fp32,
``csrc/flash_window_attn_bwd.cu`` and ``_bwd_large.cu`` for bf16 and fp16)
replaces ``_bwd_kernel``
(through ``_fwa_bwd``). Their work, 4*N*K*C (forward) and 10*N*K*C
(backward) operations against about 4*N*C and 7*N*C elements moved per
call, makes both bound by operations at windows of 1024 and by bytes at
windows of 48 (the flagship config's decoder) on this card. The TPU kernels
hold a whole [K, K] fp32 score tile in VMEM (4 MB at K = 1024); a Hopper
block has at most 227 KB of shared memory, so at large windows each block
owns a tile of query (or key) rows of one (batch, window, head) and streams
the other side's rows through shared memory: the forward keeps an online
softmax in fp32 registers and, when training, writes each row's
log-sum-exp; the backward recomputes the probabilities from it. Keys past
the end of a ragged last window are masked, and a window whose slot 0 is
padding writes zeros. bf16 runs its products on the tensor cores
(mma.sync); fp16 takes the bf16 variants through the same code with the
``.f16`` form of the products; fp32 runs scalar FMAs, which keeps it exact
to the plain version. The forward has four variants, chosen by
``forward_variant`` from the storage type and the window: fp32
(``csrc/flash_window_attn.cu``); bf16 or fp16
at windows of at most ``FWD_SMALL_MAX`` = 64 slots, ``bf16_small``
(``csrc/flash_window_attn_fwd_small.cu``, a source and a library of its
own: one pass per window and head in persistent blocks of K/16 warps, the
whole window in shared memory, the next unit's rows loaded by cp.async
under this one's products, the softmax over the whole window at once);
bf16 at windows of 128 to 4096, ``bf16_large``
(``csrc/flash_window_attn_fwd.cu``: bound by operations, 128 query rows a
block, key and value tiles through a three-stage cp.async ring and
ldmatrix, the softmax in the exp2 domain, key tiles of padding skipped);
and bf16 at the windows neither takes (65 to 127, above 4096),
``bf16_tiled`` (``csrc/flash_window_attn.cu``: 64 query rows a block,
synchronous tile loads, an online softmax). The backward has three, chosen
by ``backward_variant``: fp32; bf16 at windows of at most 64 slots (one
pass per window and head, as the small forward); bf16 at larger windows (a
dQ kernel and a dK/dV kernel). The C functions refuse what they were not
built for and the wrapper raises: no variant stands in for another.

Head widths. Every kernel is instantiated for D in ``HEAD_DIMS`` = 16, 32,
48, 64, 96 and 128, the multiples of 16 that the m16n8k16 products tile.
Any other width from 1 to ``MAX_HEAD_DIM`` = 128 runs on the next of them
(``padded_head_dim``) with its lanes past D zero, as the JAX package's
``_head_pad_dim`` pads: the wrapper copies qkv (and, in the backward, O and
dO) into a zero [B, N, 3, H, Dp] buffer and slices the output and dqkv
back. That is exact: the zero lanes add nothing to S, lse is unchanged, the
extra lanes of O, dQ, dK and dV are dropped, and the scale stays
D ** -0.5. A wider head, or a storage type other than fp32, bf16 and fp16,
raises.

``flash_window_attention`` is differentiable: while grad is enabled and qkv
requires grad it runs as a ``torch.autograd.Function`` whose forward
launches K1 (with the log-sum-exp) and whose backward launches K2; otherwise
it launches K1 alone. The kernels are built at first use with ``nvcc`` into
``build/kernels/`` at the root of the checkout, from this package's sources
only, and bound through plain C functions with ``ctypes``. The wrappers
launch them for CUDA tensors and use the plain version (and autograd
through it) for CPU tensors; nothing falls back. ``ops/_build.py`` holds
the build and binding code the port's kernels share.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.checkpoint import checkpoint

from ._build import CSRC, KernelLibrary

SOURCE = CSRC / "flash_window_attn.cu"
SOURCE_SMALL = CSRC / "flash_window_attn_fwd_small.cu"
SOURCE_LARGE = CSRC / "flash_window_attn_fwd.cu"
SOURCE_BWD = CSRC / "flash_window_attn_bwd.cu"
SOURCE_BWD_LARGE = CSRC / "flash_window_attn_bwd_large.cu"
# head widths every kernel is instantiated for: the shipped configs' 16, 32
# and 48 and the multiples of 16 up to 128 that a user's PT-v3m1 may give;
# any other width up to MAX_HEAD_DIM runs zero-padded on the next of them
HEAD_DIMS = (16, 32, 48, 64, 96, 128)
MAX_HEAD_DIM = HEAD_DIMS[-1]
# the storage types and their code in the C functions; fp16 takes the bf16
# variants' kernels with the .f16 products
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# bf16 windows of at most this many slots take the one-pass forward (four
# m16 tiles: the whole window's rows in shared memory)
FWD_SMALL_MAX = 64
# bf16 windows of this many slots go to the large-window forward: from here
# on a call is bound by operations (see forward_variant)
LARGE_WINDOW_MIN = 128
LARGE_WINDOW_MAX = 4096  # 64 key tiles of 64: what that kernel's tile list holds
# variant -> (source, C function): what the sources instantiate
VARIANTS = {"fp32": (SOURCE, "fwa_fwd"), "bf16_small": (SOURCE_SMALL, "fwa_fwd_small"),
            "bf16_tiled": (SOURCE, "fwa_fwd"), "bf16_large": (SOURCE_LARGE, "fwa_fwd_large")}
# The orders in which the one-pass forward's persistent blocks walk the
# (batch, window, head) units, by the C function's ``chunk`` argument (see
# small_unit_order): "H" a contiguous share a block (0), "A" single units
# dealt in turn (1), "A2", "A4" and "A8" runs of 2, 4 and 8 heads, "C" runs
# of a window's heads (None: the head count). tools/torch_kernel_bench.py
# times each; PERF.md has what they gave.
SMALL_UNIT_ORDERS = {"H": 0, "A": 1, "A2": 2, "A4": 4, "A8": 8, "C": None}
FWD_SMALL_ORDER = "A2"
# bf16 backward windows of at most this many slots take the one-pass kernel
# (four m16 tiles: the whole window's rows in shared memory)
BWD_SMALL_MAX = 64
BWD_VARIANTS = {"fp32": (SOURCE, "fwa_bwd"), "bf16_small": (SOURCE_BWD, "fwa_bwd_small"),
                "bf16_large": (SOURCE_BWD_LARGE, "fwa_bwd_large")}


# Every C entry takes the storage type's code (_DTYPES) after its pointers,
# the fp32 backward excepted (fp32 only)
def _declare(lib: ctypes.CDLL) -> None:
    lib.fwa_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_fwd.restype = ctypes.c_int
    lib.fwa_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_bwd.restype = ctypes.c_int


def _declare_small(lib: ctypes.CDLL) -> None:
    lib.fwa_fwd_small.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.fwa_fwd_small.restype = ctypes.c_int
    lib.fwa_fwd_small_residency.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fwa_fwd_small_residency.restype = ctypes.c_int


def _declare_large(lib: ctypes.CDLL) -> None:
    lib.fwa_fwd_large.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_fwd_large.restype = ctypes.c_int


def _declare_bwd(lib: ctypes.CDLL) -> None:
    lib.fwa_bwd_small.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_bwd_small.restype = ctypes.c_int
    lib.fwa_bwd_small_residency.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fwa_bwd_small_residency.restype = ctypes.c_int


def _declare_bwd_large(lib: ctypes.CDLL) -> None:
    lib.fwa_bwd_large.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_bwd_large.restype = ctypes.c_int


LIBRARY = KernelLibrary(SOURCE, _declare)
LIBRARY_SMALL = KernelLibrary(SOURCE_SMALL, _declare_small)
LIBRARY_LARGE = KernelLibrary(SOURCE_LARGE, _declare_large)
LIBRARY_BWD = KernelLibrary(SOURCE_BWD, _declare_bwd)
LIBRARY_BWD_LARGE = KernelLibrary(SOURCE_BWD_LARGE, _declare_bwd_large)


def padded_head_dim(head_dim: int) -> int:
    """The instantiated width a head of ``head_dim`` lanes runs on: the
    least of ``HEAD_DIMS`` that holds it. Raises for a width below 1 or
    above ``MAX_HEAD_DIM``."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {head_dim}: the kernels take head widths of 1 to "
                         f"{MAX_HEAD_DIM}")
    return next(d for d in HEAD_DIMS if d >= head_dim)


def _check_dtype(dtype: torch.dtype) -> None:
    if dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {dtype} is not float32, bfloat16 or float16")


def forward_variant(dtype: torch.dtype, patch_size: int, head_dim: int) -> str:
    """Which forward kernel a call takes, a key of ``VARIANTS``: ``"fp32"``
    for float32; for bfloat16 and float16 ``"bf16_small"`` at windows of at
    most ``FWD_SMALL_MAX`` slots, ``"bf16_large"`` at windows of
    ``LARGE_WINDOW_MIN`` to ``LARGE_WINDOW_MAX`` slots and ``"bf16_tiled"``
    at the others, each at ``padded_head_dim(head_dim)``. Raises for a
    storage type or a head width without a kernel."""
    _check_dtype(dtype)
    padded_head_dim(head_dim)
    if patch_size <= 0:
        raise ValueError(f"patch_size must be positive, got {patch_size}")
    if dtype == torch.float32:
        return "fp32"
    if patch_size <= FWD_SMALL_MAX:
        return "bf16_small"
    large = LARGE_WINDOW_MIN <= patch_size <= LARGE_WINDOW_MAX
    return "bf16_large" if large else "bf16_tiled"


def small_chunk(order: str, heads: int) -> int:
    """The C function's ``chunk`` argument for unit order ``order`` (a key
    of SMALL_UNIT_ORDERS) at ``heads`` heads."""
    if order not in SMALL_UNIT_ORDERS:
        raise ValueError(f"unit order {order!r} is not one of {tuple(SMALL_UNIT_ORDERS)}")
    chunk = SMALL_UNIT_ORDERS[order]
    return heads if chunk is None else chunk


def small_unit_order(units: int, grid: int, chunk: int) -> list:
    """The units each of ``grid`` persistent blocks of the one-pass forward
    walks (a list per block), as the kernel's ``walk_of`` computes them.
    Unit u is head u % H of window u // H. Runs of ``chunk`` consecutive
    units are dealt to the blocks in turn, block b taking runs b, b + grid,
    ...; with ``chunk`` 0 block b takes the contiguous units [b * units //
    grid, (b + 1) * units // grid)."""
    if chunk == 0:
        return [list(range(b * units // grid, (b + 1) * units // grid)) for b in range(grid)]
    chunks = -(-units // chunk)
    return [[u for j in range(b, chunks, grid)
             for u in range(j * chunk, min(units, (j + 1) * chunk))] for b in range(grid)]


def backward_variant(dtype: torch.dtype, patch_size: int, head_dim: int) -> str:
    """Which backward kernel a call takes, a key of ``BWD_VARIANTS``:
    ``"fp32"`` for float32; for bfloat16 and float16 ``"bf16_small"`` at
    windows of at most ``BWD_SMALL_MAX`` slots and ``"bf16_large"`` above,
    each at ``padded_head_dim(head_dim)``. Raises for a storage type or a
    head width without a kernel."""
    _check_dtype(dtype)
    padded_head_dim(head_dim)
    if patch_size <= 0:
        raise ValueError(f"patch_size must be positive, got {patch_size}")
    if dtype == torch.float32:
        return "fp32"
    return "bf16_small" if patch_size <= BWD_SMALL_MAX else "bf16_large"


def _check(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int,
           num_heads: int):
    if qkv.dim() != 4 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, N, 3, C], got {tuple(qkv.shape)}")
    b, n, _, c = qkv.shape
    _check_dtype(qkv.dtype)
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, n):
        raise ValueError(f"valid must be a bool [{b}, {n}] tensor")
    if valid.device != qkv.device:
        raise ValueError("qkv and valid must be on one device")
    if not (qkv.is_contiguous() and valid.is_contiguous()):
        raise ValueError("qkv and valid must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    if c % num_heads:
        raise ValueError(f"C={c} does not split over {num_heads} heads")
    padded_head_dim(c // num_heads)
    if patch_size <= 0:
        raise ValueError(f"patch_size must be positive, got {patch_size}")
    return b, n, c


def pad_heads(x: torch.Tensor, num_heads: int, dp: int) -> torch.Tensor:
    """x [..., H * D] -> a new contiguous [..., H * dp], each head's lanes
    past D zero (qkv [B, N, 3, C], O and dO [B, N, C])."""
    d = x.shape[-1] // num_heads
    x = x.reshape(*x.shape[:-1], num_heads, d)
    return torch.nn.functional.pad(x, (0, dp - d)).reshape(*x.shape[:-2], num_heads * dp)


def unpad_heads(x: torch.Tensor, num_heads: int, d: int) -> torch.Tensor:
    """The inverse of pad_heads: x [..., H * dp] -> contiguous [..., H * d]."""
    x = x.reshape(*x.shape[:-1], num_heads, x.shape[-1] // num_heads)
    return x[..., :d].reshape(*x.shape[:-2], num_heads * d)


class _Counted:
    """A kernel's wrapper and its launch counter: ``width_launches`` maps
    (variant, storage type, instantiated width) to launches and
    ``padded_launches`` counts those whose heads the wrapper padded;
    ``launches`` and ``variant_launches`` are sums of ``width_launches``.
    With ``lse``, ``lse_variant_launches`` counts each variant's launches
    that also wrote the log-sum-exp."""

    def __init__(self, fn, variants, lse=False):
        functools.update_wrapper(self, fn)
        self._fn, self._variants = fn, variants
        self.width_launches, self.padded_launches = {}, 0
        self.lse_variant_launches = dict.fromkeys(variants, 0) if lse else None

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    @property
    def launches(self) -> int:
        return sum(self.width_launches.values())

    @property
    def variant_launches(self) -> dict:
        counts = dict.fromkeys(self._variants, 0)
        for (variant, _, _), n in self.width_launches.items():
            counts[variant] += n
        return counts

    def count(self, variant, dtype, dp, padded, lse=False):
        key = (variant, str(dtype).removeprefix("torch."), dp)
        self.width_launches[key] = self.width_launches.get(key, 0) + 1
        self.padded_launches += padded
        if lse:
            self.lse_variant_launches[variant] += 1

    def reset(self):
        self.width_launches.clear()
        self.padded_launches = 0
        if self.lse_variant_launches is not None:
            self.lse_variant_launches.update(dict.fromkeys(self._variants, 0))


def _launch_fwd_kernel(qkv, valid, patch_size, num_heads, scale, with_lse):
    """K1 on qkv at an instantiated head width: out [B, N, C], with
    ``with_lse`` lse [B, N, H] fp32 (else None), and the variant."""
    b, n, c = qkv.shape[0], qkv.shape[1], qkv.shape[3]
    out = torch.empty(b, n, c, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(b, n, num_heads, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    variant = forward_variant(qkv.dtype, patch_size, c // num_heads)
    code = _DTYPES[qkv.dtype]
    ptrs = (qkv.data_ptr(), valid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr())
    with torch.cuda.device(qkv.device):
        if variant == "bf16_small":
            rc = LIBRARY_SMALL.load().fwa_fwd_small(
                *ptrs, code, b, n, c, num_heads, patch_size, float(scale),
                small_chunk(FWD_SMALL_ORDER, num_heads), stream)
        elif variant == "bf16_large":
            rc = LIBRARY_LARGE.load().fwa_fwd_large(
                *ptrs, code, b, n, c, num_heads, patch_size, float(scale), stream)
        else:
            rc = LIBRARY.load().fwa_fwd(
                *ptrs, code, b, n, c, num_heads, patch_size, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash-window attention ({variant}) launch failed: "
                           f"CUDA error {rc}")
    return out, lse, variant


def _forward(qkv, valid, patch_size, num_heads, scale, with_lse):
    """K1 at any head width up to MAX_HEAD_DIM: (out, lse, the qkv and out
    the kernel saw, padded where the width was)."""
    c = _check(qkv, valid, patch_size, num_heads)[2]
    d = c // num_heads
    dp = padded_head_dim(d)
    qkv_k = qkv if dp == d else pad_heads(qkv, num_heads, dp)
    out_k, lse, variant = _launch_fwd_kernel(qkv_k, valid, patch_size, num_heads, scale,
                                             with_lse)
    flash_window_attention.count(variant, qkv.dtype, dp, dp != d, with_lse)
    out = out_k if dp == d else unpad_heads(out_k, num_heads, d)
    return out, lse, qkv_k, out_k


def _launch_bwd(qkv, valid, out, lse, dout, patch_size, num_heads, scale):
    """K2 on tensors at an instantiated head width: dqkv [B, N, 3, C]."""
    b, n, c = qkv.shape[0], qkv.shape[1], qkv.shape[3]
    dqkv = torch.empty_like(qkv)
    variant = backward_variant(qkv.dtype, patch_size, c // num_heads)
    code = _DTYPES[qkv.dtype]
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    dims = (b, n, c, num_heads, patch_size, float(scale), stream)
    with torch.cuda.device(qkv.device):
        if variant == "bf16_small":  # delta = rowsum(dP * P) in the kernel: no O read
            rc = LIBRARY_BWD.load().fwa_bwd_small(
                qkv.data_ptr(), valid.data_ptr(), lse.data_ptr(), dout.data_ptr(),
                dqkv.data_ptr(), code, *dims)
        else:
            delta = torch.empty(b, n, num_heads, dtype=torch.float32, device=qkv.device)
            ptrs = (qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    dout.data_ptr(), dqkv.data_ptr(), delta.data_ptr())
            if variant == "fp32":
                rc = LIBRARY.load().fwa_bwd(*ptrs, *dims)
            else:
                rc = LIBRARY_BWD_LARGE.load().fwa_bwd_large(*ptrs, code, *dims)
    if rc != 0:
        raise RuntimeError(f"flash-window attention backward ({variant}) launch failed: "
                           f"CUDA error {rc}")
    return dqkv, variant


def flash_window_attention_bwd(qkv: torch.Tensor, valid: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, patch_size: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K2: dqkv [B, N, 3, C] from the forward's inputs, its ``out`` and
    ``lse`` and the output gradient ``dout`` [B, N, C], all on one card, at
    any head width up to MAX_HEAD_DIM (padded as the forward pads).
    ``flash_window_attention_bwd.launches`` counts launches,
    ``.variant_launches`` those of each variant, ``.width_launches`` those
    of each (variant, storage type, instantiated width) and
    ``.padded_launches`` those whose heads the wrapper padded."""
    b, n, c = _check(qkv, valid, patch_size, num_heads)
    for name, t, shape, dtype in (("out", out, (b, n, c), qkv.dtype),
                                  ("dout", dout, (b, n, c), qkv.dtype),
                                  ("lse", lse, (b, n, num_heads), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {dtype} {shape} on {qkv.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    d = c // num_heads
    dp = padded_head_dim(d)
    if dp != d:
        qkv, out = (pad_heads(t, num_heads, dp) for t in (qkv, out))
    return _backward(qkv, valid, out, lse, dout, patch_size, num_heads, scale, d)


def _backward(qkv, valid, out, lse, dout, patch_size, num_heads, scale, head_dim):
    """K2, counted, on qkv and out at an instantiated width (the forward's
    padded copies where ``head_dim`` is not one) and dout at ``head_dim``
    lanes: dqkv at ``head_dim`` lanes."""
    dp = qkv.shape[-1] // num_heads
    if dp != head_dim:
        dout = pad_heads(dout, num_heads, dp)
    dqkv, variant = _launch_bwd(qkv, valid, out, lse, dout, patch_size, num_heads, scale)
    flash_window_attention_bwd.count(variant, qkv.dtype, dp, dp != head_dim)
    return dqkv if dp == head_dim else unpad_heads(dqkv, num_heads, head_dim)


flash_window_attention_bwd = _Counted(flash_window_attention_bwd, BWD_VARIANTS)


class _FlashWindowAttention(torch.autograd.Function):
    """K1 forward, K2 backward. Saves qkv, valid, the output and the
    log-sum-exp (the TPU kernel's custom_vjp saves qkv and valid only and
    recomputes the row maxima and sums); at a padded head width the padded
    qkv and output, so the backward pads only dO."""

    @staticmethod
    def forward(ctx, qkv, valid, patch_size, num_heads, scale):
        out, lse, qkv_k, out_k = _forward(qkv, valid, patch_size, num_heads, scale, True)
        ctx.save_for_backward(qkv_k, valid, out_k, lse)
        ctx.args = (patch_size, num_heads, scale)
        ctx.head_dim = qkv.shape[-1] // num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, valid, out, lse = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()
        dqkv = _backward(qkv, valid, out, lse, dout, *ctx.args, ctx.head_dim)
        return dqkv, None, None, None, None


def flash_window_attention(qkv: torch.Tensor, valid: torch.Tensor,
                           patch_size: int, num_heads: int,
                           scale: float | None = None) -> torch.Tensor:
    """qkv [B, N, 3, C] (float32, bfloat16 or float16; C / num_heads from 1
    to MAX_HEAD_DIM), valid [B, N] bool -> [B, N, C]. Launches the kernels
    for CUDA tensors (K1, and K2 in the backward when qkv requires grad);
    CPU tensors take the plain version. ``flash_window_attention.launches``
    counts K1 launches, ``.variant_launches`` those of each variant,
    ``.lse_variant_launches`` those that also wrote the log-sum-exp (the
    forwards that record a graph), ``.width_launches`` those of each
    (variant, storage type, instantiated width) and ``.padded_launches``
    those whose heads the wrapper padded."""
    if not qkv.is_cuda:
        return flash_window_attention_plain(qkv, valid, patch_size, num_heads, scale)
    if scale is None:
        scale = (qkv.shape[-1] // num_heads) ** -0.5
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashWindowAttention.apply(qkv, valid, patch_size, num_heads, float(scale))
    return _forward(qkv, valid, patch_size, num_heads, scale, False)[0]


flash_window_attention = _Counted(flash_window_attention, VARIANTS, lse=True)


def reset_counts() -> None:
    """Every launch counter of K1 and K2 to 0."""
    flash_window_attention.reset()
    flash_window_attention_bwd.reset()


def _plain_chunk(qkv, valid, scale):
    """Masked-exp attention of whole windows: qkv [B, P, K, 3, H, D], valid
    [B, P, 1, 1, K] -> [B, P, K, H, D]."""
    blk = qkv.permute(3, 0, 1, 4, 2, 5)  # [3, B, P, H, K, D]
    q = (blk[0] * scale).float()  # the product rounds to the storage dtype
    kk, v = blk[1].float(), blk[2].float()
    scores = q @ kk.transpose(-1, -2)
    mx = torch.where(valid, scores, float("-inf")).amax(-1, keepdim=True)
    mx = mx.clamp(min=-1e30)  # rows without valid keys: finite shift
    e = torch.where(valid, torch.exp((scores - mx).clamp(max=0.0)), 0.0)
    attn = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    o = attn.to(qkv.dtype).float() @ v
    return o.to(qkv.dtype).transpose(2, 3)


def flash_window_attention_plain(qkv: torch.Tensor, valid: torch.Tensor,
                                 patch_size: int, num_heads: int,
                                 scale: float | None = None,
                                 patch_chunk: int = 8) -> torch.Tensor:
    """The plain version: masked-exp window attention over contiguous
    windows of ``patch_size`` slots, ``patch_chunk`` windows at a time so
    the score tensor stays bounded.

    Scores are (q * scale rounded to the storage dtype) . k in fp32; the
    softmax runs in fp32 with weight 0 on invalid keys (a row without valid
    keys gives zeros); P is cast to the storage dtype and P . V accumulates
    in fp32. When N % patch_size != 0 the last window is ragged: its missing
    slots are invalid keys whose rows are not returned, which equals the
    JAX function on the input padded with invalid slots to a whole window.
    It is differentiable; when it records a graph, each chunk is recomputed
    in the backward (``torch.utils.checkpoint``) instead of keeping its
    [K, K] score tensors, which at a window of 1024 would hold gigabytes per
    block.
    """
    b, n, three, c = qkv.shape
    if three != 3 or c % num_heads:
        raise ValueError(f"bad qkv shape {tuple(qkv.shape)} for {num_heads} heads")
    h, d, k = num_heads, c // num_heads, patch_size
    if scale is None:
        scale = d ** -0.5
    p = -(-n // k)
    pad = p * k - n
    if pad:
        qkv = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
    qkv = qkv.view(b, p, k, 3, h, d)
    valid = valid.view(b, p, 1, 1, k)
    recompute = torch.is_grad_enabled() and qkv.requires_grad
    outs = []
    for s in range(0, p, patch_chunk):
        args = (qkv[:, s:s + patch_chunk], valid[:, s:s + patch_chunk], scale)
        outs.append(checkpoint(_plain_chunk, *args, use_reentrant=False)
                    if recompute else _plain_chunk(*args))
    return torch.cat(outs, dim=1).reshape(b, p * k, c)[:, :n]
