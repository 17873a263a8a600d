"""Flash-window attention, forward and backward: the hand-written Hopper
kernels and their plain PyTorch version.

The forward kernel K1 (``csrc/flash_window_attn.cu``) replaces the TPU
kernel ``scenesplat_tpu/ops/pallas_attn.py:_fwd_kernel`` (entered through
``_fwa_fwd``), the backward K2 replaces ``_bwd_kernel`` (through
``_fwa_bwd``). Their work, 4*N*K*C (forward) and 10*N*K*C (backward)
operations against about 4*N*C and 9*N*C elements moved per call, makes
both bound by operations at windows of 1024 and by bytes at windows of 48
(the flagship config's decoder) on this card. The TPU kernels hold a whole [K, K]
fp32 score tile in VMEM (4 MB at K = 1024); a Hopper block has at most
227 KB of shared memory, so each block owns a tile of query (or key) rows
of one (batch, window, head) and streams the other side's rows through
shared memory: the forward keeps an online softmax in fp32 registers and,
when training, writes each row's log-sum-exp; the backward recomputes the
probabilities from it. Keys past the end of a ragged last window are
masked, and a window whose slot 0 is padding writes zeros. bf16 runs its
products on the tensor cores (mma.sync); fp32 runs scalar FMAs, which keeps
it exact to the plain version.

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

import torch
from torch.utils.checkpoint import checkpoint

from ._build import CSRC, KernelLibrary

SOURCE = CSRC / "flash_window_attn.cu"
# head widths the kernel is instantiated for: those of the flagship and the
# shipped configs (16 in every encoder stage and dec2, 32 in dec1, 48 in dec0)
HEAD_DIMS = (16, 32, 48)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    lib.fwa_fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_fwd.restype = ctypes.c_int
    lib.fwa_bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.fwa_bwd.restype = ctypes.c_int


LIBRARY = KernelLibrary(SOURCE, _declare)


def _check(qkv: torch.Tensor, valid: torch.Tensor, patch_size: int,
           num_heads: int):
    if qkv.dim() != 4 or qkv.shape[2] != 3:
        raise ValueError(f"qkv must be [B, N, 3, C], got {tuple(qkv.shape)}")
    b, n, _, c = qkv.shape
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} is not float32 or bfloat16")
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, n):
        raise ValueError(f"valid must be a bool [{b}, {n}] tensor")
    if valid.device != qkv.device:
        raise ValueError("qkv and valid must be on one device")
    if not (qkv.is_contiguous() and valid.is_contiguous()):
        raise ValueError("qkv and valid must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    if c % num_heads or c // num_heads not in HEAD_DIMS:
        raise ValueError(f"C={c} over {num_heads} heads: the head dim must be one "
                         f"of {HEAD_DIMS}")
    if patch_size <= 0:
        raise ValueError(f"patch_size must be positive, got {patch_size}")
    return b, n, c


def _launch_fwd(qkv, valid, patch_size, num_heads, scale, with_lse):
    """K1: out [B, N, C] and, with ``with_lse``, lse [B, N, H] fp32."""
    b, n, c = _check(qkv, valid, patch_size, num_heads)
    out = torch.empty(b, n, c, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(b, n, num_heads, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        rc = LIBRARY.load().fwa_fwd(
            qkv.data_ptr(), valid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPES[qkv.dtype],
            b, n, c, num_heads, patch_size, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash-window attention launch failed: CUDA error {rc}")
    flash_window_attention.launches += 1
    return out, lse


def flash_window_attention_bwd(qkv: torch.Tensor, valid: torch.Tensor,
                               out: torch.Tensor, lse: torch.Tensor,
                               dout: torch.Tensor, patch_size: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """K2: dqkv [B, N, 3, C] from the forward's inputs, its ``out`` and
    ``lse`` and the output gradient ``dout`` [B, N, C], all on one card.
    ``flash_window_attention_bwd.launches`` counts launches."""
    b, n, c = _check(qkv, valid, patch_size, num_heads)
    for name, t, shape, dtype in (("out", out, (b, n, c), qkv.dtype),
                                  ("dout", dout, (b, n, c), qkv.dtype),
                                  ("lse", lse, (b, n, num_heads), torch.float32)):
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != qkv.device:
            raise ValueError(f"{name} must be {dtype} {shape} on {qkv.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(b, n, num_heads, dtype=torch.float32, device=qkv.device)
    stream = torch.cuda.current_stream(qkv.device).cuda_stream
    with torch.cuda.device(qkv.device):
        rc = LIBRARY.load().fwa_bwd(
            qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), dqkv.data_ptr(), delta.data_ptr(), _DTYPES[qkv.dtype],
            b, n, c, num_heads, patch_size, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"flash-window attention backward launch failed: CUDA error {rc}")
    flash_window_attention_bwd.launches += 1
    return dqkv


flash_window_attention_bwd.launches = 0


class _FlashWindowAttention(torch.autograd.Function):
    """K1 forward, K2 backward. Saves qkv, valid, the output and the
    log-sum-exp (the TPU kernel's custom_vjp saves qkv and valid only and
    recomputes the row maxima and sums)."""

    @staticmethod
    def forward(ctx, qkv, valid, patch_size, num_heads, scale):
        out, lse = _launch_fwd(qkv, valid, patch_size, num_heads, scale, True)
        ctx.save_for_backward(qkv, valid, out, lse)
        ctx.args = (patch_size, num_heads, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, valid, out, lse = ctx.saved_tensors
        dout = dout.to(qkv.dtype).contiguous()
        dqkv = flash_window_attention_bwd(qkv, valid, out, lse, dout, *ctx.args)
        return dqkv, None, None, None, None


def flash_window_attention(qkv: torch.Tensor, valid: torch.Tensor,
                           patch_size: int, num_heads: int,
                           scale: float | None = None) -> torch.Tensor:
    """qkv [B, N, 3, C] (float32 or bfloat16), valid [B, N] bool ->
    [B, N, C]. Launches the kernels for CUDA tensors (K1, and K2 in the
    backward when qkv requires grad); CPU tensors take the plain version.
    ``flash_window_attention.launches`` counts K1 launches."""
    if not qkv.is_cuda:
        return flash_window_attention_plain(qkv, valid, patch_size, num_heads, scale)
    if scale is None:
        scale = (qkv.shape[-1] // num_heads) ** -0.5
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashWindowAttention.apply(qkv, valid, patch_size, num_heads, float(scale))
    return _launch_fwd(qkv, valid, patch_size, num_heads, scale, False)[0]


flash_window_attention.launches = 0


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
