"""Serialized window (patch) attention (counterpart of
``scenesplat_tpu/ops/window_attention.py``).

Block-diagonal attention over contiguous windows of the curve-sorted
sequence with a key-validity mask. ``window_attention`` dispatches to the
flash-window kernel (ops/flash_window_attn.py) or to its plain version.
Unlike the JAX package, every window size is valid: when N is not a
multiple of the window, the last window is ragged. ``window_attention_rpe``
adds PTv3's relative-position bias; it is plain torch, as the JAX package
and the reference run it (their RPE path is the dense one, never the flash
kernel).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .flash_window_attn import flash_window_attention, flash_window_attention_plain

window_attention_reference = flash_window_attention_plain


def window_attention(qkv_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                     patch_size: int, num_heads: int,
                     scale: Optional[float] = None,
                     use_kernel: Optional[bool] = None) -> torch.Tensor:
    """qkv_sorted [B, N, 3, C] in curve order, valid_sorted [B, N] bool ->
    [B, N, C].

    ``use_kernel``: None runs the kernel on CUDA tensors and the plain
    version on CPU tensors; False runs the plain version; True runs the
    kernel and raises for CPU tensors. The kernels take fp32, bf16 and fp16
    at any head width C / H from 1 to 128 (widths off 16, 32, 48, 64, 96
    and 128 zero-padded to the next of them); a CUDA call at another width
    or type raises rather than falling back."""
    if use_kernel is False:
        return window_attention_reference(qkv_sorted, valid_sorted, patch_size,
                                          num_heads, scale)
    if use_kernel and not qkv_sorted.is_cuda:
        raise ValueError("use_kernel=True needs CUDA tensors")
    return flash_window_attention(qkv_sorted, valid_sorted, patch_size,
                                  num_heads, scale)


def rank_windows(n: int, patch_size: int, parts: int, index: int):
    """[lo, hi) of the sorted positions of part ``index`` of the ceil(n /
    patch_size) windows of a row cut into ``parts`` contiguous blocks of
    whole windows (context parallel: a window never straddles two ranks;
    with fewer windows than parts the last parts are empty)."""
    windows = -(-n // patch_size)
    per = -(-windows // parts)
    lo = min(index * per, windows) * patch_size
    return min(lo, n), min(lo + per * patch_size, n)


def rpe_pos_bnd(patch_size: int) -> int:
    """PTv3's clip of relative grid coordinates for a window of
    ``patch_size`` (the reference's RPE.pos_bnd)."""
    return int((4 * patch_size) ** (1 / 3) * 2)


def _rpe_chunk(qkv, valid, grid, table, scale, pos_bnd):
    """Whole windows with the bias: qkv [B, P, K, 3, H, D], valid [B, P, 1,
    1, K], grid [B, P, K, 3], table [3 * rpe_num, H] -> [B, P, K, H, D].
    The plain version's masked-exp softmax (a row without valid keys gives
    zeros) with the three axes' table rows added to the fp32 scores."""
    blk = qkv.permute(3, 0, 1, 4, 2, 5)  # [3, B, P, H, K, D]
    q = (blk[0] * scale).float()  # the product rounds to the storage dtype
    kk, v = blk[1].float(), blk[2].float()
    scores = q @ kk.transpose(-1, -2)  # [B, P, H, K, K]
    rpe_num = 2 * pos_bnd + 1
    for axis in range(3):  # [B, P, K, K, H] per axis, summed into the scores
        g = grid[..., axis]
        rel = (g[:, :, :, None] - g[:, :, None, :]).clamp(-pos_bnd, pos_bnd) + pos_bnd
        bias = F.embedding(rel, table[axis * rpe_num:(axis + 1) * rpe_num])
        scores = scores + bias.permute(0, 1, 4, 2, 3).float()
    mx = torch.where(valid, scores, float("-inf")).amax(-1, keepdim=True)
    mx = mx.clamp(min=-1e30)  # rows without valid keys: finite shift
    e = torch.where(valid, torch.exp((scores - mx).clamp(max=0.0)), 0.0)
    attn = e / e.sum(-1, keepdim=True).clamp(min=1e-30)
    o = attn.to(qkv.dtype).float() @ v
    return o.to(qkv.dtype).transpose(2, 3)


def window_attention_rpe(qkv_sorted: torch.Tensor, valid_sorted: torch.Tensor,
                         grid_sorted: torch.Tensor, rpe_table: torch.Tensor,
                         patch_size: int, num_heads: int, scale: Optional[float] = None,
                         chunk_elems: int = 1 << 26) -> torch.Tensor:
    """Window attention with PTv3's relative-position bias (counterpart of
    ``scenesplat_tpu/ops/window_attention.py:window_attention_rpe``):
    qkv_sorted [B, N, 3, C] and grid_sorted [B, N, 3] (integer grid
    coordinates) in curve order, valid_sorted [B, N] bool, rpe_table
    [3 * (2 * pos_bnd + 1), H] with pos_bnd = ``rpe_pos_bnd(patch_size)``
    -> [B, N, C]. The relative grid coordinates of a window's (query, key)
    pairs, query minus key, clipped to +-pos_bnd, pick one table row per
    axis; their sum is added to the fp32 scores.

    Windows run in chunks of at most ``chunk_elems`` score elements, so
    memory stays bounded at windows of 1024; with a graph to record, each
    chunk is recomputed in the backward. As in the plain version the last
    window may be ragged (its missing slots are invalid keys whose rows are
    not returned), and a row without valid keys gives zeros, where the JAX
    function gives the mean of the window's values; the two agree on every
    row of a window that holds a valid key."""
    b, n, three, c = qkv_sorted.shape
    if three != 3 or c % num_heads:
        raise ValueError(f"bad qkv shape {tuple(qkv_sorted.shape)} for {num_heads} heads")
    h, d, k = num_heads, c // num_heads, patch_size
    pos_bnd = rpe_pos_bnd(k)
    if rpe_table.shape != (3 * (2 * pos_bnd + 1), h):
        raise ValueError(f"rpe_table {tuple(rpe_table.shape)} for windows of {k} and {h} heads")
    if scale is None:
        scale = d ** -0.5
    p = -(-n // k)
    pad = p * k - n
    qkv, valid, grid = qkv_sorted, valid_sorted, grid_sorted.long()
    if pad:
        qkv = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
        grid = torch.cat([grid, grid.new_zeros(b, pad, 3)], dim=1)
    qkv = qkv.view(b, p, k, 3, h, d)
    valid = valid.view(b, p, 1, 1, k)
    grid = grid.view(b, p, k, 3)
    chunk = max(1, chunk_elems // (b * h * k * k))
    recompute = torch.is_grad_enabled() and (qkv.requires_grad or rpe_table.requires_grad)
    outs = []
    for s in range(0, p, chunk):
        args = (qkv[:, s:s + chunk], valid[:, s:s + chunk], grid[:, s:s + chunk], rpe_table,
                scale, pos_bnd)
        outs.append(checkpoint(_rpe_chunk, *args, use_reentrant=False)
                    if recompute else _rpe_chunk(*args))
    return torch.cat(outs, dim=1).reshape(b, p * k, c)[:, :n]
