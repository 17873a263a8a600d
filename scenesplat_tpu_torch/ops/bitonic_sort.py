"""Row sort: the hand-written Hopper bitonic sort K3, its plain PyTorch
version, and the switch that puts it behind the port's sort sites.

K3 (``csrc/bitonic_sort.cu``) replaces the TPU kernel
``scenesplat_tpu/ops/pallas_sort.py:_sort_kernel`` (entered through
``_sort_rows``): an unstable bitonic sort of each row of ``[B, n]`` 32-bit
operands, lexicographic over the first ``num_keys`` operands compared as
unsigned values, the other operands carried as payload. Rows are padded to
a power of two (at least 1024) with keys ``0xFFFFFFFF`` and payload 0, as the
TPU wrapper pads them, so kernel, plain version and TPU kernel run one
deterministic network and agree element for element. The work is bound by
bytes (each operand read and written once); see the source for how the
network is split between shared and device memory.

``bitonic_sort`` launches the kernel for CUDA tensors and runs the plain
version ``bitonic_sort_reference`` for CPU tensors; nothing falls back.
``sort_int64`` is the drop-in the sort sites call (what
``pallas_sort.sort_rows`` is to the TPU kernel): one ``torch.sort`` of the
int64 codes unless ``SCENESPLAT_BITONIC_SORT=1``, read on every call. With
the switch on, a code travels through ``bitonic_sort`` as its (high, low)
32-bit halves with the element index as the last key, so the order is the
stable ``torch.sort``'s exactly.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch

from ._build import CSRC, KernelLibrary

SOURCE = CSRC / "bitonic_sort.cu"
ENV_SWITCH = "SCENESPLAT_BITONIC_SORT"
MIN_ROW = 1024  # rows are padded to a power of two, at least this
MAX_ROW = 1 << 24
MAX_OPERANDS = 4
KERNEL_OPERANDS = (2, 3)  # the operand counts the CUDA source instantiates
_PAD_KEY = -1  # the int32 bit pattern 0xFFFFFFFF


def _declare(lib: ctypes.CDLL) -> None:
    lib.bitonic_sort_rows.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                      + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.bitonic_sort_rows.restype = ctypes.c_int


LIBRARY = KernelLibrary(SOURCE, _declare)


def use_bitonic_sort() -> bool:
    """The switch (counterpart of ``pallas_sort.use_pallas_sort``): off
    unless the environment says ``SCENESPLAT_BITONIC_SORT=1``."""
    return os.environ.get(ENV_SWITCH) == "1"


def apply_sort_switch(cfg) -> None:
    """A config's ``bitonic_sort`` entry sets the switch for this process
    (the entry points' ``--options bitonic_sort=True``)."""
    if "bitonic_sort" in cfg:
        os.environ[ENV_SWITCH] = "1" if cfg.get("bitonic_sort") else "0"


def padded_length(n: int) -> int:
    """The power of two, at least ``MIN_ROW``, a row of ``n`` is padded to."""
    return max(MIN_ROW, 1 << max(n - 1, 1).bit_length())


def kernel_launches(n: int, tile: int = 4096) -> int:
    """Kernel launches K3 makes for one sort of rows of length ``n``: one
    for every phase up to the tile, then per larger phase one for each
    stage at a distance of at least the tile and one for the rest."""
    log_n = padded_length(n).bit_length() - 1
    log_t = min(log_n, tile.bit_length() - 1)
    return 1 + sum(k - log_t + 1 for k in range(log_t + 1, log_n + 1))


def _prepare(operands: Sequence[torch.Tensor], num_keys: int):
    """Checks, then the operands as contiguous padded [B, np2] copies."""
    operands = list(operands)
    if not 1 <= num_keys <= len(operands) <= MAX_OPERANDS:
        raise ValueError(f"{len(operands)} operands with {num_keys} keys: at most "
                         f"{MAX_OPERANDS} operands, 1 <= num_keys <= operands")
    shape, device = operands[0].shape, operands[0].device
    if len(shape) < 1 or shape[-1] < 1:
        raise ValueError(f"operands need a non-empty last axis, got {tuple(shape)}")
    for op in operands:
        if op.dtype != torch.int32:
            raise TypeError(f"operands are int32 bit patterns, got {op.dtype}")
        if op.shape != shape or op.device != device:
            raise ValueError("all operands must share a shape and a device")
    n = shape[-1]
    np2 = padded_length(n)
    if np2 > MAX_ROW:
        raise ValueError(f"row length {n} is above {MAX_ROW}")
    padded = []
    for i, op in enumerate(operands):
        buf = torch.full((op.numel() // n, np2), _PAD_KEY if i < num_keys else 0,
                         dtype=torch.int32, device=device)
        buf[:, :n] = op.reshape(-1, n)
        padded.append(buf)
    return padded, shape, n


def _unpad(padded, shape, n) -> Tuple[torch.Tensor, ...]:
    return tuple(p[:, :n].reshape(shape) for p in padded)


def bitonic_sort(operands: Sequence[torch.Tensor], num_keys: int = 1
                 ) -> Tuple[torch.Tensor, ...]:
    """Sorts ``[..., n]`` int32 operands along the last axis by their first
    ``num_keys`` operands, compared as unsigned 32-bit values; the others
    move with them. Unstable: equal keys may change places (always the same
    way). Returns new tensors; the inputs are left as they are.

    When n is not a power of two, every real key tuple must compare strictly
    below (0xFFFFFFFF, ...), or padding can displace it.

    CUDA tensors go through K3, CPU tensors through the plain version.
    ``bitonic_sort.launches`` counts the calls that launched K3,
    ``bitonic_sort.kernel_launches`` the CUDA kernels they launched."""
    if not operands[0].is_cuda:
        return bitonic_sort_reference(operands, num_keys)
    padded, shape, n = _prepare(operands, num_keys)
    if len(padded) not in KERNEL_OPERANDS:
        raise ValueError(f"{len(padded)} operands: the kernel is built for {KERNEL_OPERANDS}")
    batch, np2 = padded[0].shape
    if batch > 65535:
        raise ValueError(f"{batch} rows: the kernel takes at most 65535")
    device = padded[0].device
    ptrs = [p.data_ptr() for p in padded] + [None] * (MAX_OPERANDS - len(padded))
    count = ctypes.c_int(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = LIBRARY.load().bitonic_sort_rows(*ptrs, len(padded), num_keys, batch, np2,
                                              ctypes.byref(count), stream)
    if rc != 0:
        raise RuntimeError(f"bitonic sort launch failed: CUDA error {rc}")
    bitonic_sort.launches += 1
    bitonic_sort.kernel_launches += count.value
    return _unpad(padded, shape, n)


bitonic_sort.launches = 0
bitonic_sort.kernel_launches = 0


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b over the leading axis of key tuples [num_keys, ...]."""
    less = a[0] < b[0]
    equal = a[0] == b[0]
    for ak, bk in zip(a[1:], b[1:]):
        less = less | (equal & (ak < bk))
        equal = equal & (ak == bk)
    return less


def bitonic_sort_reference(operands: Sequence[torch.Tensor], num_keys: int = 1
                           ) -> Tuple[torch.Tensor, ...]:
    """The plain version: the same network on the same padded rows in torch
    ops, one vectorised compare-exchange per stage (the partner of element i
    at distance d is i ^ d; a pair is exchanged only when its keys are
    strictly out of order)."""
    padded, shape, n = _prepare(operands, num_keys)
    np2 = padded[0].shape[1]
    vals = torch.stack(padded)  # [num_ops, B, np2]
    iota = torch.arange(np2, device=vals.device)
    m = 2
    while m <= np2:
        up = (iota & m) == 0
        d = m >> 1
        while d >= 1:
            low = (iota & d) == 0  # the partner lies above
            partner = vals[..., iota ^ d]
            # unsigned order of int32 bit patterns: flip the sign bit
            mine = vals[:num_keys] ^ -(1 << 31)
            theirs = partner[:num_keys] ^ -(1 << 31)
            take = torch.where(up == low, _lex_less(theirs, mine), _lex_less(mine, theirs))
            vals = torch.where(take, partner, vals)
            d >>= 1
        m <<= 1
    return _unpad(list(vals), shape, n)


def sort_int64(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted codes, order) of a stable ascending sort of non-negative int64
    ``code`` along the last axis. Off the switch: one ``torch.sort``. On it:
    each code's high and low 32-bit halves and the element index go through
    ``bitonic_sort`` as three keys (K3 on CUDA tensors, its plain version on
    CPU tensors); the index makes every key tuple distinct, so the unstable
    network gives the stable order."""
    if not use_bitonic_sort():
        values, order = torch.sort(code, dim=-1, stable=True)
        return values, order
    if code.dtype != torch.int64:
        raise TypeError(f"codes are int64, got {code.dtype}")
    halves = code.contiguous().view(torch.int32).view(*code.shape, 2)  # little endian
    iota = torch.arange(code.shape[-1], dtype=torch.int32, device=code.device)
    hi, lo, order = bitonic_sort((halves[..., 1], halves[..., 0], iota.expand(code.shape)),
                                 num_keys=3)
    values = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
    return values, order.to(torch.int64)
