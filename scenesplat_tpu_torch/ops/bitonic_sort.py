"""Row sort: the hand-written Hopper bitonic sort K3, its plain PyTorch
version, and the switch that puts it behind the port's sort sites.

K3 (``csrc/bitonic_sort.cu``) replaces the TPU kernel
``scenesplat_tpu/ops/pallas_sort.py:_sort_kernel`` (entered through
``_sort_rows``): an unstable bitonic sort of each row of ``[B, n]`` 32-bit
operands, lexicographic over the first ``num_keys`` operands compared as
unsigned values, the other operands carried as payload. Rows are padded to
a power of two (at least 1024) with keys ``0xFFFFFFFF`` and payload 0, as the
TPU wrapper pads them, so kernel, plain version and TPU kernel run one
deterministic network and agree element for element; the padding is formed
by index while a row is read (in the kernel's first launch, and with
``torch.where`` in the plain version), never stored in a buffer of the
caller's. The work is bound by bytes (each operand read and written once);
the source says how the network is cut into passes of up to four stages
between registers, shared and device memory, and ``sort_schedule`` mirrors
that cut in Python.

``bitonic_sort`` launches the kernel for CUDA tensors and runs the plain
version ``bitonic_sort_reference`` for CPU tensors; nothing falls back.
``sort_int64`` is the drop-in the sort sites call (what
``pallas_sort.sort_rows`` is to the TPU kernel): one ``torch.sort`` of the
int64 codes unless ``SCENESPLAT_BITONIC_SORT=1``, read on every call. With
the switch on, a code travels through ``bitonic_sort`` as its (high, low)
32-bit halves with the element index as the last key, so the order is the
stable ``torch.sort``'s exactly. On CUDA tensors that is one C call,
``bitonic_sort_codes``, which reads the int64 codes as they are and writes
the sorted codes and the int64 order: the wrapper launches nothing of its
own around the kernels.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence, Tuple

import torch

from ._build import CSRC, KernelLibrary

SOURCE = CSRC / "bitonic_sort.cu"
ENV_SWITCH = "SCENESPLAT_BITONIC_SORT"
MIN_ROW = 1024  # rows are padded to a power of two, at least this
MAX_ROW = 1 << 24
MAX_OPERANDS = 4
GROUP = 16  # elements a thread holds in a pass: up to 4 stages in registers
BLOCK_TILE = 4096  # elements of an operand in one block's shared memory
CLUSTER = 8  # blocks of a thread block cluster: a tile of 32,768
KERNEL_OPERANDS = (2, 3)  # the operand counts the CUDA source instantiates
_PAD_KEY = -1  # the int32 bit pattern 0xFFFFFFFF


def _declare(lib: ctypes.CDLL) -> None:
    lib.bitonic_sort_rows.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                                      + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.bitonic_sort_rows.restype = ctypes.c_int
    lib.bitonic_sort_codes.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    lib.bitonic_sort_codes.restype = ctypes.c_int


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


def sort_schedule(n: int) -> List[tuple]:
    """The kernel launches of one sort of rows of length ``n``, in order, as
    the C function queues them: ``("local", tile, m_lo, m_hi)`` runs, in
    shared-memory tiles of ``tile`` elements (a cluster of up to ``CLUSTER``
    blocks of ``BLOCK_TILE``), every stage at a distance below the tile of
    phases ``m_lo..m_hi``; ``("global", m, d_hi, stages)`` runs ``stages``
    (at most 4) stages of phase ``m`` from distance ``d_hi`` down on device
    memory."""
    np2 = padded_length(n)
    tile = min(np2, BLOCK_TILE * CLUSTER)
    passes = [("local", tile, 2, tile)]
    m = 2 * tile
    while m <= np2:
        d = m // 2
        while d >= tile:
            stages = min(4, (d // tile).bit_length())
            passes.append(("global", m, d, stages))
            d >>= stages
        passes.append(("local", tile, m, m))
        m *= 2
    return passes


def pass_stages(launch: tuple) -> List[List[Tuple[int, int]]]:
    """The stages ``(m, d)`` of one launch of ``sort_schedule``, grouped
    into the register passes the kernel runs them in (one trip through
    shared or device memory and one barrier each): in a local launch, per
    phase, the stages at distances of ``BLOCK_TILE`` and more in one pass
    over the cluster, then up to four stages at distances of ``GROUP`` and
    more on elements ``d / 8`` apart, and the stages below ``GROUP`` on 16
    neighbours; the first launch opens with phases 2 to ``GROUP`` in one
    pass."""
    if launch[0] == "global":
        _, m, d_hi, stages = launch
        return [[(m, d_hi >> s) for s in range(stages)]]
    _, tile, m_lo, m_hi = launch
    groups, m = [], m_lo
    if m_lo == 2:  # phases 2 .. GROUP lie inside 16 neighbours: one pass
        groups.append([(mm, mm >> s) for mm in (2, 4, 8, 16) for s in range(1, mm.bit_length())])
        m = 2 * GROUP
    while m <= m_hi:
        d = min(m // 2, tile // 2)
        while d >= 1:
            if d >= BLOCK_TILE:
                stages = (d // BLOCK_TILE).bit_length()
            elif d >= GROUP:
                stages = min(4, (d // GROUP).bit_length())
            else:
                stages = d.bit_length()
            groups.append([(m, d >> s) for s in range(stages)])
            d >>= stages
        m *= 2
    return groups


def kernel_launches(n: int) -> int:
    """Kernel launches K3 makes for one sort of rows of length ``n``."""
    return len(sort_schedule(n))


def _check(operands: Sequence[torch.Tensor], num_keys: int):
    """Checks; returns the operands as a list, their shape and row length."""
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
    if padded_length(shape[-1]) > MAX_ROW:
        raise ValueError(f"row length {shape[-1]} is above {MAX_ROW}")
    return operands, shape, shape[-1]


def _launch(entry: str, args: tuple, device: torch.device) -> None:
    """One C call on ``device``'s current stream; raises unless it returns
    0, counts the call and its kernel launches otherwise."""
    count = ctypes.c_int(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(LIBRARY.load(), entry)(*args, ctypes.byref(count), stream)
    if rc != 0:
        raise RuntimeError(f"bitonic sort launch failed: CUDA error {rc}")
    bitonic_sort.launches += 1
    bitonic_sort.kernel_launches += count.value


def bitonic_sort(operands: Sequence[torch.Tensor], num_keys: int = 1
                 ) -> Tuple[torch.Tensor, ...]:
    """Sorts ``[..., n]`` int32 operands along the last axis by their first
    ``num_keys`` operands, compared as unsigned 32-bit values; the others
    move with them. Unstable: equal keys may change places (always the same
    way). Returns new tensors; the inputs are left as they are.

    When n is not a power of two, every real key tuple must compare strictly
    below (0xFFFFFFFF, ...), or padding can displace it.

    CUDA tensors go through K3, CPU tensors through the plain version.
    ``bitonic_sort.launches`` counts the calls that launched K3 (those of
    ``sort_int64`` included), ``bitonic_sort.kernel_launches`` the CUDA
    kernels they launched."""
    if not operands[0].is_cuda:
        return bitonic_sort_reference(operands, num_keys)
    operands, shape, n = _check(operands, num_keys)
    if len(operands) not in KERNEL_OPERANDS:
        raise ValueError(f"{len(operands)} operands: the kernel is built for {KERNEL_OPERANDS}")
    rows = [op.reshape(-1, n).contiguous() for op in operands]
    batch, np2, device = rows[0].shape[0], padded_length(n), rows[0].device
    if batch > 65535:
        raise ValueError(f"{batch} rows: the kernel takes at most 65535")
    out = torch.empty((len(rows), batch, n), dtype=torch.int32, device=device)
    work = torch.empty((len(rows), batch, np2), dtype=torch.int32, device=device)

    def ptrs(tensors):
        return [t.data_ptr() for t in tensors] + [None] * (3 - len(rows))

    _launch("bitonic_sort_rows", (*ptrs(rows), *ptrs(out), *ptrs(work), len(rows), num_keys,
                                  batch, n, np2), device)
    return tuple(o.reshape(shape) for o in out)


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


def padded_rows(operands: Sequence[torch.Tensor], num_keys: int) -> torch.Tensor:
    """[num_ops, B, np2]: the operands' rows with every slot at or past n
    carrying the key ``0xFFFFFFFF`` or the payload 0, formed by index as
    the kernel's first launch forms it."""
    n = operands[0].shape[-1]
    iota = torch.arange(padded_length(n), device=operands[0].device)
    real = iota < n
    src = iota.clamp(max=n - 1)
    pad = torch.tensor([_PAD_KEY if i < num_keys else 0 for i in range(len(operands))],
                       dtype=torch.int32, device=iota.device)
    vals = torch.stack([op.reshape(-1, n)[:, src] for op in operands])
    return torch.where(real, vals, pad[:, None, None])


def compare_exchange(vals: torch.Tensor, num_keys: int, m: int, d: int) -> torch.Tensor:
    """One stage of the network on [num_ops, B, np2] rows: element i against
    its partner i ^ d, ascending where (i & m) == 0; a pair is exchanged
    only when its keys are strictly out of order."""
    iota = torch.arange(vals.shape[-1], device=vals.device)
    up = (iota & m) == 0
    low = (iota & d) == 0  # the partner lies above
    partner = vals[..., iota ^ d]
    # unsigned order of int32 bit patterns: flip the sign bit
    mine = vals[:num_keys] ^ -(1 << 31)
    theirs = partner[:num_keys] ^ -(1 << 31)
    take = torch.where(up == low, _lex_less(theirs, mine), _lex_less(mine, theirs))
    return torch.where(take, partner, vals)


def bitonic_sort_reference(operands: Sequence[torch.Tensor], num_keys: int = 1
                           ) -> Tuple[torch.Tensor, ...]:
    """The plain version: the same network on the same padded rows in torch
    ops, one vectorised compare-exchange per stage, phase by phase."""
    operands, shape, n = _check(operands, num_keys)
    vals = padded_rows(operands, num_keys)
    m = 2
    while m <= vals.shape[-1]:
        d = m >> 1
        while d >= 1:
            vals = compare_exchange(vals, num_keys, m, d)
            d >>= 1
        m <<= 1
    return tuple(v[:, :n].reshape(shape) for v in vals)


def sort_int64(code: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted codes, order) of a stable ascending sort of non-negative int64
    ``code`` along the last axis. Off the switch: one ``torch.sort``. On it:
    each code's high and low 32-bit halves and the element index are three
    keys of the bitonic network; the index makes every key tuple distinct,
    so the unstable network gives the stable order. CUDA tensors make one
    call of K3's int64 entry, which splits the codes while loading and
    writes the sorted codes and the int64 order itself; CPU tensors go
    through the plain version."""
    if not use_bitonic_sort():
        values, order = torch.sort(code, dim=-1, stable=True)
        return values, order
    if code.dtype != torch.int64:
        raise TypeError(f"codes are int64, got {code.dtype}")
    n = code.shape[-1]
    if not code.is_cuda:
        halves = code.contiguous().view(torch.int32).view(*code.shape, 2)  # little endian
        iota = torch.arange(n, dtype=torch.int32, device=code.device)
        hi, lo, order = bitonic_sort_reference(
            (halves[..., 1], halves[..., 0], iota.expand(code.shape)), num_keys=3)
        values = (hi.to(torch.int64) << 32) | (lo.to(torch.int64) & 0xFFFFFFFF)
        return values, order.to(torch.int64)
    if n < 1 or padded_length(n) > MAX_ROW:
        raise ValueError(f"row length {n} is not in 1..{MAX_ROW}")
    code = code.contiguous()
    batch, np2 = code.numel() // n, padded_length(n)
    if batch > 65535:
        raise ValueError(f"{batch} rows: the kernel takes at most 65535")
    values, order = torch.empty_like(code), torch.empty_like(code)
    work = torch.empty(3 * batch * np2, dtype=torch.int32, device=code.device)
    _launch("bitonic_sort_codes", (code.data_ptr(), values.data_ptr(), order.data_ptr(),
                                   work.data_ptr(), batch, n, np2), code.device)
    return values, order
