"""Farthest point sampling on the card: the hand-written Hopper kernel
``csrc/farthest_point_sampling.cu``, all M steps of each row in one launch.

It replaces no TPU kernel: the JAX package's ``farthest_point_sampling``
(``scenesplat_tpu/ops/pointops.py:205``) is an XLA ``lax.fori_loop``. The
port's plain version, ``ops/pointops.py:farthest_point_sampling_reference``,
is a host loop of a few launches a sample; the Stratified Transformer takes
about 0.42 N samples a forward, so that loop would cost seconds a step. The
kernel's ids are bit-equal to the plain loop's (the source says how), which
stays the CPU path and the kernel's reference.

A row of N points runs on ``blocks_per_row(N)`` blocks: the fewest of
``CLUSTER_SIZES`` whose shared memory holds it, ``BLOCK_POINTS`` a block
(one block needs no cluster; 16 is a non-portable cluster, and a card that
cannot schedule one raises). A row longer than 16 blocks hold
(``spills(N)``) keeps its rest in a scratch row in device memory. The C
entry runs a row of at most 4,096 points on one block of 256 threads.

``farthest_point_sampling_cuda`` checks its arguments, launches the kernel
on the current stream and counts the launch
(``farthest_point_sampling_cuda.launches``); a failed launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CSRC, KernelLibrary

SOURCE = CSRC / "farthest_point_sampling.cu"
# a block's points in shared memory: 1024 threads of 16 (the source's BLOCK_POINTS)
BLOCK_POINTS = 1024 * 16
CLUSTER_SIZES = (1, 2, 4, 8, 16)
NO_CLUSTER = -2  # the C function's code: the card cannot schedule a 16-block cluster


def blocks_per_row(n: int) -> int:
    """The fewest of CLUSTER_SIZES blocks whose shared memory holds a row of
    n points; the largest when none does."""
    for blocks in CLUSTER_SIZES:
        if -(-n // blocks) <= BLOCK_POINTS:
            return blocks
    return CLUSTER_SIZES[-1]


def spills(n: int) -> bool:
    """Whether a row of n points is longer than its blocks hold, its rest
    in the scratch row."""
    return -(-n // blocks_per_row(n)) > BLOCK_POINTS


def _declare(lib: ctypes.CDLL) -> None:
    lib.farthest_point_sampling.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.farthest_point_sampling.restype = ctypes.c_int
    lib.fps_block_points.argtypes = []
    lib.fps_block_points.restype = ctypes.c_int


LIBRARY = KernelLibrary(SOURCE, _declare)


def farthest_point_sampling_cuda(coord: torch.Tensor, mask: torch.Tensor, num_samples: int
                                 ) -> torch.Tensor:
    """The ids [B, M] int64 of the plain loop's farthest point sampling of
    ``coord`` [B, N, 3] (CUDA, cast to contiguous fp32) under ``mask``
    [B, N], by one launch of the kernel."""
    if not coord.is_cuda or mask.device != coord.device:
        raise ValueError("farthest_point_sampling_cuda takes CUDA tensors on one device")
    if coord.dim() != 3 or coord.shape[-1] != 3 or mask.shape != coord.shape[:2]:
        raise ValueError(f"coord [B, N, 3] and mask [B, N], got {tuple(coord.shape)} and "
                         f"{tuple(mask.shape)}")
    b, n = mask.shape
    if num_samples < 1 or b < 1 or n < 1:
        raise ValueError(f"{num_samples} samples of {b} rows of {n} points")
    coord = coord.float().contiguous()
    mask = mask.to(torch.bool).contiguous()
    iota = torch.arange(n, device=coord.device)
    first = torch.where(mask, iota, n - 1).amin(1).contiguous()
    out = torch.empty(b, num_samples, dtype=torch.int64, device=coord.device)
    blocks = blocks_per_row(n)
    # the kernel's scratch row: the points past its blocks' shared memory
    spill = torch.empty(b, n, 4, dtype=torch.float32, device=coord.device) if spills(n) else None
    stream = torch.cuda.current_stream(coord.device).cuda_stream
    with torch.cuda.device(coord.device):
        rc = LIBRARY.load().farthest_point_sampling(
            coord.data_ptr(), mask.data_ptr(), first.data_ptr(), out.data_ptr(),
            None if spill is None else spill.data_ptr(), b, n, num_samples, blocks, stream)
    if rc == NO_CLUSTER:
        raise RuntimeError(f"farthest point sampling: rows of {n} points take a cluster of "
                           f"{blocks} blocks, which this card cannot schedule "
                           "(cudaOccupancyMaxActiveClusters gave 0)")
    if rc != 0:
        raise RuntimeError(f"farthest point sampling launch failed: CUDA error {rc}")
    farthest_point_sampling_cuda.launches += 1
    return out


farthest_point_sampling_cuda.launches = 0
