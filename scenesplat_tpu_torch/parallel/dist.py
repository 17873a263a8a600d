"""Process group and data-parallel helpers (counterpart of
``scenesplat_tpu/parallel/mesh.py``).

The JAX package runs the global batch as one program over a device mesh,
so every reduction of the step (BatchNorm moments, the loss normalizers,
the contrastive loss's per-class sums) spans the global batch. The port
runs one process per card under ``torchrun``: each process holds a
contiguous block of the global batch's rows (``local_batch_slice``), and
the model's reductions over the batch add their local parts with
``all_reduce_sum``, so that every process computes the global value.

Gradients: every dependency of the loss across processes goes through that
sum, whose backward sums the cotangents over processes again. Each process
holds the same loss, and its gradient is that of the sum of all processes'
copies, ``world`` times its rows' share of the global gradient; the mean
over processes that DistributedDataParallel takes is then the global
gradient, as one process would compute it for the whole batch.

Draws shaped like the batch (dropout, drop-path, the contrastive split) are
made at the global batch's shape by every process from the same generator
(``batch_rand``), each keeping its rows: N processes then draw what one
process draws for the whole batch, and their generators stay in step.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def world() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def init_distributed(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Joins the process group that torchrun's environment names (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``;
    counterpart of ``initialize_multihost``) and returns this process's
    device: ``cuda:LOCAL_RANK`` for a CUDA ``device``, else ``device``.
    Without ``WORLD_SIZE`` in the environment there is no group to join.
    The backend is NCCL on the card and gloo on the CPU unless ``backend``
    says otherwise (gloo on the card: two processes that share one card,
    which NCCL refuses). A group that fails to start raises; once joined,
    a call returns the device."""
    device = torch.device(device)
    if not (dist.is_available() and dist.is_initialized()) and "WORLD_SIZE" not in os.environ:
        return device
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_available():
        raise RuntimeError("WORLD_SIZE is set but this torch build has no torch.distributed")
    if not dist.is_initialized():
        dist.init_process_group(backend=backend or ("nccl" if device.type == "cuda" else "gloo"),
                                init_method="env://")
    return device


@contextlib.contextmanager
def process_group(device="cuda"):
    """``init_distributed(device)`` for the block, which gets the device;
    a group that it started is left at the end (an entry point's run)."""
    started = not (dist.is_available() and dist.is_initialized())
    try:
        yield init_distributed(device)
    finally:
        if started and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def barrier():
    if world() > 1:
        dist.barrier()


def data_parallel(model: torch.nn.Module, find_unused_parameters: bool = False
                  ) -> torch.nn.Module:
    """``model`` under DistributedDataParallel when a process group is up
    (any size: at one process it measures DDP's own cost), else ``model``.
    The batch arrives on the device already, so DDP moves no input
    (``device_ids=None``). ``find_unused_parameters`` is for a model whose
    steps leave some parameters without a gradient (Point Prompt Training:
    the other conditions' norms and heads; the reference's PPT configs set
    it too): DDP then walks each step's autograd graph to find them, and a
    parameter that no process used keeps ``.grad`` None, so the optimizer
    skips it. Without it such a model makes DDP raise at its second step."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None, find_unused_parameters=find_unused_parameters)


def check_same_on_ranks(index: int, size: int, device, what: str = "value"):
    """Raises unless every process holds the same ``index`` in [0, size):
    one all_reduce of a one-hot vector (a sum, so it runs on every backend)
    and one read of it on the host."""
    if world() == 1:
        return
    hot = torch.zeros(size, dtype=torch.float32, device=device)
    hot[index] = 1.0
    dist.all_reduce(hot)
    counts = hot.round().long().tolist()
    if counts[index] != world():
        raise RuntimeError(f"the processes hold different {what}s: {counts} processes each")


def max_on_ranks(x: torch.Tensor) -> int:
    """The largest value of ``x`` over every process, on the host (one
    all_reduce of its maximum at more than one process)."""
    top = x.max()
    if world() > 1:
        top = top.clone()
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
    return int(top)


def check_global_batch(batch_size: int):
    """A torchrun world is fixed, so the global batch must split evenly
    (the JAX trainer shrinks its mesh to a divisor of the batch instead)."""
    if batch_size % world():
        raise ValueError(f"batch_size {batch_size} (the global batch) does not split over "
                         f"{world()} processes")


def local_batch_slice(n_global: int) -> slice:
    """Rows of a [B_global, ...] batch that this process holds: one
    contiguous block per process, in rank order."""
    check_global_batch(n_global)
    per = n_global // world()
    return slice(rank() * per, (rank() + 1) * per)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the processes, differentiable (its backward sums
    the cotangents over the processes); ``x`` itself at one process."""
    if world() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def all_gather_rows(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Every process's ``x`` [n_r, ...] stacked in rank order as
    [sum_r n_r, ...] (``x`` itself at one process), differentiable; a
    process's rows may differ in number. Built from sums only, so that it
    runs on every backend (gloo carries no all_gather of CUDA tensors): the
    row counts come from the sum of a one-hot vector, then each
    process puts its rows, padded with ``fill`` to the largest count, in
    its slot of a zero [world, n_max, ...] buffer, whose sum over the
    processes (``all_reduce_sum``) holds every slot. Its backward is that
    of the sum: each process keeps its own slot's cotangents, summed over
    the processes, as every other use of ``all_reduce_sum``."""
    n = world()
    if n == 1:
        return x
    counts = torch.zeros(n, dtype=torch.float64, device=x.device)
    counts[rank()] = x.shape[0]
    dist.all_reduce(counts)
    counts = counts.long().tolist()
    n_max = max(counts)
    if x.shape[0] < n_max:
        pad = x.new_full((n_max - x.shape[0],) + x.shape[1:], fill)
        x = torch.cat([x, pad])
    slots = [x if r == rank() else torch.zeros_like(x) for r in range(n)]
    full = all_reduce_sum(torch.stack(slots))
    return torch.cat([full[r, :counts[r]] for r in range(n)])


def _draw_device(generator: Optional[torch.Generator], device):
    if device is not None:
        return device
    return None if generator is None else generator.device


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device=None) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` = [B_local, ...]: this process's rows of
    one draw at the global batch's shape [B_local * world, ...]."""
    shape = tuple(shape)
    device = _draw_device(generator, device)
    n = world()
    if n == 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * n,) + shape[1:], generator=generator, device=device)
    return full[rank() * shape[0]:(rank() + 1) * shape[0]]


def batch_randint(low: int, high: int, shape: Sequence[int],
                  generator: Optional[torch.Generator],
                  device=None, dtype=torch.int64) -> torch.Tensor:
    """``torch.randint(low, high)`` draws of ``shape`` = [B_local, ...]: this
    process's rows of one draw at the global batch's shape, as
    ``batch_rand``."""
    shape = tuple(shape)
    device = _draw_device(generator, device)
    n = world()
    full = torch.randint(low, high, (shape[0] * n,) + shape[1:], generator=generator,
                         device=device, dtype=dtype)
    return full if n == 1 else full[rank() * shape[0]:(rank() + 1) * shape[0]]
