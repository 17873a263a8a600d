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

Tensor and context parallel (``parallel/tp.py``, ``parallel/context.py``)
lay the processes out on a grid (``Layout``): rows over ``data``, each
row's points over ``seq``, the blocks' heads and hidden widths over
``model``. The ranks of one model group hold the same points, so every sum
above runs over the *points group* (the data x seq ranks of one model
index), which is the whole world under plain data parallel; and a draw
keeps this rank's rows and, under context parallel, its points.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

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


@dataclass(frozen=True)
class Layout:
    """The processes on a (data, seq, model) grid, rank = (d * seq + s) *
    model + m: the model axis minor (its sums run every block), then seq.
    ``points_group`` holds the ranks of this rank's model index (data x
    seq: the ranks that hold distinct points; None: the default group, the
    whole world), ``seq_group`` those of its data and
    model indices, ``model_group`` those of its data and seq indices (None
    where that axis has size 1)."""

    data: int = 1
    seq: int = 1
    model: int = 1
    data_rank: int = 0
    seq_rank: int = 0
    model_rank: int = 0
    points_group: object = None
    seq_group: object = None
    model_group: object = None

    @property
    def points(self) -> int:
        """Ranks in the points group."""
        return self.data * self.seq


_LAYOUT: Optional[Layout] = None


def layout() -> Layout:
    """The grid set by ``set_layout``; plain data parallel over the whole
    world without one."""
    if _LAYOUT is not None:
        return _LAYOUT
    return Layout(data=world(), data_rank=rank())


def set_layout(grid: Optional[Layout]) -> None:
    """Makes ``grid`` (``make_layout``'s) the layout every sum, draw and
    DDP wrapper of this process reads; None goes back to plain data
    parallel."""
    global _LAYOUT
    _LAYOUT = grid


def make_layout(data: int, seq: int = 1, model: int = 1) -> Layout:
    """The (data, seq, model) grid over the joined process group, with its
    groups. Every process calls it, in the same order as every other group
    it makes (``torch.distributed.new_group`` is a collective). Raises
    unless the group's size is data * seq * model."""
    if min(data, seq, model) < 1 or world() != data * seq * model:
        raise ValueError(f"a (data {data}, seq {seq}, model {model}) grid needs "
                         f"{data * seq * model} processes, the group has {world()}")
    r = rank()
    d, s, m = r // (seq * model), (r // model) % seq, r % model

    def ranks(dd, ss, mm):
        return [(a * seq + b) * model + c for a in dd for b in ss for c in mm]

    points = seq_g = model_g = None
    if model > 1:  # (a group of one at data x seq = 1: DDP over it sums nothing)
        for mm in range(model):
            g = dist.new_group(ranks(range(data), range(seq), [mm]))
            points = g if mm == m else points
    if seq > 1:
        seq_g = dist.group.WORLD if seq == world() else None
        for dd in range(data if seq_g is None else 0):
            for mm in range(model):
                g = dist.new_group(ranks([dd], range(seq), [mm]))
                seq_g = g if (dd, mm) == (d, m) else seq_g
    if model > 1:
        model_g = dist.group.WORLD if model == world() else None
        for dd in range(data if model_g is None else 0):
            for ss in range(seq):
                g = dist.new_group(ranks([dd], [ss], range(model)))
                model_g = g if (dd, ss) == (d, s) else model_g
    return Layout(data=data, seq=seq, model=model, data_rank=d, seq_rank=s, model_rank=m,
                  points_group=points, seq_group=seq_g, model_group=model_g)


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
    skips it. Without it such a model makes DDP raise at its second step.
    DDP averages over the layout's points group: under tensor parallel the
    ranks of one data group hold the same shard of every sharded weight."""
    if not (dist.is_available() and dist.is_initialized()):
        return model
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=None, find_unused_parameters=find_unused_parameters,
        process_group=layout().points_group)


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
    """A torchrun world is fixed, so the global batch must split evenly over
    the layout's data axis (the JAX trainer shrinks its mesh to a divisor
    of the batch instead)."""
    if batch_size % layout().data:
        raise ValueError(f"batch_size {batch_size} (the global batch) does not split over "
                         f"{layout().data} processes (the data axis)")


def local_batch_slice(n_global: int) -> slice:
    """Rows of a [B_global, ...] batch that this process holds: one
    contiguous block per data rank, in rank order (the ranks of one seq and
    model group hold the same rows)."""
    check_global_batch(n_global)
    grid = layout()
    per = n_global // grid.data
    return slice(grid.data_rank * per, (grid.data_rank + 1) * per)


def group_size(group=None) -> int:
    """Processes in ``group`` (None: the layout's points group)."""
    if group is None:
        return layout().points
    return dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` over the layout's points group (the whole world under
    plain data parallel), differentiable (its backward sums the cotangents
    over the group); ``x`` itself in a group of one."""
    if group_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x, group=layout().points_group or dist.group.WORLD)


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``x`` over ``group`` (None: the points group), not
    differentiable; ``x`` untouched in a group of one."""
    if group_size(group) > 1:
        dist.all_reduce(x, group=layout().points_group if group is None else group)
    return x


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
    the processes, as every other use of ``all_reduce_sum``. Over the
    layout's points group, in its rank order."""
    n = group_size()
    if n == 1:
        return x
    me = dist.get_rank(layout().points_group)
    counts = torch.zeros(n, dtype=torch.float64, device=x.device)
    counts[me] = x.shape[0]
    all_reduce_(counts)
    counts = counts.long().tolist()
    n_max = max(counts)
    if x.shape[0] < n_max:
        pad = x.new_full((n_max - x.shape[0],) + x.shape[1:], fill)
        x = torch.cat([x, pad])
    slots = [x if r == me else torch.zeros_like(x) for r in range(n)]
    full = all_reduce_sum(torch.stack(slots))
    return torch.cat([full[r, :counts[r]] for r in range(n)])


def gather_bitwise(x: torch.Tensor, index: int, count: int, group) -> torch.Tensor:
    """Every rank's ``x`` (each the same shape) of ``group`` stacked in rank
    order as [count, ...], bit for bit (not differentiable): each puts the
    bytes of ``x`` in its slot of a zero buffer of bytes, whose sum over the
    group (uint8, which every backend adds) holds every slot unchanged, where
    a float sum would turn -0.0 into 0.0. Over gloo the bytes go through
    host memory."""
    host = dist.get_backend(group) == "gloo"
    raw = x.detach().contiguous()
    raw = (raw.cpu() if host else raw).view(torch.uint8).reshape(x.numel() * x.element_size())
    slots = raw.new_zeros(count, raw.numel())
    slots[index] = raw
    dist.all_reduce(slots, group=group)
    return slots.view(x.dtype).reshape((count,) + x.shape).to(x.device)


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, sum over the group backward: the input of a
    column-parallel linear (every rank holds it whole and uses part of the
    weight)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dy = dy.contiguous().clone()
        dist.all_reduce(dy, group=ctx.group)
        return dy, None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward, identity backward: the output of a
    row-parallel linear (each rank holds a partial product)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, group)


def _draw_device(generator: Optional[torch.Generator], device):
    if device is not None:
        return device
    return None if generator is None else generator.device


Span = Tuple[int, int, int]  # (whole size, first, end) of the part of an axis a rank holds


def _global_draw(shape, points: bool, channels: Optional[Span], draw):
    """``draw(global shape)`` cut to this rank's part of ``shape`` = [B_local,
    ...]: its rows (the layout's data axis); under context parallel, for a
    draw that is one a point (``points``: axis 1 is the points), its points
    (every stage's slots split evenly over the seq axis,
    ``parallel/context.py:Part``), any other draw whole on every seq rank;
    its channels on the last axis (``channels``: tensor parallel's share of
    a hidden width)."""
    shape = tuple(shape)
    grid = layout()
    cut = None
    if points and grid.seq > 1:
        n = shape[1]
        cut = (n * grid.seq, grid.seq_rank * n, (grid.seq_rank + 1) * n)
    full = list(shape)
    full[0] *= grid.data
    if cut is not None:
        full[1] = cut[0]
    if channels is not None:
        full[-1] = channels[0]
    if tuple(full) == shape:
        return draw(shape)
    out = draw(tuple(full))[grid.data_rank * shape[0]:(grid.data_rank + 1) * shape[0]]
    if cut is not None:
        out = out[:, cut[1]:cut[2]]
    if channels is not None:
        out = out[..., channels[1]:channels[2]]
    return out


def batch_rand(shape: Sequence[int], generator: Optional[torch.Generator],
               device=None, points: bool = False,
               channels: Optional[Span] = None) -> torch.Tensor:
    """U[0, 1) draws of ``shape`` = [B_local, ...]: this process's part of
    one draw at the global batch's shape [B_local * data, ...] (see
    ``_global_draw`` for ``points`` and ``channels``)."""
    device = _draw_device(generator, device)
    return _global_draw(shape, points, channels,
                        lambda s: torch.rand(s, generator=generator, device=device))


def batch_randint(low: int, high: int, shape: Sequence[int],
                  generator: Optional[torch.Generator],
                  device=None, dtype=torch.int64) -> torch.Tensor:
    """``torch.randint(low, high)`` draws of ``shape`` = [B_local, ...]: this
    process's rows of one draw at the global batch's shape, as
    ``batch_rand`` (whole on every seq rank)."""
    device = _draw_device(generator, device)
    return _global_draw(shape, False, None, lambda s: torch.randint(
        low, high, s, generator=generator, device=device, dtype=dtype))
