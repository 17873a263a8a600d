"""Scene-sharded evaluation (the port's copy of
``scenesplat_tpu/parallel/dist_eval.py``).

Each process evaluates the global scene indices ``rank::world`` and the
numpy metric accumulators are summed over the processes, so every process
ends with the same metrics (and the checkpoint saver's choice of the best
epoch agrees on every one). A scene's transform draws stay keyed by its
global index, so the metrics do not depend on the number of processes.
The evaluation forwards run the model unwrapped and in eval mode, with no
collective: the processes may run different numbers of them.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch.distributed as dist

from .dist import rank as group_rank
from .dist import world as group_world


def eval_rank() -> int:
    """This process's shard; ``SCENESPLAT_EVAL_RANK`` overrides it, for
    single-process tests of the partition."""
    v = os.environ.get("SCENESPLAT_EVAL_RANK")
    return int(v) if v is not None else group_rank()


def eval_world() -> int:
    v = os.environ.get("SCENESPLAT_EVAL_WORLD")
    return int(v) if v is not None else group_world()


def partition_indices(n: int, rank: Optional[int] = None,
                      world: Optional[int] = None) -> List[int]:
    """Round-robin shard of ``range(n)``: ``rank, rank + world, ...``."""
    rank = eval_rank() if rank is None else rank
    world = eval_world() if world is None else world
    return list(range(rank, n, world))


def allgather_pyobjects(objs: list) -> list:
    """The processes' lists of picklable records, concatenated in rank
    order; ``objs`` itself at one process."""
    if group_world() == 1:
        return list(objs)
    gathered = [None] * group_world()
    dist.all_gather_object(gathered, list(objs))
    return [obj for part in gathered for obj in part]


def broadcast_pyobject(obj):
    """Rank 0's ``obj`` on every process (after rank 0 got here)."""
    return allgather_pyobjects([obj])[0]


def allreduce_sum_arrays(arrays):
    """Element-wise sums over the processes of a tuple or list of numpy
    arrays or scalars, of the same type; ``arrays`` itself at one process.
    The arrays travel pickled, so int64 and float64 stay exact, and the sum
    runs in rank order, so every process gets the same bits."""
    if group_world() == 1:
        return arrays
    per_rank = allgather_pyobjects([[np.asarray(a) for a in arrays]])
    summed = list(per_rank[0])
    for rank_arrays in per_rank[1:]:
        summed = [a + b for a, b in zip(summed, rank_arrays)]
    return type(arrays)(summed)
