"""One rank of a data-parallel run of the port, for tests/test_torch_dist.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python -m tests.torch_dist_worker <job.pt> <result.pt>

The job file (``torch.save`` of a dict) names the work in ``kind``; the
rank joins the gloo group from the environment as a ``torchrun`` process
does, runs it on the CPU with one torch thread and writes what it saw to
``<result.pt>``. Imports torch and the port, never JAX."""

from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from scenesplat_tpu_torch.parallel import dist as pdist
from scenesplat_tpu_torch.parallel import dist_eval


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _model(job):
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(type="LangPretrainer", backbone=dict(job["backbone"])))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in job["state"].items()},
                          strict=True)
    return model


def _step_record(model, loss, grad_norm=None) -> dict:
    return dict(loss=float(loss), grad_norm=None if grad_norm is None else float(grad_norm),
                grads={k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None},
                stats={k: v.clone() for k, v in model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))})


def step(job) -> dict:
    """This rank's rows of the job's global batch through one step of a
    LangPretrainer under DDP. ``perm`` and ``split`` given: the curves'
    order and the contrastive split are fixed (the JAX comparison), the
    loss is differentiated as it is; otherwise ``train_step`` runs with a
    generator seeded from ``seed`` (drop-path and the split drawn)."""
    from scenesplat_tpu_torch.engines.train_step import lang_loss, train_step
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.ops.serialization import serialize

    pdist.init_distributed("cpu")
    rows = pdist.local_batch_slice(job["batch"]["mask"].shape[0])
    batch = _tensors({k: v[rows] for k, v in job["batch"].items()})
    model = _model(job).train()
    ddp = pdist.data_parallel(model)
    criteria = build_criteria(job["criteria"])
    if job.get("perm") is not None:
        order = job["backbone"]["order"]
        batch["ser"] = dataclasses.replace(
            serialize(batch["grid_coord"], batch["mask"], order, 16), perm=tuple(job["perm"]))
        split = torch.from_numpy(job["split"][rows])
        loss, _ = lang_loss(ddp, criteria, batch, epoch_progress=1.0, split=split)
        loss.backward()
        return _step_record(model, loss)
    generator = torch.Generator().manual_seed(job["seed"])
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    metrics = train_step(ddp, criteria, optimizer, None, batch, generator=generator,
                         epoch_progress=1.0, task="lang")
    return _step_record(model, metrics["loss"], metrics["grad_norm"])


def reductions(job) -> dict:
    """``allreduce_sum_arrays`` and ``allgather_pyobjects`` of this rank's
    entry of ``job["arrays"]`` and ``job["records"]``."""
    pdist.init_distributed("cpu")
    r = pdist.rank()
    return dict(summed=dist_eval.allreduce_sum_arrays(tuple(job["arrays"][r])),
                gathered=dist_eval.allgather_pyobjects(job["records"][r]),
                shard=dist_eval.partition_indices(job["n"]))


def entry(job) -> dict:
    """``python -m scenesplat_tpu_torch.<job["module"]>`` with ``job["argv"]``."""
    import importlib

    return dict(result=importlib.import_module(f"scenesplat_tpu_torch.{job['module']}")
                .main(job["argv"]))


def trainer(job) -> dict:
    """Builds the trainer of ``job["cfg"]`` (to see what it raises)."""
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.utils.config import Config

    try:
        build_trainer(Config(job["cfg"]), device="cpu")
    except NotImplementedError as e:
        return dict(raised=str(e))
    return dict(raised=None)


JOBS = dict(step=step, reductions=reductions, entry=entry, trainer=trainer)


def main(job_file: str, result_file: str) -> int:
    torch.set_num_threads(1)
    job = torch.load(job_file, weights_only=False)
    try:
        torch.save(JOBS[job["kind"]](job), result_file)
        pdist.barrier()
    finally:
        # a process that exits with its group alive can abort in the group's
        # teardown ("terminate called without an active exception")
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
