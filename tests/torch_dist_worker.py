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
    """``job["model"]`` (a model config; a LangPretrainer over
    ``job["backbone"]`` without it) with ``job["state"]`` loaded strictly."""
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(job.get("model") or dict(type="LangPretrainer",
                                                      backbone=dict(job["backbone"]))))
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


def semseg_step(job) -> dict:
    """This rank's rows of the job's global batch through one ``train_step``
    of the job's ``task`` ("semseg" by default; "insseg", "msc", "cac")
    under DDP without ``find_unused_parameters``, drop-path, the curve
    shuffle and MSC's masks and pairs drawn from a generator seeded from
    ``seed``; the first step's record. With ``steps`` > 1 the step runs
    again under the same DDP wrapper (which raises at a step after one
    that left a parameter without a gradient)."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria

    pdist.init_distributed("cpu")
    rows = pdist.local_batch_slice(job["batch"]["mask" if "mask" in job["batch"]
                                                 else "view1_mask"].shape[0])
    batch = _tensors({k: v[rows] for k, v in job["batch"].items()})
    model = _model(job)
    ddp = pdist.data_parallel(model)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    generator = torch.Generator().manual_seed(job["seed"])
    records = []
    for _ in range(job.get("steps", 1)):
        metrics = train_step(ddp, build_criteria(job["criteria"]), optimizer, None, batch,
                             generator=generator, task=job.get("task", "semseg"))
        records.append(_step_record(model, metrics["loss"], metrics["grad_norm"]))
    return records[0]


def ppt_steps(job) -> dict:
    """This rank's rows of the job's global batch through one ``train_step``
    of task "ppt" on each of ``conditions`` in turn, under one DDP wrapper
    built as the trainer builds it for PPT (``find_unused_parameters``,
    unless the job turns it off)."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria

    pdist.init_distributed("cpu")
    rows = pdist.local_batch_slice(job["batch"]["mask"].shape[0])
    batch = _tensors({k: v[rows] for k, v in job["batch"].items()})
    model = _model(job)
    ddp = pdist.data_parallel(model, find_unused_parameters=job.get("find_unused", True))
    criteria = build_criteria(job["criteria"])
    steps = []
    for name in job["conditions"]:
        metrics = train_step(ddp, criteria, torch.optim.SGD(model.parameters(), lr=0.0), None,
                             dict(batch, condition=name),
                             generator=torch.Generator().manual_seed(job["seed"]), task="ppt")
        steps.append(_step_record(model, metrics["loss"], metrics["grad_norm"]))
    return dict(steps=steps)


def ssl_record(model, metrics) -> dict:
    """An SSL step's loss terms, the student's gradients, every running
    statistic and the teacher's parameters after the step."""
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads={k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None},
                stats={k: v.clone() for k, v in model.state_dict().items()
                       if k.endswith(("running_mean", "running_var"))},
                teacher={k: p.detach().clone() for k, p in model.teacher.named_parameters()})


def ssl_step(job) -> dict:
    """This rank's rows of every crop of the job's global batch through one
    ``ssl_train_step`` of a SimDINOSSL under DDP (its ``SSLObjective``),
    SGD at ``lr``, the EMA at ``momentum``; token masks, drop-path and the
    curve shuffle drawn from a generator seeded from ``seed``."""
    from scenesplat_tpu_torch.engines.pretrain import SSLObjective, ssl_train_step

    pdist.init_distributed("cpu")
    rows = pdist.local_batch_slice(job["batch"]["global_crop0_mask"].shape[0])
    batch = _tensors({k: v[rows] for k, v in job["batch"].items()})
    batch = {k: v.long() if k.endswith("grid_coord") else v for k, v in batch.items()}
    model = _model(job)
    optimizer = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                                lr=job["lr"])
    metrics = ssl_train_step(pdist.data_parallel(SSLObjective(model)), optimizer, None, batch,
                             job["momentum"], generator=torch.Generator().manual_seed(job["seed"]),
                             **job["loss_kwargs"])
    return ssl_record(model, metrics)


def gather(job) -> dict:
    """``all_gather_rows`` of this rank's ``job["rows"][rank]`` and the
    gradient of a weighted sum of the gathered rows with respect to it."""
    pdist.init_distributed("cpu")
    x = torch.from_numpy(job["rows"][pdist.rank()]).requires_grad_(True)
    full = pdist.all_gather_rows(x, fill=-7.0)
    (full * torch.from_numpy(job["weights"])).sum().backward()
    return dict(full=full.detach(), grad=x.grad)


def losses(job) -> dict:
    """Each of ``job["losses"]`` (name -> (kind, config)) on this rank's rows
    of its inputs: the value and the gradients with respect to the rank's
    inputs. Kinds: "criteria" (pred, target, mask through ``build_criteria``),
    "mcr" (student and teacher crops x [M, D] rows), "cosine" (tokens and
    weights), "dino" (student and teacher views [steps, views, rows, K]:
    one DINOLoss called once a step, its values, the gradients of each
    step and the centre after the last update)."""
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.models.losses.dino_legacy import DINOLoss
    from scenesplat_tpu_torch.models.ssl import cosine_patch_loss, mcr_loss

    pdist.init_distributed("cpu")
    out = {}
    for name, (kind, cfg, inputs) in job["losses"].items():
        rows = pdist.local_batch_slice(inputs[0].shape[{"mcr": 1, "dino": 2}.get(kind, 0)])
        if kind == "dino":
            dino = DINOLoss(inputs[0].shape[-1], **cfg)
            record = dict(loss=[], grads=[])
            for student, teacher in zip(*inputs):
                s = torch.from_numpy(student[:, rows]).requires_grad_(True)
                loss = dino(list(s), list(torch.from_numpy(teacher[:, rows])), 0.05)
                loss.backward()
                record["loss"].append(float(loss))
                record["grads"].append(s.grad)
            out[name] = dict(record, center=dino.center.clone())
            continue
        if kind == "criteria":
            pred = torch.from_numpy(inputs[0][rows]).requires_grad_(True)
            loss = build_criteria(cfg)(pred, torch.from_numpy(inputs[1][rows]).long(),
                                       mask=torch.from_numpy(inputs[2][rows]))
            args = [pred]
        elif kind == "mcr":
            args = [torch.from_numpy(x[:, rows]).requires_grad_(True) for x in inputs]
            loss, _ = mcr_loss(list(args[0]), list(args[1]))
        else:
            args = [torch.from_numpy(x[rows]).requires_grad_(True) for x in inputs[:2]]
            loss = cosine_patch_loss(*args, torch.from_numpy(inputs[2][rows]))
        loss.backward()
        out[name] = dict(loss=float(loss), grads=[a.grad for a in args])
    return out


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
    """Builds the trainer of ``job["cfg"]`` in the group and trains it (its
    epochs' steps); returns its task, its step module's type and the losses
    it logged."""
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.utils.config import Config

    t = build_trainer(Config(job["cfg"]), device="cpu")
    t.train()
    return dict(task=t.task, world=t.world, train_model=type(t.train_model).__name__,
                losses=t.storage.history("loss").values())


def _whole_grads(model) -> dict:
    """Every parameter's gradient; a tensor-parallel share gathered whole
    over its model group."""
    from scenesplat_tpu_torch.parallel.tp import gather_whole

    whole = gather_whole(((k, p.grad) for k, p in model.named_parameters()), model)
    return {k: g.clone() for k, g in whole.items()}


def _grid_batch(batch: dict, kind) -> dict:
    """This rank's part of the global batch: its rows (``kind`` "tp" or
    None: whole rows) and under "cp" its block of each row's slots."""
    from scenesplat_tpu_torch.parallel.context import shard_point_batch

    if kind == "cp":
        return _tensors(shard_point_batch(batch))
    return _tensors({k: v[pdist.local_batch_slice(len(v))] for k, v in batch.items()})


def _grid_model(config: dict, state: dict, kind):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.parallel.tp import shard_model_tp

    model = build_model(dict(config))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                          strict=True)
    return shard_model_tp(model) if kind == "tp" else model


def grid_eval(job, kind=None) -> dict:
    """The backbone ``job["backbone"]`` in eval mode (as the JAX tensor and
    context parallel tests hold it) on this rank's part of ``job["batch"]``
    under DDP: its output, and the gradient of the masked squared distance
    to ``target`` summed over the points group and divided by
    ``loss_scale``. ``kind`` None: one process over the whole batch."""
    from scenesplat_tpu_torch.models.structure import PointBatch
    from scenesplat_tpu_torch.parallel import context

    model = _grid_model(job["backbone"], job["state"], kind).eval()
    batch = _grid_batch(job["batch"], kind)
    context.GATHERED.update(forward=0, backward=0)
    ddp = pdist.data_parallel(model)  # held through the backward, whose sums it makes
    out = ddp(PointBatch(coord=batch["coord"], feat=batch["feat"],
                         grid_coord=batch["grid_coord"], mask=batch["mask"]))
    d = (out.feat - batch["target"]) * out.mask[..., None]
    loss = pdist.all_reduce_sum((d * d).sum()) / job["loss_scale"]
    loss.backward()
    return dict(loss=loss.item(), feat=out.feat.detach().clone(), grads=_whole_grads(model),
                gathered=dict(context.GATHERED))


def grid_train(job, kind=None) -> dict:
    """One ``train_step`` of the LangPretrainer ``job["train_model"]`` with
    its drop-path and dropout, the curve shuffle and the contrastive split
    drawn from a generator seeded ``seed``, clipped at ``clip_grad`` (SGD at
    lr 0) on this rank's part of ``job["train_batch"]`` under DDP: the loss,
    the gradient norm, the clipped gradients and the running statistics;
    under tensor parallel also the whole state dict
    (``gather_state_dict_tp``)."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.parallel.tp import gather_state_dict_tp

    model = _grid_model(job["train_model"], job["train_state"], kind)
    ddp = pdist.data_parallel(model)
    metrics = train_step(ddp, build_criteria(job["criteria"]),
                         torch.optim.SGD(model.parameters(), lr=0.0), None,
                         _grid_batch(job["train_batch"], kind),
                         generator=torch.Generator().manual_seed(job["seed"]),
                         epoch_progress=1.0, clip_grad=job["clip_grad"], task="lang")
    record = _step_record(model, metrics["loss"], metrics["grad_norm"])
    record["grads"] = _whole_grads(model)
    if kind == "tp":
        record["state"] = gather_state_dict_tp(model)
        record["shards"] = {k: tuple(p.shape) for k, p in model.named_parameters()
                            if getattr(p, "tp_sharded", False)}
    return record


def grids(job) -> dict:
    """Both grids of a group of 4 in turn, each in its own layout: (data 2,
    model 2) under tensor parallel, then (data 2, seq 2) under context
    parallel; on each ``grid_eval`` and ``grid_train``."""
    from scenesplat_tpu_torch.parallel import context, tp

    pdist.init_distributed("cpu")
    out = {}
    for kind, make in (("tp", lambda: tp.tp_groups(2, 2)), ("cp", lambda: context.context_groups(2))):
        grid = make()
        pdist.set_layout(grid)
        try:
            out[kind] = dict(eval=grid_eval(job, kind), train=grid_train(job, kind),
                             coords=(grid.data_rank, grid.seq_rank, grid.model_rank))
            if kind == "cp":  # a stage with fewer windows than seq ranks
                out[kind]["eval_wide"] = grid_eval(dict(job, backbone=job["wide_backbone"]), kind)
        finally:
            pdist.set_layout(None)
    return out


JOBS = dict(step=step, semseg_step=semseg_step, ppt_steps=ppt_steps, ssl_step=ssl_step,
            gather=gather,
            losses=losses, reductions=reductions, entry=entry, trainer=trainer, grids=grids)


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
