"""Trainers (counterpart of ``scenesplat_tpu/engines/train.py``): a
hook-driven epoch and step loop around ``engines/train_step.py``.

The port trains the VL pretraining task (``LangPretrainer``), semantic
segmentation (``DefaultSegmentorV2``), Point Prompt Training
(``PPT-v1m1``, ``PPT-v1m2``: semantic segmentation over several datasets,
each batch from one, usually through ``MultiDatasetTrainer``),
PointGroup instance segmentation (``PG-v1m1``), Masked Scene Contrast
pretraining (``MSC-v1m1``, ``MSC-v1m2``) and the Context-Aware Classifier
(``CAC-v1m1``). The config's ``task`` picks the task, else the model's
type through ``Trainer.TASKS``, as in the JAX package (whose last resort,
"lang", the port does not copy: a type outside the table needs the key; a
v1 ``DefaultSegmentor`` over PT-v2 or PTv1 trains with
``task="semseg"``). SimDINO
self-supervised pretraining has a trainer of its own
(``engines/pretrain.py:DefaultSSLPreTrainer``, ``train =
dict(type="DefaultSSLPreTrainer")`` in a config).
Parameters come from ``cfg.seed``; every training draw (curve shuffle,
drop-path, the contrastive split) comes from one ``torch.Generator`` on
the card seeded from it, and the data pipeline seeds its own per-sample
generators from it, so a run is a function of its config.

Data parallel (``torchrun --nproc_per_node N -m scenesplat_tpu_torch.train``)
trains every task: ``batch_size`` is the global batch, each process loads
its rows, the step runs under DistributedDataParallel (``train_model``: the
model, or for SSL its ``SSLObjective``; ``model`` stays the module itself,
which the hooks evaluate and save), and the reductions over the batch (the
BatchNorm moments, the losses' sums, Lovasz's sort, MCR's covariance) span
every process's rows (``parallel/dist.py``), so N processes train the model
one process would train on the whole batch. Rank 0 alone logs and writes
files.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from scenesplat_tpu_torch.data import ConcatDataset, Loader, MultiDatasetLoader, build_dataset
from scenesplat_tpu_torch.data.collate import collate_two_view
from scenesplat_tpu_torch.engines.hooks import HookBase, build_hooks
from scenesplat_tpu_torch.engines.train_step import TASK_LOSSES, batch_to_device, train_step
from scenesplat_tpu_torch.models import build_criteria, build_model
from scenesplat_tpu_torch.parallel.dist import (
    check_global_batch,
    data_parallel,
    init_distributed,
    rank,
    world,
)
from scenesplat_tpu_torch.utils.events import EventStorage
from scenesplat_tpu_torch.utils.logger import get_root_logger
from scenesplat_tpu_torch.utils.optimizer import build_optimizer, build_scheduler
from scenesplat_tpu_torch.utils.registry import Registry

TRAINERS = Registry("trainers")


class TrainerBase:
    def __init__(self):
        self.hooks = []
        self.epoch = 0
        self.start_epoch = 0
        self.max_epoch = 0
        self.storage: Optional[EventStorage] = None
        # what hooks tell each other: the evaluator's current metric, the
        # checkpoint saver's best
        self.comm_info = {}

    def register_hooks(self, hooks_cfg):
        self.hooks = build_hooks(hooks_cfg)
        for h in self.hooks:
            if not isinstance(h, HookBase):
                raise TypeError(f"{type(h).__name__} is not a hook")
            h.trainer = self

    def call_hooks(self, phase: str):
        for h in self.hooks:
            getattr(h, phase)()

    def train(self):
        with EventStorage() as self.storage:
            self.call_hooks("before_train")
            for self.epoch in range(self.start_epoch, self.max_epoch):
                self.call_hooks("before_epoch")
                self.run_epoch()
                self.call_hooks("after_epoch")
            self.call_hooks("after_train")

    def run_epoch(self):
        raise NotImplementedError


@TRAINERS.register_module("DefaultTrainer")
class Trainer(TrainerBase):
    """Single-dataset trainer on ``device`` (``cuda:LOCAL_RANK`` in a
    process group). The task is the config's ``task`` where it sets one (a
    v1 DefaultSegmentor sets "semseg"), else the model type's (``TASKS``);
    a type outside the table without ``task`` raises."""

    TASKS = {"LangPretrainer": "lang", "DefaultSegmentorV2": "semseg",
             "PPT-v1m1": "ppt", "PPT-v1m2": "ppt", "PG-v1m1": "insseg",
             "MSC-v1m1": "msc", "MSC-v1m2": "msc", "CAC-v1m1": "cac"}

    def __init__(self, cfg, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = init_distributed(device)
        self.rank, self.world = rank(), world()
        self.logger = get_root_logger(
            log_file=os.path.join(cfg.get("save_path", "exp/default"), "train.log"))
        self.max_epoch = cfg.get("epoch", 100)
        eval_epoch = cfg.get("eval_epoch")
        if eval_epoch:
            # eval_epoch outer epochs, each covering epoch // eval_epoch passes
            # of the data through the dataset's loop (the reference overwrites
            # any preset loop)
            if self.max_epoch % eval_epoch:
                raise ValueError(f"epoch ({self.max_epoch}) must be divisible by "
                                 f"eval_epoch ({eval_epoch})")
            loop = self.max_epoch // eval_epoch
            if loop > 1:
                cfg.data.train["loop"] = loop
            self.max_epoch = int(eval_epoch)
        batch_size = cfg.get("batch_size", 1)
        if not isinstance(batch_size, int) or batch_size < 1:
            raise TypeError(f"batch_size must be a positive int, got {batch_size!r}")
        check_global_batch(batch_size)

        model_cfg = dict(cfg.model)
        criteria_cfg = model_cfg.pop("criteria", None)
        # the config's task first (a v1 DefaultSegmentor sets task="semseg"),
        # then the model type's
        self.task = cfg.get("task") or self.TASKS.get(model_cfg.get("type"))
        if self.task is None:
            raise NotImplementedError(f"model {model_cfg.get('type')} names no task: set the "
                                      f"config's task, or train one of {', '.join(self.TASKS)}")
        if self.task not in TASK_LOSSES and self.task not in self.TASKS.values():
            raise NotImplementedError(f"task {self.task!r} is not ported; the port trains "
                                      f"{', '.join(TASK_LOSSES)}")
        model_cfg["backbone"] = dict(model_cfg["backbone"])
        model_cfg["backbone"].setdefault("seed", cfg.get("seed", 0))
        if self.task == "cac":  # CAC computes its loss with its own criteria
            model_cfg["criteria"] = criteria_cfg
        self.model = self.build_model(model_cfg).to(self.device)
        # a PPT step leaves the other conditions' parameters without a
        # gradient: DDP must look for them (the reference's PPT files set
        # find_unused_parameters too); other tasks use every parameter
        self.train_model = data_parallel(self.train_module(),
                                         find_unused_parameters=self.task == "ppt")
        self.criteria = build_criteria(criteria_cfg)
        self.clip_grad = cfg.get("clip_grad")

        self.train_loader = self.build_train_loader()
        self.total_steps = len(self.train_loader) * self.max_epoch
        self.logger.info(f"train loader: {len(self.train_loader)} steps/epoch x "
                         f"{self.max_epoch} epochs on {self.device}, process {self.rank} "
                         f"of {self.world}")
        self.optimizer = build_optimizer(
            dict(cfg.optimizer), self.model,
            param_dicts=[dict(p) for p in cfg.get("param_dicts") or []])
        self.scheduler = build_scheduler(cfg.get("scheduler"), self.optimizer,
                                         self.total_steps)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.get("seed", 0) + 1)
        self.register_hooks(cfg.get("hooks"))

    def build_model(self, model_cfg: dict) -> torch.nn.Module:
        return build_model(model_cfg)

    def train_module(self) -> torch.nn.Module:
        """What the step runs (under DDP in a process group)."""
        return self.model

    def build_train_loader(self):
        """MSC's batches are two-view (``collate_two_view`` at
        ``data.num_points`` a view, one sample a row: MSC mixes views in
        the model, so Mix3D's ``mix_prob`` does not apply)."""
        num_points = self.cfg.data.get("num_points", 65536)
        if self.task == "msc":
            kw = dict(collate_fn=functools.partial(collate_two_view, view_points=num_points))
        else:
            kw = dict(mix_prob=self.cfg.get("mix_prob", 0.0))
        return Loader(build_dataset(dict(self.cfg.data.train)),
                      batch_size=self.cfg.get("batch_size", 1), num_points=num_points,
                      seed=self.cfg.get("seed", 0), num_workers=self.cfg.get("num_worker", 4),
                      **kw)

    def run_epoch(self):
        self.train_loader.set_epoch(self.epoch)
        for batch in self.train_loader:
            self.call_hooks("before_step")
            self.run_step(batch)
            self.call_hooks("after_step")
            self.storage.step()

    def run_step(self, batch):
        lr = self.optimizer.param_groups[0]["lr"]
        metrics = train_step(self.train_model, self.criteria, self.optimizer, self.scheduler,
                             batch_to_device(batch, self.device), generator=self.generator,
                             epoch_progress=(self.epoch + 1) / max(self.max_epoch, 1),
                             clip_grad=self.clip_grad, task=self.task)
        self.storage.put_scalars(loss=metrics["loss"].item(),
                                 grad_norm=metrics["grad_norm"].item(), lr=lr,
                                 **{k: v.item() for k, v in metrics.get("terms", {}).items()})


@TRAINERS.register_module("MultiDatasetTrainer")
class MultiDatasetTrainer(Trainer):
    """Interleaves the children of a ConcatDataset by their loop ratio;
    each batch comes from one child (so a PPT batch holds one condition).
    Under data parallel every process draws the same child at every step:
    each child's loader has the same number of batches on every process
    (a batch count of the global batch), so the interleave runs in step."""

    def build_train_loader(self):
        dataset = build_dataset(dict(self.cfg.data.train))
        if not isinstance(dataset, ConcatDataset):
            raise TypeError("MultiDatasetTrainer needs a ConcatDataset")
        return MultiDatasetLoader(dataset, batch_size=self.cfg.get("batch_size", 1),
                                  num_points=self.cfg.data.get("num_points", 65536),
                                  mix_prob=self.cfg.get("mix_prob", 0.0),
                                  seed=self.cfg.get("seed", 0),
                                  num_workers=self.cfg.get("num_worker", 4))


def build_trainer(cfg, device="cuda"):
    train_cfg = dict(cfg.get("train") or {"type": "DefaultTrainer"})
    kind = train_cfg.pop("type")
    trainer_cls = TRAINERS.get(kind)
    if trainer_cls is None:
        raise KeyError(f"trainer {kind} is not ported")
    return trainer_cls(cfg, device=device, **train_cfg)


from . import pretrain  # noqa: E402,F401 (registers DefaultSSLPreTrainer)
