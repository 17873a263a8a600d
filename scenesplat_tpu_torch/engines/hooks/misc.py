"""Training hooks (counterpart of ``scenesplat_tpu/engines/hooks/misc.py``):
the iteration timer, the metrics writer, checkpoint save and load as torch
state dicts (model, optimizer, scheduler, the training generator's state,
step, epoch and best metric), the evaluators' run before training and the
testers' run after it, a profiler trace of a few steps and the page-cache
warm-up of the training data. Under data parallel rank 0 alone writes the
metrics file and the checkpoints, which hold the module's own names (no
DDP ``module.`` prefix), and every rank loads them."""

from __future__ import annotations

import glob
import math
import os
import shutil
import time

import torch

from scenesplat_tpu_torch.engines.test import build_tester
from scenesplat_tpu_torch.parallel.dist import barrier, rank
from scenesplat_tpu_torch.parallel.tp import gather_state_dict_tp
from scenesplat_tpu_torch.utils.events import JSONWriter, TensorboardWriter

from .default import HOOKS, HookBase


@HOOKS.register_module()
class IterationTimer(HookBase):
    """``data_time``: host seconds waiting for the batch; ``batch_time``:
    host seconds of the whole iteration. ``warmup_iter`` is accepted for
    the configs' sake and unused, as in the JAX package."""

    def __init__(self, warmup_iter: int = 2):
        self._iter_start = time.perf_counter()

    def before_epoch(self):
        self._iter_start = time.perf_counter()

    def before_step(self):
        self.trainer.storage.put_scalar("data_time", time.perf_counter() - self._iter_start)

    def after_step(self):
        now = time.perf_counter()
        self.trainer.storage.put_scalar("batch_time", now - self._iter_start)
        self._iter_start = now


@HOOKS.register_module()
class InformationWriter(HookBase):
    """Logs loss, grad_norm, timings, the loss terms and lr every
    ``log_interval`` steps and appends them to ``<save_path>/metrics.json``
    and, with tensorboardX installed, to TensorBoard events under
    ``<save_path>/tb``."""

    def __init__(self, log_interval: int = 10):
        self.log_interval = log_interval
        self.json_writer = self.tb_writer = None

    def before_train(self):
        save_path = self.trainer.cfg.get("save_path", "exp/default")
        self.json_writer = JSONWriter(os.path.join(save_path, "metrics.json"))
        self.tb_writer = TensorboardWriter(os.path.join(save_path, "tb"))

    def after_step(self):
        storage = self.trainer.storage
        if storage.iter % self.log_interval:
            return
        msgs = [f"epoch {self.trainer.epoch + 1}/{self.trainer.max_epoch}",
                f"iter {storage.iter}"]
        for key in ("loss", "grad_norm", "data_time", "batch_time"):
            if key in storage.latest:
                msgs.append(f"{key}: {storage.latest[key]:.4g}")
        # the loss terms of a model that returns them (MSC, CAC)
        msgs += [f"{k}: {v:.4g}" for k, v in storage.latest.items() if k.endswith("_loss")]
        if "lr" in storage.latest:
            msgs.append(f"lr: {storage.latest['lr']:.3e}")
        self.trainer.logger.info("  ".join(msgs))
        self.json_writer.write(storage)
        self.tb_writer.write(storage)

    def after_epoch(self):
        self.json_writer.write(self.trainer.storage)
        self.tb_writer.write(self.trainer.storage)

    def after_train(self):
        self.json_writer.close()
        self.tb_writer.close()


def training_state(trainer, epoch: int) -> dict:
    """What a checkpoint holds: the trainer's state after ``epoch`` epochs;
    a tensor-parallel model's whole state dict (``parallel/tp.py:
    gather_state_dict_tp``, a collective over its model group), which loads
    strictly into one process's model. The optimizer's state is this
    rank's."""
    return dict(
        state_dict=gather_state_dict_tp(trainer.model),
        optimizer=trainer.optimizer.state_dict(),
        scheduler=None if trainer.scheduler is None else trainer.scheduler.state_dict(),
        generator=trainer.generator.get_state(),
        step=trainer.storage.iter,
        epoch=epoch,
        best_metric=trainer.comm_info.get("best_metric_value", -1.0),
    )


@HOOKS.register_module()
class CheckpointSaver(HookBase):
    """Writes ``model/model_last.pth`` after every epoch (atomically),
    copies it to ``model_best.pth`` when an evaluator hook's
    ``current_metric_value`` improves and, with ``save_freq``, keeps
    ``epoch_<n>.pth`` every ``save_freq`` epochs. Rank 0 writes; every rank
    waits for it (the evaluators' metric is the same on every rank, so they
    agree on the best)."""

    def __init__(self, save_freq=None):
        self.save_freq = save_freq

    def before_train(self):
        self.ckpt_dir = os.path.abspath(
            os.path.join(self.trainer.cfg.get("save_path", "exp/default"), "model"))
        if rank() == 0:
            os.makedirs(self.ckpt_dir, exist_ok=True)

    def _save(self, name: str, state: dict):
        path = os.path.join(self.ckpt_dir, name)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)

    def after_epoch(self):
        comm = self.trainer.comm_info
        metric = comm.get("current_metric_value")
        is_best = metric is not None and metric > comm.get("best_metric_value", -math.inf)
        if is_best:
            comm["best_metric_value"] = metric
            self.trainer.logger.info(f"new best {comm.get('current_metric_name', 'metric')}: "
                                     f"{metric:.4f} (epoch {self.trainer.epoch + 1})")
        # on every rank: a tensor-parallel model's state is gathered
        state = training_state(self.trainer, self.trainer.epoch + 1)
        if rank() == 0:
            self._save("model_last.pth", state)
            if is_best:
                best = os.path.join(self.ckpt_dir, "model_best.pth")
                shutil.copyfile(os.path.join(self.ckpt_dir, "model_last.pth"), best + ".tmp")
                os.replace(best + ".tmp", best)
            if self.save_freq and (self.trainer.epoch + 1) % self.save_freq == 0:
                self._save(f"epoch_{self.trainer.epoch + 1}.pth", state)
        barrier()


@HOOKS.register_module()
class CheckpointLoader(HookBase):
    """Loads ``cfg.weight`` before training (the reference's loader): the
    state dict's names lose a DDP ``module.`` prefix and have ``keywords``
    replaced by ``replacement``. Non-strict by default, as the reference
    and the JAX hook declare it, which is how a fine-tune starts from a
    pretrained backbone: every tensor that the model lacks or whose shape
    differs is skipped, and every model tensor the checkpoint does not
    give keeps its initialization, each one logged; the load raises if not
    one ``backbone.*`` parameter loaded (a checkpoint of something else is
    no warm start). ``strict=True`` loads name for name. ``cfg.resume`` loads
    strictly and also restores the optimizer, the schedule, the generator,
    the step and the epoch to continue from."""

    def __init__(self, keywords: str = "", replacement=None, strict: bool = False):
        self.keywords = keywords
        self.replacement = replacement if replacement is not None else keywords
        self.strict = strict

    def before_train(self):
        trainer = self.trainer
        weight = trainer.cfg.get("weight")
        if not weight:
            return
        if not os.path.exists(weight):
            raise FileNotFoundError(f"checkpoint not found: {weight}")
        trainer.logger.info(f"loading checkpoint: {weight}")
        ckpt = torch.load(weight, map_location="cpu", weights_only=False)
        state = ckpt.get("state_dict", ckpt)
        state = {k.removeprefix("module.").replace(self.keywords, self.replacement)
                 if self.keywords else k.removeprefix("module."): v for k, v in state.items()}
        resume = trainer.cfg.get("resume", False)
        if self.strict or resume:
            trainer.model.load_state_dict(state, strict=True)
        else:
            load_matching(trainer.model, state, trainer.logger)
        if resume:
            trainer.optimizer.load_state_dict(ckpt["optimizer"])
            if trainer.scheduler is not None:
                trainer.scheduler.load_state_dict(ckpt["scheduler"])
            trainer.generator.set_state(ckpt["generator"])
            trainer.start_epoch = int(ckpt["epoch"])
            trainer.storage.iter = int(ckpt["step"])
            trainer.comm_info["best_metric_value"] = float(ckpt.get("best_metric", -1.0))
        trainer.logger.info(f"checkpoint loaded (resume={resume}, "
                            f"epoch={trainer.start_epoch})")


def load_matching(model: torch.nn.Module, state: dict, logger) -> list:
    """Loads the tensors of ``state`` whose name and shape the model's state
    dict has; logs every one skipped and every model tensor left as it was.
    Raises if no ``backbone.*`` parameter loaded (a BatchNorm's scalar
    ``num_batches_tracked`` matches any model). Returns the loaded names."""
    own = model.state_dict()
    loaded = {k: v for k, v in state.items() if k in own and tuple(v.shape) == tuple(own[k].shape)}
    for k, v in state.items():
        if k not in own:
            logger.info(f"skipped {k}: not in the model")
        elif k not in loaded:
            logger.info(f"skipped {k}: shape {tuple(v.shape)} in the checkpoint, "
                        f"{tuple(own[k].shape)} in the model")
    for k in own:
        if k not in loaded:
            logger.info(f"kept the initialization of {k}")
    params = dict(model.named_parameters())
    if not any(k.startswith("backbone.") and k in params for k in loaded):
        raise ValueError("the checkpoint gives no backbone.* parameter of the model's name "
                         "and shape: it is no warm start for this model")
    model.load_state_dict(loaded, strict=False)
    logger.info(f"loaded {len(loaded)} of the model's {len(own)} tensors")
    return sorted(loaded)


@HOOKS.register_module()
class PreciseEvaluator(HookBase):
    """Runs the configured testers (``cfg.test`` over ``cfg.data.test``)
    after training, on ``model_best.pth`` unless ``test_last``. Does nothing
    when the config names no tester. ``results`` keeps each tester's
    metrics."""

    def __init__(self, test_last: bool = False):
        self.test_last = test_last
        self.results = []

    def after_train(self):
        trainer, cfg = self.trainer, self.trainer.cfg
        test_cfgs, data_test = cfg.get("test"), cfg.data.get("test")
        if not test_cfgs or data_test is None:
            return
        test_cfgs = test_cfgs if isinstance(test_cfgs, (list, tuple)) else [test_cfgs]
        data_cfgs = data_test if isinstance(data_test, (list, tuple)) else [data_test]
        best = os.path.join(cfg.get("save_path", "exp/default"), "model", "model_best.pth")
        if not self.test_last and os.path.exists(best):
            ckpt = torch.load(best, map_location="cpu", weights_only=False)
            trainer.model.load_state_dict(ckpt["state_dict"], strict=True)
            trainer.logger.info("PreciseEvaluator: loaded model_best")
        backbone_cfg = cfg.model.get("backbone", cfg.model)
        patch = max(backbone_cfg.get("enc_patch_size", [1024]))
        for tc, dc in zip(test_cfgs, data_cfgs):
            tester = build_tester(tc, trainer.model, dc, patch_size=patch,
                                  seed=cfg.get("seed", 0), device=trainer.device)
            self.results.append(tester.test())


@HOOKS.register_module()
class BeginningEvaluator(HookBase):
    """Runs every evaluator hook (a hook whose type name holds "Eval") once
    before the first epoch, e.g. to score a loaded checkpoint; list it after
    them, since each builds its validation data in its own
    ``before_train``. It scores the weights the trainer holds, which is
    what ``test_last=True`` (as the shipped files set it) asks for;
    ``test_last=False`` would ask for ``model_best.pth``, which this hook
    does not load, and raises."""

    def __init__(self, test_last: bool = True):
        if not test_last:
            raise ValueError("BeginningEvaluator scores the weights the trainer holds "
                             "(test_last=True); scoring model_best.pth is not supported")

    def before_train(self):
        for h in self.trainer.hooks:
            if h is not self and "Eval" in type(h).__name__:
                self.trainer.epoch = -1
                h.after_epoch()
                self.trainer.epoch = self.trainer.start_epoch


@HOOKS.register_module()
class RuntimeProfiler(HookBase):
    """A torch.profiler trace of ``num_steps`` training steps from step
    ``start_step``: CPU activity, and the card's kernels when the trainer
    runs on one. The trace goes to ``<save_path>/profile/trace_rank<r>.json``
    (Chrome's trace format, which Perfetto reads; ``trace_path``); with
    ``exit_after`` the run then ends (``SystemExit(0)``). ``device_events``
    counts the trace's events on the card; a card trainer's trace without
    any is logged as a warning."""

    def __init__(self, start_step: int = 3, num_steps: int = 2, exit_after: bool = False):
        self.start_step = start_step
        self.num_steps = num_steps
        self.exit_after = exit_after
        self.trace_path = None
        self.device_events = None
        self._profile = None

    def before_step(self):
        if self.trainer.storage.iter != self.start_step:
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.device(self.trainer.device).type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profile = profile(activities=activities)
        self._profile.start()
        self.trainer.logger.info(f"profiler trace started at step {self.start_step}")

    def after_step(self):
        if self._profile is not None and \
                self.trainer.storage.iter >= self.start_step + self.num_steps - 1:
            self._stop()
            if self.exit_after:
                raise SystemExit(0)

    def after_train(self):
        if self._profile is not None:  # training ended inside the window
            self._stop()

    def _stop(self):
        on_card = torch.device(self.trainer.device).type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.trainer.device)
        self._profile.stop()
        path = os.path.join(self.trainer.cfg.get("save_path", "exp/default"), "profile")
        os.makedirs(path, exist_ok=True)
        self.trace_path = os.path.join(path, f"trace_rank{rank()}.json")
        self._profile.export_chrome_trace(self.trace_path)
        self.device_events = sum(str(e.device_type).endswith("CUDA")
                                 for e in self._profile.events())
        self._profile = None
        self.trainer.logger.info(f"profiler trace -> {self.trace_path}")
        if on_card and not self.device_events:
            self.trainer.logger.warning(
                "the profiler trace holds no event on the card: torch.profiler recorded "
                "no CUDA activity in this session")


@HOOKS.register_module()
class DataCacheOperator(HookBase):
    """Reads every ``<root>/<split>/<scene>/*.npy`` of the training data
    once before training, so that the first epoch's loads come from the
    page cache (the reference copies the scenes into shared memory; the
    JAX package, as the port, warms the page cache). ``data_root`` and
    ``split`` default to ``cfg.data.train``'s."""

    def __init__(self, data_root=None, split=None):
        self.data_root = data_root
        self.split = split

    def before_train(self):
        train = self.trainer.cfg.data.train
        root = self.data_root or train.get("data_root")
        splits = self.split or train.get("split", "train")
        if isinstance(splits, str):
            splits = [splits]
        n = 0
        for split in splits:
            for path in glob.glob(os.path.join(root, split, "*", "*.npy")):
                with open(path, "rb") as f:
                    while f.read(1 << 22):
                        pass
                n += 1
        self.trainer.logger.info(f"page-cache warmed for {n} asset files")
