"""Self-supervised (SimDINO) pretraining (counterpart of
``scenesplat_tpu/engines/pretrain.py``).

A step (``ssl_train_step``) runs the composed loss of ``ssl_loss``: two
teacher passes over the global crops (no gradient, train mode, as the JAX
teacher runs with ``train=True``: drop-path on, BatchNorm on the batch's
moments and updating the teacher's own running statistics), then the
student over the two globals with their token masks and over the
``local_crop_num`` locals unmasked, in that order; MCR over the pooled
coarsest encoder stages (DINO head), the iBOT cosine loss over the masked
decoder tokens and the MAE reconstruction of the first global crop's
features. Then backward, clipping, AdamW with OneCycle and the EMA of the
student backbone into the teacher at the host-scheduled momentum
(``cosine_scheduler``, 0.994 -> 1.0 by default), the teacher's
``mask_token`` left as it is. Every draw (masks, curve shuffle, drop-path)
comes from the trainer's ``torch.Generator``. The JAX trainer also builds a
teacher-temperature schedule that nothing reads; the port has none.

Under data parallel (``torchrun``) the loss runs as ``SSLObjective``'s
forward under DistributedDataParallel; its reductions over the batch (the
BatchNorm moments, MCR's similarities and covariances, the iBOT sum, the
MAE mean) span the global batch and the token masks are drawn at its
shape, so N processes train what one process trains on the whole batch.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from scenesplat_tpu_torch.data import Loader, build_dataset
from scenesplat_tpu_torch.data.collate import collate_ssl
from scenesplat_tpu_torch.models.ssl import (
    SimDINOSSL,
    cosine_patch_loss,
    generate_token_masks,
    mcr_loss,
)
from scenesplat_tpu_torch.models.structure import PointBatch
from scenesplat_tpu_torch.ops.segops import masked_mean_pool
from scenesplat_tpu_torch.parallel.dist import all_reduce_sum

from .train import TRAINERS, Trainer
from .train_step import apply_gradients, batch_to_device


def cosine_scheduler(base: float, final: float, total_steps: int, warmup_steps: int = 0,
                     start_warmup: float = 0.0):
    """Step -> value: a linear warmup from ``start_warmup``, then a cosine
    from ``base`` to ``final`` over the remaining steps."""

    def fn(step):
        step = np.clip(step, 0, max(total_steps - 1, 1))
        if warmup_steps > 0 and step < warmup_steps:
            return start_warmup + (base - start_warmup) * step / warmup_steps
        t = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        return final + 0.5 * (base - final) * (1 + math.cos(math.pi * t))

    return fn


def point_from(batch: Dict[str, torch.Tensor], prefix: str) -> PointBatch:
    return PointBatch(coord=batch[f"{prefix}_coord"], feat=batch[f"{prefix}_feat"],
                      grid_coord=batch[f"{prefix}_grid_coord"], mask=batch[f"{prefix}_mask"])


def _crop_masks(batch, prefix, generator, mask_type, mask_grid_size, mask_ratio_min_max,
                mask_sample_probability):
    """The crop's injected token mask and weights (``<prefix>_token_mask``,
    ``<prefix>_mask_weight`` in the batch, as the tests give JAX's), else
    drawn from ``generator``."""
    if f"{prefix}_token_mask" in batch:
        return batch[f"{prefix}_token_mask"], batch[f"{prefix}_mask_weight"]
    return generate_token_masks(generator, batch[f"{prefix}_coord"], batch[f"{prefix}_mask"],
                                mask_type, mask_grid_size, mask_ratio_min_max,
                                mask_sample_probability)


def ssl_loss(model: SimDINOSSL, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, local_crop_num: int = 3,
             do_ema: bool = True, do_ibot: bool = True, enable_mae: bool = False,
             dino_weight: float = 1.0, ibot_weight: float = 1.0, mae_weight: float = 1.0,
             mask_type: str = "patch", mask_grid_size: float = 0.2,
             mask_ratio_min_max=(0.1, 0.5), mask_sample_probability: float = 0.5):
    """The composed SimDINO loss; returns (loss, metrics: each term as a 0-d
    tensor under the JAX package's name)."""
    if do_ibot and not do_ema:
        raise ValueError("the iBOT loss reads the teacher's tokens: do_ibot needs do_ema")
    masking = (mask_type, mask_grid_size, tuple(mask_ratio_min_max), mask_sample_probability)
    g0, g1 = point_from(batch, "global_crop0"), point_from(batch, "global_crop1")
    tm0, w0 = _crop_masks(batch, "global_crop0", generator, *masking)
    tm1, w1 = _crop_masks(batch, "global_crop1", generator, *masking)

    metrics = {}
    loss = 0.0
    if do_ema:  # the teacher: no token masks, no gradient
        with torch.no_grad():
            t_dec0, t_enc0, t_em0 = model.teacher(g0, generator=generator, return_enc=True)
            t_dec1, t_enc1, t_em1 = model.teacher(g1, generator=generator, return_enc=True)
            t_heads = [model.dino_head(masked_mean_pool(t_enc0, t_em0)),
                       model.dino_head(masked_mean_pool(t_enc1, t_em1))]

    s_dec0, s_enc0, s_em0 = model.backbone(g0, generator=generator, token_mask=tm0,
                                           return_enc=True)
    s_dec1, s_enc1, s_em1 = model.backbone(g1, generator=generator, token_mask=tm1,
                                           return_enc=True)
    s_pool = [masked_mean_pool(s_enc0, s_em0), masked_mean_pool(s_enc1, s_em1)]
    for i in range(local_crop_num):
        _, l_enc, l_em = model.backbone(point_from(batch, f"local_crop{i}"),
                                        generator=generator, return_enc=True)
        s_pool.append(masked_mean_pool(l_enc, l_em))

    if do_ema:
        dino, mcr_metrics = mcr_loss([model.dino_head(p) for p in s_pool], t_heads)
        loss = loss + dino_weight * dino
        metrics.update(mcr_metrics)
        metrics["sim_dino_crops_loss"] = dino

    if do_ibot:
        s_tok = torch.cat([model.ibot_head(s_dec0.feat), model.ibot_head(s_dec1.feat)], 1)
        with torch.no_grad():
            t_tok = torch.cat([model.ibot_head(t_dec0.feat), model.ibot_head(t_dec1.feat)], 1)
        w = torch.cat([w0 * tm0, w1 * tm1], 1).reshape(-1)
        d = s_tok.shape[-1]
        ib = cosine_patch_loss(s_tok.reshape(-1, d), t_tok.reshape(-1, d), w, view_nums=1)
        loss = loss + ibot_weight * ib
        metrics["sim_ibot_patch_loss"] = ib

    if enable_mae:
        pred = model.mae_head(s_dec0.feat)
        se = ((pred - batch["global_crop0_feat"].float()) ** 2).mean(-1)
        total, count = all_reduce_sum(torch.stack([(se * tm0).sum(), tm0.sum().float()]))
        mae = total / count.clamp(min=1)
        loss = loss + mae_weight * mae
        metrics["global_mae_loss"] = mae

    metrics["loss"] = loss
    return loss, metrics


@torch.no_grad()
def ema_update(model: SimDINOSSL, momentum: float) -> None:
    """teacher = m * teacher + (1 - m) * student over the backbone's
    parameters, the mask token excepted (the reference skips it); m and
    1 - m rounded to fp32 as the JAX step computes them."""
    student = dict(model.backbone.named_parameters())
    names = [n for n, _ in model.teacher.named_parameters() if n != "mask_token"]
    teacher = dict(model.teacher.named_parameters())
    m = np.float32(momentum)
    t = [teacher[n] for n in names]
    torch._foreach_mul_(t, float(m))
    torch._foreach_add_(t, [student[n] for n in names], alpha=float(np.float32(1) - m))


class SSLObjective(nn.Module):
    """``ssl_loss`` of ``model`` as one module's forward: under
    DistributedDataParallel every student pass then runs inside the one
    forward whose backward DDP reduces (DDP sees only calls through its
    wrapper). The teacher's parameters take no gradient, so they stay out
    of DDP's buckets."""

    def __init__(self, model: SimDINOSSL):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor], generator=None, **loss_kwargs):
        return ssl_loss(self.model, batch, generator, **loss_kwargs)


def ssl_train_step(model, optimizer, scheduler, batch: Dict[str, torch.Tensor],
                   momentum: float, generator: Optional[torch.Generator] = None,
                   clip_grad: Optional[float] = None, **loss_kwargs) -> Dict[str, torch.Tensor]:
    """One SSL step in train mode of ``model``: a SimDINOSSL, or its
    ``SSLObjective`` under DistributedDataParallel (every process then
    holds the global loss and DDP's mean is the global gradient, which
    every process applies: the EMA leaves the same teacher on each).
    Returns the loss terms and ``grad_norm`` (before clipping) as 0-d
    tensors on the model's device (no host sync)."""
    objective = SSLObjective(model) if isinstance(model, SimDINOSSL) else model
    ssl_model = getattr(objective, "module", objective).model
    objective.train()
    loss, metrics = objective(batch, generator, **loss_kwargs)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    metrics["grad_norm"] = apply_gradients(optimizer, scheduler, clip_grad)
    ema_update(ssl_model, momentum)
    return {k: v.detach() for k, v in metrics.items()}


def build_ssl_model(model_cfg: dict):
    """(SimDINOSSL, the loss's keyword arguments) from an SSL model config:
    its wrapper keywords (crops, loss switches and weights, masking) go to
    the loss, ``backbone`` and the ``dino_*`` / ``ibot_*`` widths to the
    model; the MAE head reconstructs the backbone's ``in_channels``."""
    ssl = dict(model_cfg)
    ssl.pop("type", None)
    loss_kwargs = dict(
        local_crop_num=ssl.pop("local_crop_num", 3),
        do_ema=ssl.pop("do_ema", True),
        do_ibot=ssl.pop("do_ibot", True),
        enable_mae=ssl.pop("enable_mae_loss", False),
        dino_weight=ssl.pop("dino_weight", 1.0),
        ibot_weight=ssl.pop("ibot_weight", 1.0),
        mae_weight=ssl.pop("mae_weight", 1.0),
        mask_type=ssl.pop("mask_type", "patch"),
        mask_grid_size=ssl.pop("mask_grid_size", 0.2),
        mask_ratio_min_max=tuple(ssl.pop("mask_ratio_min_max", (0.1, 0.5))),
        mask_sample_probability=ssl.pop("mask_sample_probability", 0.5),
    )
    backbone = dict(ssl.pop("backbone"))
    model = SimDINOSSL(backbone=backbone, enable_mae=loss_kwargs["enable_mae"],
                       mae_out_dim=backbone.get("in_channels", 11),
                       **{k: v for k, v in ssl.items() if k.startswith(("dino_", "ibot_"))})
    return model, loss_kwargs


@TRAINERS.register_module("DefaultSSLPreTrainer")
class DefaultSSLPreTrainer(Trainer):
    """The SimDINO pretraining loop: the model and the loss's arguments from
    ``build_ssl_model``, the EMA momentum from ``cosine_scheduler``; the
    loader collates crops with ``collate_ssl``."""

    TASKS = {"SimDINOSSL": "ssl", "DefaultContrastiverSimDinoV2": "ssl"}

    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device=device)
        self.momentum_schedule = cosine_scheduler(cfg.model.get("momentum_base", 0.994),
                                                  cfg.model.get("momentum_final", 1.0),
                                                  self.total_steps)

    def build_model(self, model_cfg: dict) -> SimDINOSSL:
        model, self.loss_kwargs = build_ssl_model(model_cfg)
        return model

    def train_module(self) -> nn.Module:
        return SSLObjective(self.model)

    def build_train_loader(self):
        data = self.cfg.data
        num_points = data.get("num_points", 65536)
        collate = partial(collate_ssl, global_points=num_points,
                          local_points=data.get("num_points_local", num_points // 4),
                          local_crop_num=self.cfg.model.get("local_crop_num", 3))
        return Loader(build_dataset(dict(data.train)), batch_size=self.cfg.get("batch_size", 1),
                      num_points=num_points, seed=self.cfg.get("seed", 0),
                      num_workers=self.cfg.get("num_worker", 4), collate_fn=collate)

    def run_step(self, batch):
        lr = self.optimizer.param_groups[0]["lr"]
        metrics = ssl_train_step(self.train_model, self.optimizer, self.scheduler,
                                 batch_to_device(batch, self.device),
                                 self.momentum_schedule(self.storage.iter),
                                 generator=self.generator, clip_grad=self.clip_grad,
                                 **self.loss_kwargs)
        values = torch.stack([v.float() for v in metrics.values()]).tolist()  # one sync
        self.storage.put_scalars(**dict(zip(metrics, values)), lr=lr)
