"""One training step (counterpart of ``scenesplat_tpu/engines/train_step.py``)
of the VL pretraining task (``"lang"``), of semantic segmentation
(``"semseg"``), of PointGroup instance segmentation (``"insseg"``), of Masked
Scene Contrast pretraining (``"msc"``: the model takes the raw two-view
batch and returns its loss terms) or of the Context-Aware Classifier
(``"cac"``: its four-term loss computed in the model).

bf16 compute comes from the model's compute dtype over fp32 parameters, so
no GradScaler is needed. The lang loss reads ``lang_feat`` upcast to fp32,
the semseg loss the logits against ``segment``; Point Prompt Training
(``"ppt"``) is semseg with the batch's dataset ``condition`` handed to the
model, whose logits are in that condition's class space. The insseg loss
reads the model's logits and centre biases against ``segment``,
``instance`` and ``instance_centroid`` (``models/point_group.py``). The
step runs backward, clips the gradient's global norm, steps the optimizer
and the schedule, and returns the loss and the gradient norm before
clipping (the JAX step's ``optax.global_norm(grads)``).

Under data parallel the step takes the model under DistributedDataParallel.
The lang loss's reductions span the global batch (``parallel/dist.py``), so
every process holds the global loss, and its backward gives each process
``world`` times its rows' share of the global gradient; DDP's mean over the
processes leaves the global gradient on every one, which the clipping and
the gradient norm then read.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from scenesplat_tpu_torch.models.point_group import pointgroup_loss
from scenesplat_tpu_torch.models.structure import PointBatch
from scenesplat_tpu_torch.parallel.dist import all_reduce_, check_same_on_ranks, layout

_INT_KEYS = ("grid_coord", "segment")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Collated numpy arrays -> tensors on ``device`` (integer keys, the SSL
    crops' ``<crop>_grid_coord`` too, as int64); other entries pass
    through."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "dtype") and hasattr(v, "shape"):
            t = torch.as_tensor(v).to(device, non_blocking=True)
            out[k] = t.long() if k.endswith(_INT_KEYS) else t
        else:
            out[k] = v
    return out


def point_from_batch(batch: Dict[str, torch.Tensor]) -> PointBatch:
    """A batch that carries a serialization (``ser``) keeps it: the model
    then skips its own, curve shuffle included."""
    return PointBatch(coord=batch["coord"], feat=batch["feat"],
                      grid_coord=batch["grid_coord"], mask=batch["mask"],
                      ser=batch.get("ser"))


def lang_loss(model, criteria, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None, epoch_progress=None,
              split: Optional[torch.Tensor] = None):
    """Forward and loss; returns (loss, model output)."""
    out = model(point_from_batch(batch), generator=generator)
    loss = criteria(out.feat, batch["lang_feat"].float(),
                    valid_feat_mask=batch.get("valid_feat_mask"), mask=out.mask,
                    segment=batch.get("segment"), epoch_progress=epoch_progress,
                    generator=generator, split=split)
    return loss, out


def semseg_loss(model, criteria, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, epoch_progress=None):
    """Forward and loss of semantic segmentation (the losses take no
    schedule: ``epoch_progress`` is unused); returns (loss, model output)."""
    out = model(point_from_batch(batch), generator=generator)
    return criteria(out.feat, batch["segment"], mask=out.mask), out


def ppt_loss(model, criteria, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, epoch_progress=None):
    """semseg_loss of a PPT model on the batch's one ``condition`` (the name
    its dataset's ``Add`` set); under data parallel every process must hold
    the same condition (checked each step), since the model's parameters
    that take gradients depend on it."""
    ppt = getattr(model, "module", model)  # under DDP, the model itself
    index = ppt.condition_index(batch["condition"])
    check_same_on_ranks(index, len(ppt.conditions), batch["coord"].device, "condition")
    out = model(point_from_batch(batch), generator=generator, condition=batch["condition"])
    return criteria(out.feat, batch["segment"], mask=out.mask), out


def insseg_loss(model, criteria, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None, epoch_progress=None):
    """PointGroup's semantic, bias L1 and bias cosine terms of the model's
    (logits, bias); the semantic term is ``criteria``'s, or the model's
    cross-entropy with its ``semantic_ignore_index`` when the config sets
    none. Returns (loss, the backbone output with the logits)."""
    pg = getattr(model, "module", model)  # under DDP, the model itself
    out, bias = model(point_from_batch(batch), generator=generator)
    loss, _ = pointgroup_loss(out.feat, bias, out.coord, batch["segment"], batch["instance"],
                              batch["instance_centroid"], out.mask, criteria,
                              semantic_ignore_index=pg.semantic_ignore_index,
                              instance_ignore_index=pg.instance_ignore_index)
    return loss, out


def msc_loss(model, criteria, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, epoch_progress=None):
    """Masked Scene Contrast: the model takes the two-view batch and
    returns its loss and terms (``criteria`` unused); returns (loss, the
    model's dict)."""
    out = model(batch, generator=generator)
    return out["loss"], out


def cac_loss(model, criteria, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None, epoch_progress=None):
    """The Context-Aware Classifier's four-term loss, computed in the model
    with its own criteria against ``segment``; returns (loss, the model's
    dict)."""
    out = model(point_from_batch(batch), generator=generator, segment=batch["segment"])
    return out["loss"], out


TASK_LOSSES = {"lang": lang_loss, "semseg": semseg_loss, "ppt": ppt_loss,
               "insseg": insseg_loss, "msc": msc_loss, "cac": cac_loss}


def train_step(model, criteria, optimizer, scheduler, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, epoch_progress=None,
               clip_grad: Optional[float] = None, task: str = "lang"
               ) -> Dict[str, torch.Tensor]:
    """One step in train mode of ``task`` (a key of ``TASK_LOSSES``);
    returns {"loss", "grad_norm"} as 0-d tensors on the model's device (no
    host sync), and for a model that returns its loss terms (MSC, CAC)
    ``terms``: each of them, detached."""
    model.train()
    loss, out = TASK_LOSSES[task](model, criteria, batch, generator, epoch_progress)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = apply_gradients(optimizer, scheduler, clip_grad)
    metrics = dict(loss=loss.detach(), grad_norm=grad_norm)
    if isinstance(out, dict):
        metrics["terms"] = {k: v.detach() for k, v in out.items() if k != "loss"}
    return metrics


def global_grad_norm(params) -> torch.Tensor:
    """The L2 norm of the whole gradient. Under tensor parallel
    (``parallel/tp.py``) a rank holds its share of each sharded parameter
    (``tp_sharded``): their squares are summed over the model group, the
    replicated parameters' counted once, so every rank holds one process's
    norm."""
    norms = [torch.linalg.vector_norm(p.grad.float()) for p in params]
    if layout().model == 1:
        return torch.linalg.vector_norm(torch.stack(norms))
    sharded = [n for p, n in zip(params, norms) if getattr(p, "tp_sharded", False)]
    whole = [n for p, n in zip(params, norms) if not getattr(p, "tp_sharded", False)]
    zero = norms[0].new_zeros(())
    sq = all_reduce_(sum((n * n for n in sharded), zero)[None], layout().model_group)
    return (sq[0] + sum((n * n for n in whole), zero)).sqrt()


def average_replicated_grads(params) -> None:
    """Under tensor parallel, the mean over the model group of the
    gradients of the parameters every model rank holds whole (norms, CPE,
    pooling, heads): equal in exact arithmetic, they differ in their last
    bits where a kernel sums in an order of its own (the card's scatter-adds),
    and the replicated weights must not drift apart."""
    grid = layout()
    grads = [p.grad for p in params if not getattr(p, "tp_sharded", False)]
    if grid.model == 1 or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, grid.model_group).div_(grid.model)
    for g, mean in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(mean.view_as(g))


def apply_gradients(optimizer, scheduler, clip_grad: Optional[float] = None) -> torch.Tensor:
    """Clip the gradients' global norm to ``clip_grad`` (torch divides by
    norm + 1e-6, optax by the norm), step the optimizer and the schedule;
    returns the norm before clipping (``global_grad_norm``: under tensor
    parallel every rank clips by one process's norm, after
    ``average_replicated_grads``)."""
    params = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    average_replicated_grads(params)
    grad_norm = global_grad_norm(params)
    if clip_grad is not None and clip_grad > 0:  # torch's clip_grad_norm_ arithmetic
        coef = (clip_grad / (grad_norm + 1e-6)).clamp(max=1.0)
        for p in params:
            p.grad.mul_(coef.to(p.grad.dtype))
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return grad_norm.detach()
