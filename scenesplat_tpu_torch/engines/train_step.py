"""One training step of the VL pretraining task (counterpart of
``scenesplat_tpu/engines/train_step.py``, task ``"lang"``).

bf16 compute comes from the model's compute dtype over fp32 parameters, so
no GradScaler is needed. The loss reads ``lang_feat`` upcast to fp32; the
step runs backward, clips the gradient's global norm, steps the optimizer
and the schedule, and returns the loss and the gradient norm before
clipping (the JAX step's ``optax.global_norm(grads)``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from scenesplat_tpu_torch.models.structure import PointBatch

_INT_KEYS = ("grid_coord", "segment")


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """Collated numpy arrays -> tensors on ``device`` (integer keys as
    int64); other entries pass through."""
    out = {}
    for k, v in batch.items():
        if hasattr(v, "dtype") and hasattr(v, "shape"):
            t = torch.as_tensor(v).to(device, non_blocking=True)
            out[k] = t.long() if k in _INT_KEYS else t
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


def train_step(model, criteria, optimizer, scheduler, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, epoch_progress=None,
               clip_grad: Optional[float] = None) -> Dict[str, torch.Tensor]:
    """One step in train mode; returns {"loss", "grad_norm"} as 0-d tensors
    on the model's device (no host sync)."""
    model.train()
    loss, _ = lang_loss(model, criteria, batch, generator, epoch_progress)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    grad_norm = apply_gradients(optimizer, scheduler, clip_grad)
    return dict(loss=loss.detach(), grad_norm=grad_norm)


def apply_gradients(optimizer, scheduler, clip_grad: Optional[float] = None) -> torch.Tensor:
    """Clip the gradients' global norm to ``clip_grad`` (torch divides by
    norm + 1e-6, optax by the norm), step the optimizer and the schedule;
    returns the norm before clipping."""
    params = [p for g in optimizer.param_groups for p in g["params"] if p.grad is not None]
    if clip_grad is not None and clip_grad > 0:
        grad_norm = torch.nn.utils.clip_grad_norm_(params, clip_grad)
    else:
        grad_norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(p.grad.float()) for p in params]))
    optimizer.step()
    if scheduler is not None:
        scheduler.step()
    return grad_norm.detach()
