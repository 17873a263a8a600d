"""Context-Aware Classifier segmentor (counterpart of
``scenesplat_tpu/models/cac.py``, reference
context_aware_classifier_v1m1_base.py:16-280) on padded batches:

  - ``post_refine_proto_batch``: each scene's soft class prototypes (the
    prediction's softmax pooling its features) refine the prediction, one
    batched product for the reference's loop over scenes;
  - ``get_adaptive_perspective``: the present classes' prototypes replaced
    by their feature means over the batch;
  - the class-entropy-weighted distillation of the refined prediction
    towards the adaptive one;
  - training returns the four-term loss (refined, adaptive and plain
    logits against ``segment`` through ``criteria``, and the
    distillation); eval returns the refined logits times ``cos_temp``.

``feat_proj_layer``'s BatchNorm runs over the valid points only (the JAX
package's flax BatchNorm also takes the padded slots into its statistics,
ROADMAP Queue 3). Under data parallel the class sums of the adaptive
perspective and of the distillation span the global batch
(``all_reduce_sum``), as the criteria and the BatchNorms do.

Parameter names are the reference's: ``seg_head`` (its weight doubles as
the prototypes), ``proj.{0,2}``, ``apd_proj.{0,2}``,
``feat_proj_layer.{0,1,3}`` and the backbone under ``backbone.``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.parallel.dist import all_reduce_sum

from .builder import MODELS, build_model
from .losses import build_criteria
from .norm import MaskedBatchNorm
from .ptv3 import Linear
from .structure import PointBatch


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (x.norm(dim=-1, keepdim=True) + eps)


def _proj(c: int, gen: torch.Generator) -> nn.Sequential:
    """Linear(2c, 2c, no bias), ReLU, Linear(2c, c): the reference's ``proj``
    / ``apd_proj`` (children 0 and 2)."""
    seq = nn.Sequential(Linear(2 * c, 2 * c, bias=False), nn.ReLU(), Linear(2 * c, c))
    seq[0].reset_parameters(gen)
    seq[2].reset_parameters(gen)
    return seq


class _FeatProj(nn.Module):
    """Linear(c, c, no bias), BatchNorm1d(c), ReLU, Linear(c, c): the
    reference's ``feat_proj_layer`` (children 0, 1 and 3), the norm over
    the valid points."""

    def __init__(self, c: int, gen: torch.Generator):
        super().__init__()
        self.add_module("0", Linear(c, c, bias=False))
        self.add_module("1", MaskedBatchNorm(c, eps=1e-5, momentum=0.1))
        self.add_module("3", Linear(c, c))
        self._modules["0"].reset_parameters(gen)
        self._modules["3"].reset_parameters(gen)

    def forward(self, x, mask):
        m = self._modules
        return m["3"](F.relu(m["1"](m["0"](x), mask)))


@MODELS.register_module("CAC-v1m1")
class CACSegmentor(nn.Module):
    def __init__(self, num_classes: int, backbone_out_channels: int, backbone: dict,
                 criteria: Optional[Sequence[dict]] = None, cos_temp: float = 15.0,
                 main_weight: float = 1.0, pre_weight: float = 1.0,
                 pre_self_weight: float = 1.0, kl_weight: float = 1.0,
                 conf_thresh: float = 0.0, detach_pre_logits: bool = False):
        super().__init__()
        c = backbone_out_channels
        self.num_classes = num_classes
        self.backbone = build_model(dict(backbone))
        self.criteria = build_criteria([dict(x) for x in criteria] if criteria else None)
        self.cos_temp = cos_temp
        self.weights = (main_weight, pre_weight, pre_self_weight, kl_weight)
        self.conf_thresh, self.detach_pre_logits = conf_thresh, detach_pre_logits
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        self.seg_head = Linear(c, num_classes)
        self.seg_head.reset_parameters(gen)
        self.proj = _proj(c, gen)
        self.apd_proj = _proj(c, gen)
        self.feat_proj_layer = _FeatProj(c, gen)

    @staticmethod
    def get_pred(x, proto):
        """Cosine scores (reference l.66-72): x [B, N, C], proto [B, cls, C]
        or [cls, C]."""
        proto = _l2n(proto)
        x = _l2n(x)
        return torch.einsum("bnc,bkc->bnk", x, proto) if proto.ndim == 3 else x @ proto.T

    def post_refine_proto_batch(self, feat, pred, proto, mask):
        """Each scene's soft prototypes refine the prediction (reference
        l.103-150)."""
        if self.detach_pre_logits:
            pred = pred.detach()
        soft = F.softmax(pred.float(), -1) * mask[..., None].float()  # [B, N, cls]
        if self.conf_thresh > 0:
            soft = soft * (soft.amax(-1, keepdim=True) >= self.conf_thresh).float()
        pred_proto = torch.einsum("bnk,bnc->bkc", soft, feat.float()) / (
            soft.sum(1)[..., None] + 1e-7)
        pred_proto = self.proj(torch.cat([pred_proto, proto.expand_as(pred_proto)], -1))
        return self.get_pred(self.feat_proj_layer(feat, mask), pred_proto)

    def get_adaptive_perspective(self, feat, target, new_proto, proto, mask):
        """The present classes' prototypes become their feature means over
        the (global) batch (reference l.76-100)."""
        valid = (mask & (target >= 0)).float()
        onehot = F.one_hot(target.clamp(min=0), self.num_classes).float() * valid[..., None]
        sums = torch.einsum("bnk,bnc->kc", onehot, feat.float())
        sums = all_reduce_sum(torch.cat([sums, onehot.sum((0, 1))[:, None]], 1))
        sums, counts = sums[:, :-1], sums[:, -1]
        new_proto = torch.where((counts > 0)[:, None], sums / (counts[:, None] + 1e-4),
                                new_proto)
        new_proto = self.apd_proj(torch.cat([new_proto, proto], -1))
        return self.get_pred(self.feat_proj_layer(feat, mask), new_proto)

    def get_distill_loss(self, pred, soft, target, mask, smoothness=0.5):
        """Class-entropy-weighted distillation (reference l.152-200), the
        class sums over the global batch."""
        soft = soft.detach().float()
        valid = mask & (target >= 0)
        sm_soft = F.softmax(soft, -1)
        onehot = F.one_hot(target.clamp(min=0), self.num_classes).float() * valid[..., None]
        smoothed = smoothness * sm_soft + (1 - smoothness) * onehot
        loss_pt = -(F.log_softmax(pred.float(), -1) * smoothed).sum(-1)  # [B, N]
        entropy = -(sm_soft * torch.log(sm_soft + 1e-4)).sum(-1) * valid.float()
        sums = all_reduce_sum(torch.stack([torch.einsum("bnk,bn->k", onehot, entropy),
                                           torch.einsum("bnk,bn->k", onehot, loss_pt * entropy),
                                           onehot.sum((0, 1))]))
        cls_weight, cls_loss, present = sums[0], sums[1], (sums[2] > 0).float()
        per_cls = cls_loss / (cls_weight + 1e-4)
        return (per_cls * present).sum() / (present.sum() + 1e-4)

    def forward(self, point: PointBatch, generator=None, segment=None):
        """Eval (or no ``segment``): the backbone output with ``feat`` the
        refined logits times ``cos_temp``. Training with ``segment``: the
        dict of ``loss``, ``seg_loss``, ``pre_loss``, ``pre_self_loss`` and
        ``kl_loss``."""
        out = self.backbone(point, generator=generator)
        feat, mask = out.feat, out.mask
        seg_logits = self.seg_head(feat.float())
        proto = self.seg_head.weight  # [cls, C]
        refine_logits = self.post_refine_proto_batch(feat, seg_logits, proto, mask) * self.cos_temp
        if not self.training or segment is None:
            return out.replace(feat=refine_logits)
        if not self.criteria.criteria:
            raise ValueError("CAC-v1m1 trains with criteria; the config sets none")
        cac_pred = self.get_adaptive_perspective(feat, segment, proto.detach(), proto,
                                                 mask) * self.cos_temp
        w_main, w_pre, w_self, w_kl = self.weights
        terms = dict(
            seg_loss=self.criteria(refine_logits, segment, mask=mask) * w_main,
            pre_loss=self.criteria(cac_pred, segment, mask=mask) * w_pre,
            pre_self_loss=self.criteria(seg_logits, segment, mask=mask) * w_self,
            kl_loss=self.get_distill_loss(refine_logits, cac_pred, segment, mask) * w_kl)
        return dict(loss=sum(terms.values()), **terms)
