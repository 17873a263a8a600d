"""Task heads over the backbone, in eval and in training (counterpart of
``scenesplat_tpu/models/default.py``): ``LangPretrainer`` (L2-normalized
per-Gaussian language features), ``DefaultSegmentorV2`` (a linear
segmentation head), the v1 ``DefaultSegmentor`` (the backbone emits the
logits: PTv1, PTv2), ``DefaultSegmentorSkip`` (fc-LN-ReLU twice, then fc),
``DefaultPretrainer`` (the backbone's features) and ``DefaultClassifier``
(a mean over each row's points, then an MLP to class logits). Each head's
parameters are drawn from the backbone's ``seed`` + 1; a forward's
``generator`` draws the backbone's training randomness."""

from __future__ import annotations

import torch
from torch import nn

from scenesplat_tpu_torch.ops.segops import masked_mean_pool

from .builder import MODELS, build_model
from .norm import LayerNorm
from .ptv3 import Linear
from .structure import PointBatch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Row-wise L2 normalization in fp32, returned in x's dtype."""
    xf = x.float()
    return (xf / xf.norm(dim=-1, keepdim=True).clamp(min=eps)).to(x.dtype)


@MODELS.register_module()
class LangPretrainer(nn.Module):
    def __init__(self, backbone: dict):
        super().__init__()
        self.backbone = build_model(dict(backbone))

    def forward(self, point: PointBatch, generator=None) -> PointBatch:
        """``generator`` draws the backbone's training randomness."""
        out = self.backbone(point, generator=generator)
        return out.replace(feat=l2_normalize(out.feat))


@MODELS.register_module()
class DefaultSegmentorV2(nn.Module):
    """Backbone plus a linear ``seg_head`` to ``num_classes`` logits; with
    ``num_classes <= 0`` the backbone's features. The head computes in fp32
    whatever the backbone's dtype, as flax's ``nn.Dense`` promotes a bf16
    input with fp32 parameters, so the logits are fp32. Its parameters are
    drawn from the backbone's ``seed``."""

    def __init__(self, num_classes: int, backbone_out_channels: int, backbone: dict):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.seg_head = None
        if num_classes > 0:
            self.seg_head = Linear(backbone_out_channels, num_classes, dtype=torch.float32)
            self.seg_head.reset_parameters(
                torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1))

    def forward(self, point: PointBatch, generator=None) -> PointBatch:
        out = self.backbone(point, generator=generator)
        return out if self.seg_head is None else out.replace(feat=self.seg_head(out.feat))


@MODELS.register_module("DefaultPretrainer")
@MODELS.register_module()
class DefaultSegmentor(nn.Module):
    """The v1 segmentor, whose backbone ends in its classifier. As
    ``DefaultPretrainer``, the backbone's per-point features (the JAX
    package's head, which a feature-distillation loss reads): the same
    forward. Keywords go on to the backbone (a PartSeg backbone's
    ``cls_token``)."""

    def __init__(self, backbone: dict):
        super().__init__()
        self.backbone = build_model(dict(backbone))

    def forward(self, point: PointBatch, generator=None, **kwargs) -> PointBatch:
        return self.backbone(point, generator=generator, **kwargs)


@MODELS.register_module()
class DefaultSegmentorSkip(nn.Module):
    """Backbone plus a deep head: fc1 (256) - ln1 - ReLU - fc2 (128) - ln2 -
    ReLU - fc3 (``num_classes``), fp32 (names as the JAX package's)."""

    def __init__(self, num_classes: int, backbone_out_channels: int, backbone: dict):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.fc1 = Linear(backbone_out_channels, 256)
        self.ln1 = LayerNorm(256)
        self.fc2 = Linear(256, 128)
        self.ln2 = LayerNorm(128)
        self.fc3 = Linear(128, num_classes)
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.reset_parameters(gen)

    def forward(self, point: PointBatch, generator=None) -> PointBatch:
        out = self.backbone(point, generator=generator)
        x = torch.relu(self.ln1(self.fc1(out.feat)))
        x = torch.relu(self.ln2(self.fc2(x)))
        return out.replace(feat=self.fc3(x))


@MODELS.register_module()
class DefaultClassifier(nn.Module):
    """Backbone, the mean over each row's valid points of its output (a
    PT-v3m1 in ``cls_mode``: the coarsest stage), then fc1 (256) - ReLU -
    fc2 (128) - ReLU - fc3 (``num_classes``); returns logits [B,
    num_classes]. The mean is taken in the backbone's dtype and the head
    computes in fp32, as the JAX package's flax head promotes a bf16 input
    with fp32 parameters. The head holds no BatchNorm or dropout: the JAX
    head has none (Pointcept's puts BatchNorm1d and Dropout(0.5) after fc1
    and fc2), and the port follows the JAX package."""

    def __init__(self, backbone: dict, num_classes: int = 40, backbone_embed_dim: int = 256):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.fc1 = Linear(backbone_embed_dim, 256)
        self.fc2 = Linear(256, 128)
        self.fc3 = Linear(128, num_classes)
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        for fc in (self.fc1, self.fc2, self.fc3):
            fc.reset_parameters(gen)

    def forward(self, point: PointBatch, generator=None) -> torch.Tensor:
        out = self.backbone(point, generator=generator)
        x = torch.relu(self.fc1(masked_mean_pool(out.feat, out.mask)))
        return self.fc3(torch.relu(self.fc2(x)))
