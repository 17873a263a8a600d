"""LangPretrainer: backbone + L2-normalized per-Gaussian language features,
in eval and in training (counterpart of
``scenesplat_tpu/models/default.py:LangPretrainer``)."""

from __future__ import annotations

import torch
from torch import nn

from .builder import MODELS, build_model
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
