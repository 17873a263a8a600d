"""SparseUNet (SpUNet) backbone (counterpart of
``scenesplat_tpu/models/spunet.py``), on padded batches:

  - spconv.SubMConv3d, the k=5 stem and the k=3 blocks: the neighbour plans
    of ``ops/subm_conv.py``, one a level shared by its blocks (spconv's
    ``indice_key``); level 0's k=3 plan is the stem plan's subplan;
  - spconv.SparseConv3d(kernel=2, stride=2) and SparseInverseConv3d: the
    parent clustering of one z-serialization at depth 16 and the taps of
    ``ops/sparse_conv.py``; clusters past a stage's capacity are counted
    (``PoolingPlan.n_overflow``, the output's ``plans``), as in PT-v3m1;
  - BatchNorm1d(eps=1e-3, momentum): ``MaskedBatchNorm``.

Registered: SpUNet-v1m1 (the base), SpUNet-v1m2 (``bn_momentum`` 0.02),
SpUNetNoSkipBase (a decoder without skip connections) and SpUNet-v1m3
(every norm a ``PDBatchNorm`` of the batch's dataset ``condition``, taken by
name, with an optional context-modulated affine). ``cls_mode`` drops the
decoder and returns each row's masked mean, [B, C].

Parameter names are the reference's, so a reference state dict loads with
``strict=True``: spconv_unet_v1m1_base.py's ``conv_input.{0,1}``,
``down.{s}.{0,1}``, ``enc.{s}.block{i}.{conv1,bn1,conv2,bn2,proj.0,proj.1}``,
``up.{s}.{0,1}``, ``dec.{s}.block{i}.*`` and ``final``; with ``conditions``
(v1m3, spconv_unet_v1m3_pdnorm.py) ``conv_input.{conv,bn}``,
``down.{s}.{conv,bn}``, ``up.{s}.{conv,bn}``, blocks' ``proj_conv`` and
``proj_norm``, and each norm's ``bns.{c}`` (``bn`` undecoupled) and
``modulation.1``. Conv weights are spconv's [k, k, k, Cin, Cout] (the
strided and inverse convs' k = 2, tap (x&1, y&1, z&1); the 1x1 convs'
[1, 1, 1, Cin, Cout]). Parameters are drawn from ``seed`` (truncated
normal, std 0.02, as the reference initializes them)."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import (
    PoolingPlan,
    build_pooling_plan,
    masked_mean_pool,
    pool_serialization,
)
from scenesplat_tpu_torch.ops.serialization import serialize, take_along_points
from scenesplat_tpu_torch.ops.sparse_conv import inverse_conv_apply, strided_conv_apply
from scenesplat_tpu_torch.ops.subm_conv import build_subm_conv_plan, subplan

from .builder import MODELS
from .norm import MaskedBatchNorm, condition_name
from .ptv3 import Linear, PDCfg, StageState, SubMConv, _Stage, as_dtype
from .structure import PointBatch


class PDBatchNorm(nn.Module):
    """The reference v1m3's PDBatchNorm: one MaskedBatchNorm per condition
    (``bns``; one shared ``bn`` with ``decouple`` off), looked up by the
    condition's NAME, only the active one run (so only it updates its
    statistics or takes a gradient), and with ``adaptive`` the context's
    affine, ``modulation`` = SiLU + Linear(context_channels, 2 C): y * (1 +
    scale) + shift. The JAX package's CondBatchNorm takes an index into its
    own conditions and runs every norm (ROADMAP Queue 3, the PPT faults)."""

    def __init__(self, features: int, pd: PDCfg, momentum: float = 0.01,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conditions = pd.conditions
        make = lambda: MaskedBatchNorm(features, momentum=momentum, dtype=dtype)  # noqa: E731
        if pd.decouple:
            self.bns = nn.ModuleList([make() for _ in self.conditions])
        else:
            self.bn = make()
        self.modulation = (nn.Sequential(nn.SiLU(), Linear(pd.context_channels, 2 * features))
                           if pd.adaptive else None)

    def forward(self, x, mask, condition, context=None):
        if hasattr(self, "bns"):
            name = condition_name(condition)
            if name not in self.conditions:
                raise KeyError(f"condition {name!r} is not one of {self.conditions}")
            norm = self.bns[self.conditions.index(name)]
        else:
            norm = self.bn
        y = norm(x, mask)
        if self.modulation is not None and context is not None:
            shift, scale = self.modulation(context.float()).chunk(2, dim=-1)
            y = y * (1 + scale[:, None, :]) + shift[:, None, :]
        return y


def cond_batch_norm(features: int, momentum: float, pd: Optional[PDCfg], dtype) -> nn.Module:
    """CondBatchNorm: a MaskedBatchNorm at ``momentum``, or the PDBatchNorm
    (momentum 0.01, as v1m3 sets it) when ``pd`` conditions the norms."""
    if pd is None:
        return MaskedBatchNorm(features, momentum=momentum, dtype=dtype)
    return PDBatchNorm(features, pd, dtype=dtype)


def apply_norm(norm: nn.Module, x, mask, cond=None):
    """``norm`` over the valid rows; a PDBatchNorm also takes ``cond`` =
    (condition name, context or None)."""
    if isinstance(norm, PDBatchNorm):
        if cond is None or cond[0] is None:
            raise ValueError("a PDNorm-conditioned SpUNet needs the batch's condition")
        return norm(x, mask, cond[0], cond[1])
    return norm(x, mask)


def _trunc_normal(w: torch.Tensor, gen: torch.Generator):
    nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=gen)


class StridedConv(nn.Module):
    """spconv.SparseConv3d(kernel=2, stride=2); weight [2, 2, 2, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(2, 2, 2, in_channels, out_channels))

    def forward(self, feat, plan: PoolingPlan, grid_coord):
        w = self.weight.reshape(8, *self.weight.shape[3:]).to(self.dtype)
        return strided_conv_apply(feat.to(self.dtype), plan, grid_coord, w)


class InverseConv(nn.Module):
    """spconv.SparseInverseConv3d(kernel=2); weight [2, 2, 2, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(2, 2, 2, in_channels, out_channels))

    def forward(self, feat_parent, plan: PoolingPlan, child_grid_coord, child_mask):
        w = self.weight.reshape(8, *self.weight.shape[3:]).to(self.dtype)
        return inverse_conv_apply(feat_parent.to(self.dtype), plan, child_grid_coord, w,
                                  mask=child_mask)


class Pointwise(nn.Module):
    """A 1x1 submanifold conv (a linear map a point); weight [1, 1, 1, Cin,
    Cout] as spconv stores it."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(1, 1, 1, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, x):
        out = x.to(self.dtype) @ self.weight.reshape(self.weight.shape[3:]).to(self.dtype)
        return out if self.bias is None else out + self.bias.to(self.dtype)


class ConvNorm(nn.Module):
    """A conv and its norm under the reference's names: ``0`` and ``1``
    (v1m1's Sequential) or ``conv`` and ``bn`` (v1m3's wrappers)."""

    def __init__(self, conv: nn.Module, norm: nn.Module, names: Tuple[str, str]):
        super().__init__()
        self.names = names
        self.add_module(names[0], conv)
        self.add_module(names[1], norm)

    @property
    def convolution(self):
        return self._modules[self.names[0]]

    @property
    def normalization(self):
        return self._modules[self.names[1]]


class BasicBlock(nn.Module):
    """Residual block: two k=3 submanifold convs with BN and ReLU, and a 1x1
    conv and BN on the shortcut when the width changes (reference
    spconv_unet_v1m1_base.py:23-86; v1m3's ``proj_conv``/``proj_norm``)."""

    def __init__(self, in_channels: int, embed_channels: int, bn_momentum: float = 0.01,
                 pd: Optional[PDCfg] = None, dtype=torch.float32):
        super().__init__()
        c = embed_channels
        self.conv1 = SubMConv(in_channels, c, kernel_size=3, bias=False, dtype=dtype)
        self.bn1 = cond_batch_norm(c, bn_momentum, pd, dtype)
        self.conv2 = SubMConv(c, c, kernel_size=3, bias=False, dtype=dtype)
        self.bn2 = cond_batch_norm(c, bn_momentum, pd, dtype)
        if in_channels != c:
            conv, norm = Pointwise(in_channels, c, dtype=dtype), cond_batch_norm(
                c, bn_momentum, pd, dtype)
            if pd is None:
                self.proj = nn.ModuleList([conv, norm])
            else:
                self.proj_conv, self.proj_norm = conv, norm

    def forward(self, feat, level: StageState, cond=None):
        """``level``: the resolution's geometry (its ``coord`` unused)."""
        x = F.relu(apply_norm(self.bn1, self.conv1(feat, level.conv_plan), level.mask, cond))
        x = apply_norm(self.bn2, self.conv2(x, level.conv_plan), level.mask, cond)
        residual = feat
        if hasattr(self, "proj"):
            residual = apply_norm(self.proj[1], self.proj[0](feat), level.mask, cond)
        elif hasattr(self, "proj_conv"):
            residual = apply_norm(self.proj_norm, self.proj_conv(feat), level.mask, cond)
        return F.relu(x + residual)


def make_level(grid_coord, mask, ser, depth: int) -> StageState:
    """A resolution's geometry: its voxels, serialization and k=3 plan."""
    return StageState(None, grid_coord, mask, ser,
                      build_subm_conv_plan(grid_coord, mask, 3, depth))


def downsampled_level(level: StageState, plan, depth: int) -> StageState:
    """The parents of ``level``'s voxels under a depth-1 pooling ``plan``."""
    grid = take_along_points(level.grid_coord, plan.head_index) >> 1
    return make_level(grid, plan.out_mask, pool_serialization(plan, level.ser, 1), depth)


def _round_cap(n: int, frac: float) -> int:
    return min(n, max(16, int(math.ceil(n * frac / 16)) * 16))


@MODELS.register_module("SpUNet-v1m1")
class SpUNet(nn.Module):
    """Reference SpUNet-v1m1 (spconv_unet_v1m1_base.py:88-280). ``skip``
    off is SpUNetNoSkipBase; ``conditions`` makes it SpUNet-v1m3.
    ``stage_capacity`` gives each downsample's cluster capacity as a
    fraction of the input's slots (halving by default)."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int = 0,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 3, 4, 6, 2, 2, 2, 2),
        cls_mode: bool = False,
        skip: bool = True,
        bn_momentum: float = 0.01,
        serialization_depth: int = 16,
        stage_capacity: Optional[Sequence[float]] = None,
        conditions: Optional[Sequence[str]] = None,
        pd_decouple: bool = True,
        pd_adaptive: bool = False,
        context_channels: int = 256,
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        if len(layers) % 2 or len(layers) != len(channels):
            raise ValueError("channels and layers: one entry a stage, encoder then decoder")
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.num_stages = len(layers) // 2
        self.cls_mode, self.skip = cls_mode, skip
        self.serialization_depth = serialization_depth
        self.stage_capacity = tuple(
            stage_capacity or (0.5 ** s for s in range(1, self.num_stages + 1)))
        if len(self.stage_capacity) < self.num_stages:
            raise ValueError("stage_capacity needs one fraction per downsample")
        pd = (PDCfg(tuple(conditions), decouple=pd_decouple, adaptive=pd_adaptive,
                    context_channels=context_channels) if conditions else None)
        self.conditions = None if pd is None else pd.conditions
        names = ("0", "1") if pd is None else ("conv", "bn")

        def norm(c):
            return cond_batch_norm(c, bn_momentum, pd, dtype)

        def blocks(n, c_in, c):  # children block{i}, the reference's SparseSequential names
            return _Stage([BasicBlock(c_in if i == 0 else c, c, bn_momentum, pd, dtype)
                           for i in range(n)])

        self.conv_input = ConvNorm(
            SubMConv(in_channels, base_channels, kernel_size=5, bias=False, dtype=dtype),
            norm(base_channels), names)
        self.down, self.enc = nn.ModuleList(), nn.ModuleList()
        self.up, self.dec = nn.ModuleList(), nn.ModuleList()
        enc_ch, dec_ch, n_ch = base_channels, channels[-1], len(channels)
        for s in range(self.num_stages):
            self.down.append(ConvNorm(StridedConv(enc_ch, channels[s], dtype), norm(channels[s]),
                                      names))
            self.enc.append(blocks(layers[s], channels[s], channels[s]))
            if not cls_mode:
                up_in, up_out = channels[n_ch - s - 2], dec_ch
                self.up.append(ConvNorm(InverseConv(up_in, up_out, dtype), norm(up_out), names))
                self.dec.append(blocks(layers[n_ch - s - 1],
                                       up_out + enc_ch if skip else up_out, up_out))
            enc_ch, dec_ch = channels[s], channels[n_ch - s - 2]
        final_in = channels[self.num_stages - 1] if cls_mode else channels[-1]
        self.final = (Pointwise(final_in, num_classes, bias=True, dtype=dtype)
                      if num_classes > 0 else None)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (SubMConv, StridedConv, InverseConv, Pointwise, Linear)):
                _trunc_normal(mod.weight.data, gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.data.zero_()

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None,
                condition=None, context: Optional[torch.Tensor] = None):
        """Returns the decoder output at the input points (``plans``: the
        downsamples' pooling plans), or in ``cls_mode`` each row's mean
        [B, C]. ``generator`` is accepted for the trainers' sake (SpUNet
        draws nothing). With ``conditions``, ``condition`` names the batch's
        dataset and ``context`` [B, context_channels] feeds the adaptive
        norms."""
        cond = None if self.conditions is None else (condition, context)
        depth = self.serialization_depth
        ser = (point.ser if point.ser is not None
               else serialize(point.grid_coord, point.mask, ("z",), depth))
        n0 = point.num_points
        stem_plan = build_subm_conv_plan(point.grid_coord, point.mask, 5, depth)
        level = StageState(None, point.grid_coord, point.mask, ser, subplan(stem_plan, 3))
        stem = self.conv_input
        feat = F.relu(apply_norm(stem.normalization,
                                 stem.convolution(point.feat.to(self.dtype), stem_plan),
                                 level.mask, cond))
        skips, plans = [], []
        for s in range(self.num_stages):
            plan = build_pooling_plan(level.ser, level.mask,
                                      _round_cap(n0, self.stage_capacity[s]), 1)
            plans.append(plan)
            skips.append((feat, level))
            x = self.down[s].convolution(feat, plan, level.grid_coord)
            level = downsampled_level(level, plan, depth)
            feat = F.relu(apply_norm(self.down[s].normalization, x, level.mask, cond))
            for blk in self.enc[s].blocks():
                feat = blk(feat, level, cond)
        if not self.cls_mode:
            for s in reversed(range(self.num_stages)):
                skip_feat, skip_level = skips.pop()
                up = self.up[s]
                x = up.convolution(feat, plans[s], skip_level.grid_coord, skip_level.mask)
                x = F.relu(apply_norm(up.normalization, x, skip_level.mask, cond))
                level = skip_level
                feat = torch.cat([x, skip_feat], -1) if self.skip else x
                for blk in self.dec[s].blocks():
                    feat = blk(feat, level, cond)
        if self.final is not None:
            feat = self.final(feat)
        if self.cls_mode:
            return masked_mean_pool(feat, level.mask)
        return point.replace(feat=feat, grid_coord=level.grid_coord, mask=level.mask,
                             ser=level.ser, plans=tuple(plans))


@MODELS.register_module("SpUNet-v1m2")
class SpUNetV1M2(SpUNet):
    """SpUNet with ``bn_momentum`` 0.02 by default (reference
    spconv_unet_v1m2_bn_momentum.py)."""

    def __init__(self, *args, bn_momentum: float = 0.02, **kwargs):
        super().__init__(*args, bn_momentum=bn_momentum, **kwargs)


@MODELS.register_module("SpUNetNoSkipBase")
class SpUNetNoSkip(SpUNet):
    """A decoder without skip connections (reference
    spconv_unet_v1m1_base.py:283-464)."""

    def __init__(self, *args, skip: bool = False, **kwargs):
        super().__init__(*args, skip=skip, **kwargs)


@MODELS.register_module("SpUNet-v1m3")
class SpUNetV1M3(SpUNet):
    """Prompt-driven normalization for Point Prompt Training (reference
    spconv_unet_v1m3_pdnorm.py:230-438): every norm a PDBatchNorm of the
    batch's condition, adaptive by default."""

    def __init__(self, *args, conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
                 pd_adaptive: bool = True, **kwargs):
        super().__init__(*args, conditions=conditions, pd_adaptive=pd_adaptive, **kwargs)
