"""MinkUNet family (counterpart of ``scenesplat_tpu/models/mink_unet.py``),
on padded batches, over SpUNet's machinery:

  - Minkowski stride-1 convolutions keep the input coordinates, so each is
    a submanifold conv over ``ops/subm_conv.py``'s plans (k=5 stem, k=3
    blocks; one plan a level);
  - the kernel-2 stride-2 convolutions and their transposes are
    ``ops/sparse_conv.py``'s strided and inverse convs over one
    z-serialization's parent clustering, clusters past a stage's capacity
    counted (``PoolingPlan.n_overflow``, the output's ``plans``);
  - BatchNorm (eps 1e-5, momentum 0.1): ``MaskedBatchNorm``.

Blocks: ``MinkBasicBlock`` (expansion 1) and ``MinkBottleneck`` (expansion
4, its 1x1 convs dense maps). The decoder concatenates [up, skip]. All 15
reference variants are registered (MinkUNet14/18/34/50/101 and the A-D
plane variants, reference mink_unet.py:365-440).

Parameter names are the reference MinkowskiEngine module's, as
``scenesplat_tpu/utils/ckpt_bridge.py:convert_mink_checkpoint`` reads
them: ``conv0p1s1.kernel``, ``bn0.bn.*``, ``conv{s}p{2^(s-1)}s2``,
``bn{s}``, ``block{k}.{i}.{conv,norm}{1,2,3}``, ``.downsample.{0,1}``,
``convtr{j}p{stride}s2``, ``bntr{j}`` and ``final``. Kernels are
Minkowski's [K, Cin, Cout] (K = k^3 taps enumerated x-major as
``kernel_offsets``; a stride-2 kernel's 8 taps as ``kernel_tap``; a 1x1
conv's [Cin, Cout]). Parameters are drawn from ``seed`` (truncated normal,
std 0.02, as the port's SpUNet)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import build_pooling_plan
from scenesplat_tpu_torch.ops.serialization import serialize
from scenesplat_tpu_torch.ops.sparse_conv import (
    build_corner_lookup,
    deconv_k3s2_apply,
    inverse_conv_apply,
    strided_conv_apply,
)
from scenesplat_tpu_torch.ops.subm_conv import build_subm_conv_plan, subm_conv_apply, subplan

from .builder import MODELS
from .norm import MaskedBatchNorm
from .ptv3 import StageState, as_dtype
from .spunet import _round_cap, _trunc_normal, downsampled_level
from .structure import PointBatch


class KernelConv(nn.Module):
    """A sparse conv's kernel (and optional ``bias``), under the name
    ``param`` (Minkowski's and torchsparse's ``kernel``; ocnn's ``weights``,
    octformer.py's OcnnConv), applied as ``mode`` says: "subm" (a
    submanifold conv over a level's plan, [K3, Cin, Cout]), "point" (a 1x1
    conv, [Cin, Cout]), "down" (kernel 2 stride 2, children -> parents,
    [8, Cin, Cout]), "up" (its transpose over the same plan, parents ->
    children) or "deconv" (kernel 3 stride 2, parents -> children through
    their corner lookup, [27, Cin, Cout])."""

    param = "kernel"

    def __init__(self, in_channels: int, out_channels: int, mode: str, kernel_size: int = 3,
                 bias: bool = False, dtype=torch.float32):
        super().__init__()
        if mode not in ("subm", "point", "down", "up", "deconv"):
            raise ValueError(f"unknown conv mode {mode!r}")
        taps = dict(subm=kernel_size ** 3, down=8, up=8, deconv=27).get(mode)
        self.mode, self.dtype = mode, dtype
        shape = (in_channels, out_channels) if taps is None else (taps, in_channels, out_channels)
        self.register_parameter(self.param, nn.Parameter(torch.empty(shape)))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    @property
    def kernel_tensor(self) -> torch.Tensor:
        return getattr(self, self.param)

    def forward(self, feat, *geometry):
        """``geometry``: "subm" (plan,); "down" (plan, the children's
        grid_coord); "up" (plan, the children's grid_coord and mask);
        "deconv" (the parent and child levels, the serialization depth)."""
        dt = self.dtype
        x, w = feat.to(dt), self.kernel_tensor.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.mode == "point":
            out = x @ w
            return out if b is None else out + b
        if self.mode == "subm":
            (plan,) = geometry
            return subm_conv_apply(x, plan, w, b)
        if self.mode == "down":
            plan, grid_coord = geometry
            return strided_conv_apply(x, plan, grid_coord, w, bias=b)
        if self.mode == "up":
            plan, child_grid, child_mask = geometry
            return inverse_conv_apply(x, plan, child_grid, w, mask=child_mask, bias=b)
        parent, child, depth = geometry
        idx, found = build_corner_lookup(parent.grid_coord, parent.mask, child.grid_coord,
                                         child.mask, depth)
        return deconv_k3s2_apply(x, idx, found, child.grid_coord, w, bias=b, mask=child.mask)


class MinkNorm(nn.Module):
    """MinkowskiBatchNorm: a BatchNorm under ``bn`` (eps 1e-5)."""

    def __init__(self, features: int, momentum: float = 0.1, dtype=torch.float32):
        super().__init__()
        self.bn = MaskedBatchNorm(features, eps=1e-5, momentum=momentum, dtype=dtype)

    def forward(self, x, mask):
        return self.bn(x, mask)


class MinkBasicBlock(nn.Module):
    """Reference BasicBlock (mink_unet.py:38-91)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, bn_momentum: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.conv1 = KernelConv(inplanes, planes, "subm", dtype=dtype)
        self.norm1 = MinkNorm(planes, bn_momentum, dtype)
        self.conv2 = KernelConv(planes, planes, "subm", dtype=dtype)
        self.norm2 = MinkNorm(planes, bn_momentum, dtype)
        if inplanes != planes:
            self.downsample = nn.ModuleList([KernelConv(inplanes, planes, "point", dtype=dtype),
                                             MinkNorm(planes, bn_momentum, dtype)])

    def forward(self, feat, level: StageState):
        x = F.relu(self.norm1(self.conv1(feat, level.conv_plan), level.mask))
        x = self.norm2(self.conv2(x, level.conv_plan), level.mask)
        return F.relu(x + residual(self, feat, level.mask))


class MinkBottleneck(nn.Module):
    """Reference Bottleneck, expansion 4 (mink_unet.py:94-156)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, bn_momentum: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        out = planes * 4
        self.conv1 = KernelConv(inplanes, planes, "point", dtype=dtype)
        self.norm1 = MinkNorm(planes, bn_momentum, dtype)
        self.conv2 = KernelConv(planes, planes, "subm", dtype=dtype)
        self.norm2 = MinkNorm(planes, bn_momentum, dtype)
        self.conv3 = KernelConv(planes, out, "point", dtype=dtype)
        self.norm3 = MinkNorm(out, bn_momentum, dtype)
        if inplanes != out:
            self.downsample = nn.ModuleList([KernelConv(inplanes, out, "point", dtype=dtype),
                                             MinkNorm(out, bn_momentum, dtype)])

    def forward(self, feat, level: StageState):
        x = F.relu(self.norm1(self.conv1(feat), level.mask))
        x = F.relu(self.norm2(self.conv2(x, level.conv_plan), level.mask))
        x = self.norm3(self.conv3(x), level.mask)
        return F.relu(x + residual(self, feat, level.mask))


def residual(block: nn.Module, feat, mask):
    """A block's shortcut: ``feat``, or its ``downsample`` conv and norm."""
    if not hasattr(block, "downsample"):
        return feat
    conv, norm = block.downsample
    return norm(conv(feat), mask)


class MinkUNetBase(nn.Module):
    """Reference MinkUNetBase (mink_unet.py:159-362): a k=5 stem, 4 stride-2
    encoder stages, 4 transposed-conv decoder stages with skip concats, and
    a 1x1 ``final`` conv to ``out_channels``. ``stage_capacity``: each
    downsample's cluster capacity as a fraction of the input's slots."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        block: str = "basic",
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        planes: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        init_dim: int = 32,
        bn_momentum: float = 0.1,
        serialization_depth: int = 16,
        stage_capacity: Sequence[float] = (0.5, 0.25, 0.125, 0.0625),
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        if block not in ("basic", "bottleneck") or len(layers) != 8 or len(planes) != 8:
            raise ValueError("block 'basic' or 'bottleneck', 8 layers and 8 planes")
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.serialization_depth = serialization_depth
        self.stage_capacity = tuple(stage_capacity)
        cls = MinkBottleneck if block == "bottleneck" else MinkBasicBlock
        e = cls.expansion

        def norm(c):
            return MinkNorm(c, bn_momentum, dtype)

        def blocks(name, inplanes, p, depth):
            self.add_module(name, nn.ModuleList(
                [cls(inplanes if i == 0 else p * e, p, bn_momentum, dtype) for i in range(depth)]))

        self.conv0p1s1 = KernelConv(in_channels, init_dim, "subm", kernel_size=5, dtype=dtype)
        self.bn0 = norm(init_dim)
        inplanes = init_dim
        for s in range(1, 5):
            self.add_module(f"conv{s}p{2 ** (s - 1)}s2",
                            KernelConv(inplanes, inplanes, "down", dtype=dtype))
            self.add_module(f"bn{s}", norm(inplanes))
            blocks(f"block{s}", inplanes, planes[s - 1], layers[s - 1])
            inplanes = planes[s - 1] * e
        skip_ch = [planes[2] * e, planes[1] * e, planes[0] * e, init_dim]
        for d in range(4):
            j, p = 4 + d, planes[4 + d]
            self.add_module(f"convtr{j}p{2 ** (4 - d)}s2",
                            KernelConv(inplanes, p, "up", dtype=dtype))
            self.add_module(f"bntr{j}", norm(p))
            blocks(f"block{5 + d}", p + skip_ch[d], p, layers[4 + d])
            inplanes = p * e
        self.final = KernelConv(inplanes, out_channels, "point", bias=True, dtype=dtype)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, KernelConv):
                _trunc_normal(mod.kernel.data, gen)
                if mod.bias is not None:
                    mod.bias.data.zero_()

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None):
        """The logits at the input points (``plans``: the four downsamples'
        pooling plans). ``generator`` is accepted for the trainers' sake
        (MinkUNet draws nothing)."""
        depth = self.serialization_depth
        n0 = point.num_points
        ser = (point.ser if point.ser is not None
               else serialize(point.grid_coord, point.mask, ("z",), depth))
        stem_plan = build_subm_conv_plan(point.grid_coord, point.mask, 5, depth)
        level = StageState(None, point.grid_coord, point.mask, ser, subplan(stem_plan, 3))
        feat = F.relu(self.bn0(self.conv0p1s1(point.feat, stem_plan), level.mask))
        skips, plans = [], []
        for s in range(1, 5):
            plan = build_pooling_plan(level.ser, level.mask,
                                      _round_cap(n0, self.stage_capacity[s - 1]), 1)
            plans.append(plan)
            skips.append((feat, level))
            x = getattr(self, f"conv{s}p{2 ** (s - 1)}s2")(feat, plan, level.grid_coord)
            level = downsampled_level(level, plan, depth)
            feat = F.relu(getattr(self, f"bn{s}")(x, level.mask))
            for blk in getattr(self, f"block{s}"):
                feat = blk(feat, level)
        for d in range(4):
            j = 4 + d
            skip_feat, level = skips.pop()
            x = getattr(self, f"convtr{j}p{2 ** (4 - d)}s2")(
                feat, plans[3 - d], level.grid_coord, level.mask)
            x = F.relu(getattr(self, f"bntr{j}")(x, level.mask))
            feat = torch.cat([x, skip_feat.to(x.dtype)], -1)
            for blk in getattr(self, f"block{5 + d}"):
                feat = blk(feat, level)
        return point.replace(feat=self.final(feat), grid_coord=level.grid_coord,
                             mask=level.mask, ser=level.ser, plans=tuple(plans))


_DEFAULT_PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
_VARIANTS = {
    # name: (block, layers, planes), reference mink_unet.py:365-440
    "MinkUNet14": ("basic", (1,) * 8, _DEFAULT_PLANES),
    "MinkUNet18": ("basic", (2,) * 8, _DEFAULT_PLANES),
    "MinkUNet34": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), _DEFAULT_PLANES),
    "MinkUNet50": ("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2), _DEFAULT_PLANES),
    "MinkUNet101": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), _DEFAULT_PLANES),
    "MinkUNet14A": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": ("basic", (1,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": ("basic", (1,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18D": ("basic", (2,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    # the JAX package's 34A planes, equal to 34C's; MinkowskiEngine's 34A
    # may end in (..., 64, 64), unchecked here
    "MinkUNet34A": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet34B": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
}


def _variant(name: str, block: str, layers, planes):
    def __init__(self, *args, block=block, layers=layers, planes=planes, **kwargs):
        MinkUNetBase.__init__(self, *args, block=block, layers=layers, planes=planes, **kwargs)

    return type(name, (MinkUNetBase,), {"__init__": __init__, "__doc__": f"Reference {name}."})


for _name, _spec in _VARIANTS.items():
    MODELS.register_module(_name)(_variant(_name, *_spec))
