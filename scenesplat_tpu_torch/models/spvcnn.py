"""SPVCNN, sparse point-voxel CNN (counterpart of
``scenesplat_tpu/models/spvcnn.py``), on padded batches:

  - the voxel branch is SpUNet's machinery (``models/mink_unet.py``'s
    kernels over the submanifold plans and the k=2 stride-2 strided and
    inverse convs);
  - point -> voxel (``point_to_voxel``): the masked mean of the points'
    features in each level voxel, through the composed point-to-level map;
  - voxel -> point (``voxel_to_point``): trilinear interpolation over the 8
    corner voxels of each point's cell at the level's stride, found by
    ``ops/subm_conv.py:lookup_voxels``; missing corners weigh 0 and the
    rest are renormalized;
  - the input is one point a voxel (GridSample), so the reference's
    initial voxelization is the identity.

BatchNorm everywhere is torch's default (eps 1e-5, momentum 0.1), the
point branch's over the real points only. DROPOUT is the reference's
fixed nn.Dropout rate ahead of the first and third up stages, drawn from
the forward's ``generator``.

Parameter names are the reference's (ts_spvcnn.py), as
``scenesplat_tpu/utils/ckpt_bridge.py:convert_spvcnn_checkpoint`` reads
them: ``stem.{0,1,3,4}``, ``stage{s}.0.net.{0,1}``,
``stage{s}.{i}.net.{0,1,3,4}`` and ``.downsample.{0,1}``,
``up{j}.0.net.{0,1}``, ``up{j}.1.{i}.*``, ``point_transforms.{t}.{0,1}``
and ``classifier.0``; torchsparse kernels are [K, Cin, Cout] (a 1x1
conv's [Cin, Cout])."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import at_least_fp32, build_pooling_plan
from scenesplat_tpu_torch.ops.serialization import serialize, take_along_points
from scenesplat_tpu_torch.ops.subm_conv import lookup_voxels

from .builder import MODELS
from .mink_unet import KernelConv
from .norm import MaskedBatchNorm
from .ptv3 import Linear, StageState, as_dtype, dropout
from .spunet import _round_cap, _trunc_normal, downsampled_level, make_level
from .structure import PointBatch


# the reference's fixed nn.Dropout(0.3) ahead of the first and third up stages
DROPOUT = 0.3


def _bn(c, dtype):
    return MaskedBatchNorm(c, eps=1e-5, momentum=0.1, dtype=dtype)


def point_to_voxel(feat_pt, point2level, pt_mask, num_voxels: int):
    """Masked mean of point features [B, N0, C] into the level's
    ``num_voxels`` slots (reference spvoxelize, ts_spvcnn.py:43-74);
    ``point2level`` [B, N0] each point's voxel."""
    b, _, c = feat_pt.shape
    seg = torch.where(pt_mask, point2level, num_voxels)
    x = at_least_fp32(feat_pt)
    sums = x.new_zeros(b, num_voxels + 1, c).scatter_add_(
        1, seg.unsqueeze(-1).expand_as(x), x)
    counts = x.new_zeros(b, num_voxels + 1).scatter_add_(1, seg, pt_mask.to(x.dtype))
    return (sums[:, :num_voxels] / counts[:, :num_voxels, None].clamp(min=1.0)).to(feat_pt.dtype)


def voxel_to_point(feat_vox, level: StageState, grid_coord0, pt_mask, stride_log2: int,
                   depth: int):
    """Trilinear devoxelization (reference spdevoxelize + calc_ti_weights,
    ts_spvcnn.py:78-123): each point [B, N0] mixes the 8 corner voxels of
    its cell at the level's stride 2**stride_log2; a missing corner weighs
    0 and the others are renormalized."""
    s = 1 << stride_log2
    g0 = grid_coord0.to(torch.int64)
    base = g0 >> stride_log2  # [B, N0, 3]
    frac = (g0 - (base << stride_log2)).to(torch.float32) / s
    corners = torch.tensor([(x, y, z) for x in (0, 1) for y in (0, 1) for z in (0, 1)],
                           dtype=torch.int64, device=g0.device)  # [8, 3]
    idx, found = lookup_voxels(level.grid_coord, level.mask,
                               base[:, None, :, :] + corners[None, :, None, :], depth)
    w = (1.0 - (frac[:, None] - corners[None, :, None].to(frac)).abs()).clamp(min=0).prod(-1)
    w = torch.where(found & pt_mask[:, None], w, 0.0)  # [B, 8, N0]
    b, _, n0 = idx.shape
    g = take_along_points(feat_vox, idx.reshape(b, 8 * n0)).view(b, 8, n0, -1)
    out = (g * w[..., None].to(g.dtype)).sum(1)
    return out / w.sum(1).clamp(min=1e-8)[..., None].to(out.dtype)


class ConvBNReLU(nn.Module):
    """torchsparse Conv3d k3 s1 + BN + ReLU under ``net.{0,1}``, or ``mode``
    "down" / "up": the k=2 stride-2 conv and its transpose."""

    def __init__(self, in_channels: int, out_channels: int, mode: str = "subm",
                 dtype=torch.float32):
        super().__init__()
        self.net = nn.ModuleDict({"0": KernelConv(in_channels, out_channels, mode, dtype=dtype),
                                  "1": _bn(out_channels, dtype)})

    def forward(self, feat, mask, *geometry):
        return F.relu(self.net["1"](self.net["0"](feat, *geometry), mask))


class SPVResidualBlock(nn.Module):
    """Reference ResidualBlock (ts_spvcnn.py:152-176): ``net.{0,1,3,4}``
    and, when the width changes, ``downsample.{0,1}``."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        c = out_channels
        self.net = nn.ModuleDict({"0": KernelConv(in_channels, c, "subm", dtype=dtype),
                                  "1": _bn(c, dtype),
                                  "3": KernelConv(c, c, "subm", dtype=dtype),
                                  "4": _bn(c, dtype)})
        if in_channels != c:
            self.downsample = nn.ModuleDict({"0": KernelConv(in_channels, c, "point", dtype=dtype),
                                             "1": _bn(c, dtype)})

    def forward(self, feat, level: StageState):
        net = self.net
        x = F.relu(net["1"](net["0"](feat, level.conv_plan), level.mask))
        x = net["4"](net["3"](x, level.conv_plan), level.mask)
        res = feat
        if hasattr(self, "downsample"):
            res = self.downsample["1"](self.downsample["0"](feat), level.mask)
        return F.relu(x + res)


class PointTransform(nn.Module):
    """Linear + BN + ReLU of the point branch, ``{0,1}``."""

    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.add_module("0", Linear(in_channels, out_channels, dtype=dtype))
        self.add_module("1", _bn(out_channels, dtype))

    def forward(self, x, mask):
        return F.relu(self._modules["1"](self._modules["0"](x), mask))


@MODELS.register_module("SPVCNN")
class SPVCNN(nn.Module):
    """Reference SPVCNN (ts_spvcnn.py:178-440): a two-conv stem, 4 encoder
    stages (a strided conv and residual blocks), 4 up stages (an inverse
    conv, the skip concat and residual blocks), and the point branch
    joining at strides 16, 4 and 1."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        base_channels: int = 32,
        channels: Sequence[int] = (32, 64, 128, 256, 256, 128, 96, 96),
        layers: Sequence[int] = (2, 2, 2, 2, 2, 2, 2, 2),
        serialization_depth: int = 16,
        stage_capacity: Sequence[float] = (0.5, 0.25, 0.125, 0.0625),
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.serialization_depth = serialization_depth
        self.stage_capacity = tuple(stage_capacity)
        self.layers = tuple(layers)
        ch, bc = tuple(channels), base_channels
        self.stem = nn.ModuleDict({"0": KernelConv(in_channels, bc, "subm", dtype=dtype),
                                   "1": _bn(bc, dtype),
                                   "3": KernelConv(bc, bc, "subm", dtype=dtype),
                                   "4": _bn(bc, dtype)})
        enc_in = bc
        for s in range(4):
            self.add_module(f"stage{s + 1}", nn.ModuleList(
                [ConvBNReLU(enc_in, enc_in, "down", dtype)]
                + [SPVResidualBlock(enc_in if i == 0 else ch[s], ch[s], dtype)
                   for i in range(layers[s])]))
            enc_in = ch[s]
        skip = (ch[2], ch[1], ch[0], bc)
        up_in = ch[3]
        for j in range(4):
            out_c = ch[4 + j]
            self.add_module(f"up{j + 1}", nn.ModuleList([
                ConvBNReLU(up_in, out_c, "up", dtype),
                nn.ModuleList([SPVResidualBlock(out_c + skip[j] if i == 0 else out_c, out_c, dtype)
                               for i in range(layers[4 + j])])]))
            up_in = out_c
        self.point_transforms = nn.ModuleList([PointTransform(bc, ch[3], dtype),
                                               PointTransform(ch[3], ch[5], dtype),
                                               PointTransform(ch[5], ch[7], dtype)])
        self.classifier = nn.Sequential(Linear(ch[7], out_channels, dtype=dtype))
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, KernelConv):
                _trunc_normal(mod.kernel.data, gen)
            elif isinstance(mod, Linear):
                mod.reset_parameters(gen)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None):
        """The logits at the input points (``plans``: the four downsamples'
        pooling plans); a training forward draws its dropout from
        ``generator``."""
        depth = self.serialization_depth
        n0 = point.num_points
        pt_mask, grid0 = point.mask, point.grid_coord
        ser = (point.ser if point.ser is not None
               else serialize(grid0, pt_mask, ("z",), depth))
        level0 = make_level(grid0, pt_mask, ser, depth)
        stem = self.stem
        x = F.relu(stem["1"](stem["0"](point.feat, level0.conv_plan), pt_mask))
        x0 = F.relu(stem["4"](stem["3"](x, level0.conv_plan), pt_mask))

        levels, plans, enc_feats = [level0], [], [x0]
        p2l = [torch.arange(n0, device=grid0.device).expand(pt_mask.shape[0], n0)]
        feat, level = x0, level0
        for s in range(4):
            down, *blocks = getattr(self, f"stage{s + 1}")
            plan = build_pooling_plan(level.ser, level.mask,
                                      _round_cap(n0, self.stage_capacity[s]), 1)
            plans.append(plan)
            y = down.net["0"](feat, plan, level.grid_coord)
            level = downsampled_level(level, plan, depth)
            feat = F.relu(down.net["1"](y, level.mask))
            for blk in blocks:
                feat = blk(feat, level)
            levels.append(level)
            p2l.append(take_along_points(plan.cluster_of_point, p2l[-1]))
            enc_feats.append(feat)

        def point_transform(t, x):
            return self.point_transforms[t](x, pt_mask)

        def up_stage(j, vox_feat, to_lv):
            up, blocks = getattr(self, f"up{j}")
            lv = levels[to_lv]
            y = up(vox_feat, lv.mask, plans[to_lv], lv.grid_coord, lv.mask)
            y = torch.cat([y, enc_feats[to_lv].to(y.dtype)], -1)
            for blk in blocks:
                y = blk(y, lv)
            return y

        p = DROPOUT if self.training else 0.0
        z1 = voxel_to_point(feat, levels[4], grid0, pt_mask, 4, depth) + point_transform(0, x0)
        y1_in = dropout(point_to_voxel(z1, p2l[4], pt_mask, levels[4].mask.shape[1]).to(
            self.dtype), p, generator)
        y2 = up_stage(2, up_stage(1, y1_in, 3), 2)
        z2 = voxel_to_point(y2, levels[2], grid0, pt_mask, 2, depth) + point_transform(1, z1)
        y3_in = dropout(point_to_voxel(z2, p2l[2], pt_mask, levels[2].mask.shape[1]).to(
            self.dtype), p, generator)
        y4 = up_stage(4, up_stage(3, y3_in, 1), 0)
        z3 = y4 + point_transform(2, z2)
        return point.replace(feat=self.classifier(z3), mask=pt_mask, plans=tuple(plans))
