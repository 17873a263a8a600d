"""OA-CNNs, omni-adaptive sparse CNNs (counterpart of
``scenesplat_tpu/models/oacnns.py``), on padded batches:

  - the sparse convs are SpUNet's (``models/spunet.py``'s submanifold,
    strided and inverse convs over one z-serialization's plans);
  - each encoder stage clusters its voxels on three grids
    (``ops/pointops.py:grid_cluster_plan``), and every block aggregates
    adaptively over them: per scale, softmax weights inside each cluster
    and a cluster sum; then a per-point softmax mixes the scales.

The in-cluster softmax subtracts the largest logit over the batch's REAL
points, as the reference does (oacnns_v1m1_base.py:88-110); the JAX module
takes it over every slot, padding included, so its output moves with the
padding's content. BatchNorm is eps 1e-3, momentum 0.01 (the JAX
module's).

Parameter names are the reference's, as
``scenesplat_tpu/utils/ckpt_bridge.py:convert_oacnns_checkpoint`` reads
them: ``stem.{0,1,3,4,6,7}``, ``enc.{i}.down.{0,1}``,
``enc.{i}.blocks.{d}.{l_w.{j}.{0,1}, weight.{j}, proj.{j}.{0,1},
adaptive, fuse.{0,1}, voxel_block.{0,1,3,4}}``, ``dec.{i}.up.{0,1}``,
``dec.{i}.fuse.{0,1,3,4}`` and ``final``; spconv's kernels [k, k, k, Cin,
Cout]."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops import pointops
from scenesplat_tpu_torch.ops.segops import at_least_fp32, build_pooling_plan, pool_values
from scenesplat_tpu_torch.ops.serialization import serialize

from .builder import MODELS
from .norm import MaskedBatchNorm
from .ptv3 import Linear, StageState, SubMConv, as_dtype
from .spunet import (InverseConv, Pointwise, StridedConv, _round_cap, _trunc_normal,
                     downsampled_level, make_level)
from .structure import PointBatch


def _bn(c, dtype):
    return MaskedBatchNorm(c, dtype=dtype)


class LinBNReLU(nn.Module):
    """Linear + BN + ReLU under ``{0,1}`` (the blocks' projections have no
    bias; the decoder's fuse keeps torch's default bias)."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.add_module("0", Linear(in_channels, out_channels, bias=bias, dtype=dtype))
        self.add_module("1", _bn(out_channels, dtype))

    def forward(self, x, mask):
        return F.relu(self._modules["1"](self._modules["0"](x), mask))


def cluster_sum(plan, values):
    """Each point's cluster sum of ``values`` [B, N, C], in fp32."""
    return pool_values(plan, at_least_fp32(values), "sum").gather(
        1, plan.cluster_of_point.unsqueeze(-1).expand(-1, -1, values.shape[-1]))


class OABasicBlock(nn.Module):
    """Adaptive multi-scale aggregation and two submanifold convs
    (reference oacnns_v1m1_base.py:12-110)."""

    def __init__(self, embed_channels: int, num_scales: int, dtype=torch.float32):
        super().__init__()
        c = embed_channels
        self.l_w = nn.ModuleList([LinBNReLU(c, c, dtype=dtype) for _ in range(num_scales)])
        self.weight = nn.ModuleList([Linear(c, c, bias=False, dtype=dtype)
                                     for _ in range(num_scales)])
        self.proj = nn.ModuleList([LinBNReLU(c, c, dtype=dtype) for _ in range(num_scales + 1)])
        self.adaptive = Linear(c, num_scales, bias=False, dtype=dtype)
        self.fuse = LinBNReLU(2 * c, c, dtype=dtype)
        self.voxel_block = nn.ModuleDict({"0": SubMConv(c, c, 3, bias=False, dtype=dtype),
                                          "1": _bn(c, dtype),
                                          "3": SubMConv(c, c, 3, bias=False, dtype=dtype),
                                          "4": _bn(c, dtype)})

    def forward(self, feat, level: StageState, plans):
        mask = level.mask
        keep = mask[..., None]
        feats = []
        for i, plan in enumerate(plans):
            pw = self.l_w[i](feat, mask)
            mean = pool_values(plan, pw, "mean")
            pw = pw - mean.gather(1, plan.cluster_of_point.unsqueeze(-1).expand_as(pw))
            pw = at_least_fp32(self.weight[i](pw))
            top = torch.where(keep, pw, float("-inf")).amax().detach()
            pw = torch.exp(pw - top) * keep
            pw = pw / (cluster_sum(plan, pw) + 1e-6)
            pfeat = self.proj[i](feat, mask) * pw.to(feat.dtype)
            feats.append(cluster_sum(plan, pfeat).to(feat.dtype))
        adp = torch.softmax(at_least_fp32(self.adaptive(feat)), -1).to(feat.dtype)
        mixed = torch.einsum("bns,bnsc->bnc", adp, torch.stack(feats, 2))
        x = torch.cat([self.proj[-1](feat, mask), mixed], -1)
        x = self.fuse(x, mask) + feat
        vb = self.voxel_block
        y = F.relu(vb["1"](vb["0"](x, level.conv_plan), mask))
        y = vb["4"](vb["3"](y, level.conv_plan), mask)
        return F.relu(y + x)


class _Down(nn.Module):
    def __init__(self, in_channels, out_channels, dtype):
        super().__init__()
        self.add_module("0", StridedConv(in_channels, out_channels, dtype))
        self.add_module("1", _bn(out_channels, dtype))


class _Up(nn.Module):
    def __init__(self, in_channels, out_channels, dtype):
        super().__init__()
        self.add_module("0", InverseConv(in_channels, out_channels, dtype))
        self.add_module("1", _bn(out_channels, dtype))


class _Fuse(nn.Module):
    """The decoder's fuse, ``{0,1}`` and ``{3,4}``: two Linear + BN."""

    def __init__(self, in_channels, out_channels, dtype):
        super().__init__()
        self.add_module("0", Linear(in_channels, out_channels, dtype=dtype))
        self.add_module("1", _bn(out_channels, dtype))
        self.add_module("3", Linear(out_channels, out_channels, dtype=dtype))
        self.add_module("4", _bn(out_channels, dtype))


@MODELS.register_module("OACNNs")
class OACNNs(nn.Module):
    """Reference OACNNs (oacnns_v1m1_base.py:214-345): a three-conv stem,
    encoder stages of a strided conv and adaptive blocks over
    ``point_grid_size``'s cluster grids, decoder stages of an inverse conv
    fused with the skip, and a 1x1 ``final`` conv."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        embed_channels: int = 64,
        enc_channels: Sequence[int] = (64, 64, 128, 256),
        groups: Sequence[int] = (2, 4, 8, 16),
        enc_depth: Sequence[int] = (2, 3, 6, 4),
        dec_channels: Sequence[int] = (96, 96, 128, 256),
        point_grid_size: Sequence[Sequence[int]] = ((16, 32, 64), (8, 16, 24), (4, 8, 12),
                                                    (2, 4, 6)),
        dec_depth: Sequence[int] = (2, 2, 2, 2),
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
        self.point_grid_size = tuple(tuple(g) for g in point_grid_size)
        c0 = embed_channels
        self.stem = nn.ModuleDict()
        for i in range(3):
            self.stem[str(3 * i)] = SubMConv(in_channels if i == 0 else c0, c0, 3, bias=False,
                                             dtype=dtype)
            self.stem[str(3 * i + 1)] = _bn(c0, dtype)
        self.enc = nn.ModuleList()
        enc_in = c0
        for s, c in enumerate(enc_channels):
            stage = nn.Module()
            stage.down = _Down(enc_in, c, dtype)
            stage.blocks = nn.ModuleList([OABasicBlock(c, len(self.point_grid_size[s]), dtype)
                                          for _ in range(enc_depth[s])])
            self.enc.append(stage)
            enc_in = c
        self.dec = nn.ModuleList()
        for s, c in enumerate(dec_channels):
            in_ch = enc_channels[-1] if s == len(enc_channels) - 1 else dec_channels[s + 1]
            skip = c0 if s == 0 else enc_channels[s - 1]
            stage = nn.Module()
            stage.up = _Up(in_ch, c, dtype)
            stage.fuse = _Fuse(c + skip, c, dtype)
            self.dec.append(stage)
        self.final = (Pointwise(dec_channels[0], num_classes, bias=True, dtype=dtype)
                      if num_classes > 0 else None)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (SubMConv, StridedConv, InverseConv, Pointwise)):
                _trunc_normal(mod.weight.data, gen)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.data.zero_()
            elif isinstance(mod, Linear):
                mod.reset_parameters(gen)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None):
        """The logits at the input points (``plans``: the downsamples'
        pooling plans). ``generator`` is accepted for the trainers' sake
        (OACNNs draws nothing)."""
        depth = self.serialization_depth
        n0 = point.num_points
        ser = (point.ser if point.ser is not None
               else serialize(point.grid_coord, point.mask, ("z",), depth))
        level = make_level(point.grid_coord, point.mask, ser, depth)
        feat = point.feat
        for i in range(3):
            x = self.stem[str(3 * i)](feat, level.conv_plan)
            feat = F.relu(self.stem[str(3 * i + 1)](x, level.mask))
        skips, plans = [(feat, level)], []
        for s, stage in enumerate(self.enc):
            plan = build_pooling_plan(level.ser, level.mask,
                                      _round_cap(n0, self.stage_capacity[s]), 1)
            plans.append(plan)
            x = stage.down._modules["0"](feat, plan, level.grid_coord)
            level = downsampled_level(level, plan, depth)
            feat = F.relu(stage.down._modules["1"](x, level.mask))
            n_here = level.mask.shape[1]
            scale_plans = [pointops.grid_cluster_plan(level.grid_coord.float(), level.mask,
                                                      float(g), n_here)
                           for g in self.point_grid_size[s]]
            for blk in stage.blocks:
                feat = blk(feat, level, scale_plans)
            skips.append((feat, level))
        feat, level = skips.pop()
        for s in reversed(range(len(self.dec))):
            skip_feat, level = skips.pop()
            up, fuse = self.dec[s].up._modules, self.dec[s].fuse._modules
            x = up["0"](feat, plans[s], level.grid_coord, level.mask)
            x = F.relu(up["1"](x, level.mask))
            y = torch.cat([x, skip_feat.to(x.dtype)], -1)
            y = F.relu(fuse["1"](fuse["0"](y), level.mask))
            feat = F.relu(fuse["4"](fuse["3"](y), level.mask)) + x
        if self.final is not None:
            feat = self.final(feat)
        return point.replace(feat=feat, grid_coord=level.grid_coord, mask=level.mask,
                             ser=level.ser, plans=tuple(plans))
