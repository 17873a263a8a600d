"""OctFormer (counterpart of ``scenesplat_tpu/models/octformer.py``), on
padded batches, over the serialization machinery:

  - the octree's shuffled-key order is the z-order curve: its leaves are
    grid cells of ``octree_scale_factor / 2**(octree_depth - 1)``, its
    levels depth-1 pooling plans (``ops/segops.py``), its k=3 convs
    submanifold convs over ``ops/subm_conv.py``'s plans and its k=2
    stride-2 convs the strided conv of ``ops/sparse_conv.py``;
  - ``OctreeAttention``: dense softmax attention over windows of
    ``patch_size`` points of the z-sorted, padded sequence; dilation d
    groups each block of K*d points into d windows of stride d by pure
    reshapes; the RPE tables' three per-axis biases are summed into the
    logits, invalid keys masked at -1e3 (the reference's value). It stays
    plain torch: the port's window-attention kernel takes no additive
    bias and masks with -inf, another function;
  - the CPE is a depthwise 27-tap submanifold conv
    (``ops/subm_conv.py:subm_dwconv_apply``) and a BatchNorm;
  - drop path removes a whole scene's residual branch, drawn from the
    forward's ``generator``;
  - the FPN decoder unpools through the stage plans and the head's
    OctreeDeconv(k=3, s=2) (``ops/sparse_conv.py:deconv_k3s2_apply``) goes
    back through the stem's pools.

``quantization`` "ocnn" (the reference's): a point's leaf is floor((coord /
scale + 1) * 2**(depth - 1)), clipped to [0, 2**depth) (a room beyond
+-scale metres merges its outer leaves there); points that share a leaf
are mean-pooled and take the leaf's output back. "cmin": cells of scale /
2**depth from each row's smallest coordinate, one leaf a point.

BatchNorm: eps 1e-5; momentum 0.1 in the CPE, the stage downsamples and
the head (torch's BatchNorm1d), 0.01 in ocnn's conv-BN-ReLU modules (stem,
FPN, head-up deconvs).

Parameter names are the reference's (octformer_v1m1_base.py), as
``scenesplat_tpu/utils/ckpt_bridge.py:convert_octformer_checkpoint`` reads
them: ``patch_embed.{convs,downsamples}.{i}.{conv,bn}``,
``patch_embed.proj``, ``layers.{s}.blocks.{i}.{cpe.{conv,bn}, norm1,
attention.{qkv,proj,rpe.rpe_table}, norm2, mlp.{fc1,fc2}}``,
``downsamples.{s}.{conv,norm}``, ``decoder.conv1x1.{i}``,
``decoder.conv3x3.{i}``, ``decoder.up_conv.{i}`` and ``seg_head.{0,1,3}``;
ocnn's conv ``weights`` [taps, Cin, Cout] (the CPE's [27, C])."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.segops import (
    at_least_fp32,
    build_pooling_plan,
    pool_serialization,
    pool_values,
    unpool_values,
)
from scenesplat_tpu_torch.ops.serialization import serialize, take_along_points
from scenesplat_tpu_torch.ops.subm_conv import subm_dwconv_apply
from scenesplat_tpu_torch.parallel.dist import batch_rand

from .builder import MODELS
from .mink_unet import KernelConv
from .norm import LayerNorm, MaskedBatchNorm
from .ptv3 import Linear, StageState, as_dtype
from .spunet import _round_cap, _trunc_normal, downsampled_level, make_level
from .structure import PointBatch


def _bn(c, momentum, dtype):
    return MaskedBatchNorm(c, eps=1e-5, momentum=momentum, dtype=dtype)


def drop_path(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """ocnn's OctreeDropPath: each scene (row of [B, N, C]) keeps its
    branch with probability 1 - p, scaled by 1 / (1 - p)."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("a training forward with drop path needs a torch.Generator")
    keep = batch_rand((x.shape[0], 1, 1), generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class OcnnConv(KernelConv):
    """An ocnn conv: KernelConv with its kernel under ``weights``."""

    param = "weights"


class ConvBn(nn.Module):
    """A conv and its BatchNorm under ``conv`` and ``norm_name``."""

    def __init__(self, conv: nn.Module, norm: nn.Module, norm_name: str = "bn"):
        super().__init__()
        self.conv = conv
        self.norm_name = norm_name
        self.add_module(norm_name, norm)

    def forward(self, feat, level: StageState, *geometry, relu: bool = True):
        y = self._modules[self.norm_name](self.conv(feat, *geometry), level.mask)
        return F.relu(y) if relu else y


class DWConv(nn.Module):
    """OctreeDWConv's ``weights`` [27, C]."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weights = nn.Parameter(torch.empty(27, channels))

    def forward(self, feat, level: StageState):
        return subm_dwconv_apply(feat.to(self.dtype), level.conv_plan,
                                 self.weights.to(self.dtype))


class RPE(nn.Module):
    """The per-axis relative-position tables, ``rpe_table`` [3 (2 b + 1),
    heads] with b = int(0.8 * K * sqrt(dilation))."""

    def __init__(self, patch_size: int, num_heads: int, dilation: int):
        super().__init__()
        self.pos_bnd = int(0.8 * patch_size * dilation ** 0.5)
        self.rpe_num = 2 * self.pos_bnd + 1
        self.rpe_table = nn.Parameter(torch.empty(3 * self.rpe_num, num_heads))

    def forward(self, coord_w):
        """coord_w [B, W, K, 3] -> bias [B, W, H, K, K]."""
        rel = coord_w[:, :, :, None, :] - coord_w[:, :, None, :, :]
        rel = rel.clamp(-self.pos_bnd, self.pos_bnd) + self.pos_bnd  # [B, W, K, K, 3]
        bias = 0.0
        for axis in range(3):  # F.embedding: its backward is a row sum, not an index_put
            bias = bias + F.embedding(axis * self.rpe_num + rel[..., axis], self.rpe_table)
        return bias.permute(0, 1, 4, 2, 3)


class OctreeAttention(nn.Module):
    """Windowed attention with dilation and RPE (reference l.196-268)."""

    def __init__(self, dim: int, patch_size: int, num_heads: int, dilation: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.dim, self.patch_size, self.num_heads, self.dilation = (
            dim, patch_size, num_heads, dilation)
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        self.rpe = RPE(patch_size, num_heads, dilation)

    def forward(self, feat, level: StageState):
        c, h, k, d = self.dim, self.num_heads, self.patch_size, self.dilation
        b, n = level.mask.shape
        hd = c // h
        block = k * d
        l_pad = -(-n // block) * block
        order, inverse = level.ser.order[0], level.ser.inverse[0]

        def sort_pad(x):
            s = take_along_points(x, order)
            return F.pad(s, (0, 0) * (x.dim() - 2) + (0, l_pad - n))

        def dilate(x):  # [B, L, ...] -> [B, L // K, K, ...]
            rest = x.shape[2:]
            x = x.reshape((b, l_pad // block, k, d) + rest).transpose(2, 3)
            return x.reshape((b, l_pad // k, k) + rest)

        qkv = dilate(sort_pad(self.qkv(feat))).reshape(b, -1, k, 3, h, hd)
        valid = dilate(sort_pad(level.mask))
        coord = dilate(sort_pad(level.grid_coord.to(torch.int64)))
        q = qkv[..., 0, :, :].transpose(2, 3) * hd ** -0.5  # [B, W, H, K, hd]
        kk = qkv[..., 1, :, :].transpose(2, 3)
        v = qkv[..., 2, :, :].transpose(2, 3)
        attn = at_least_fp32(q @ kk.transpose(-1, -2)) + self.rpe(coord)
        attn = torch.where(valid[:, :, None, None, :], attn, -1e3)
        attn = torch.softmax(attn, -1)
        out = (attn.to(v.dtype) @ v).transpose(2, 3).reshape(b, l_pad // k, k, c)
        out = out.reshape(b, l_pad // block, d, k, c).transpose(2, 3).reshape(b, l_pad, c)
        return self.proj(take_along_points(out[:, :n], inverse))


class _MLP(nn.Module):
    def __init__(self, c: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Linear(c, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, c, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class _CPE(nn.Module):
    def __init__(self, c: int, dtype):
        super().__init__()
        self.conv = DWConv(c, dtype)
        self.bn = _bn(c, 0.1, dtype)

    def forward(self, feat, level):
        return self.bn(self.conv(feat, level), level.mask)


class OctFormerBlock(nn.Module):
    """CPE, attention and MLP, each residual branch under drop path
    (reference l.275-316)."""

    def __init__(self, dim: int, num_heads: int, patch_size: int, dilation: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.cpe = _CPE(dim, dtype)
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attention = OctreeAttention(dim, patch_size, num_heads, dilation, dtype)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.mlp = _MLP(dim, int(dim * mlp_ratio), dtype)

    def forward(self, feat, level: StageState, generator=None):
        p = self.drop_path if self.training else 0.0
        feat = feat + self.cpe(feat, level)
        feat = feat + drop_path(self.attention(self.norm1(feat), level), p, generator)
        return feat + drop_path(self.mlp(self.norm2(feat)), p, generator)


class _Stage(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class _PatchEmbed(nn.Module):
    def __init__(self, convs, downsamples, proj):
        super().__init__()
        self.convs, self.downsamples, self.proj = nn.ModuleList(convs), nn.ModuleList(
            downsamples), proj


class _Decoder(nn.Module):
    def __init__(self, conv1x1, conv3x3, up_conv):
        super().__init__()
        self.conv1x1, self.conv3x3, self.up_conv = (
            nn.ModuleList(conv1x1), nn.ModuleList(conv3x3), nn.ModuleList(up_conv))


@MODELS.register_module("OctFormer-v1m1")
class OctFormer(nn.Module):
    """Reference OctFormer (octformer_v1m1_base.py:507-630): a patch embed
    of ``stem_down`` conv + downsample pairs, stages of OctFormer blocks
    (every second one dilated) joined by k=2 stride-2 downsamples, the FPN
    decoder, ``head_up`` deconvs back through the stem's pools, and the
    seg head. ``stage_capacity``: each pool's cluster capacity as a
    fraction of the input's slots (0.7 * 0.5**i by default)."""

    def __init__(
        self,
        in_channels: int,
        num_classes: int,
        fpn_channels: int = 168,
        channels: Sequence[int] = (96, 192, 384, 384),
        num_blocks: Sequence[int] = (2, 2, 18, 2),
        num_heads: Sequence[int] = (6, 12, 24, 24),
        patch_size: int = 26,
        stem_down: int = 2,
        head_up: int = 2,
        dilation: int = 4,
        drop_path: float = 0.5,
        octree_scale_factor: float = 10.24,
        octree_depth: int = 11,
        octree_full_depth: int = 2,
        serialization_depth: int = 12,
        quantization: str = "ocnn",
        stage_capacity: Optional[Sequence[float]] = None,
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        if quantization not in ("ocnn", "cmin"):
            raise ValueError(f"quantization {quantization!r}: 'ocnn' or 'cmin'")
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.num_classes, self.stem_down, self.head_up = num_classes, stem_down, head_up
        self.octree_scale_factor, self.octree_depth = octree_scale_factor, octree_depth
        self.serialization_depth, self.quantization = serialization_depth, quantization
        n_pools = stem_down + len(channels) - 1
        self.stage_capacity = tuple(stage_capacity or (0.7 * 0.5 ** s for s in range(n_pools)))
        stem_ch = [int(channels[0] * 2 ** i) for i in range(-stem_down, 1)]
        cin = in_channels
        convs, downs = [], []
        for i in range(stem_down):
            convs.append(ConvBn(OcnnConv(cin, stem_ch[i], "subm", dtype=dtype),
                                _bn(stem_ch[i], 0.01, dtype)))
            downs.append(ConvBn(OcnnConv(stem_ch[i], stem_ch[i + 1], "down", dtype=dtype),
                                _bn(stem_ch[i + 1], 0.01, dtype)))
            cin = stem_ch[i + 1]
        self.patch_embed = _PatchEmbed(convs, downs, ConvBn(
            OcnnConv(cin, channels[0], "subm", dtype=dtype), _bn(channels[0], 0.01, dtype)))
        dp = [float(x) for x in np.linspace(0, drop_path, sum(num_blocks))]
        self.layers = nn.ModuleList()
        self.downsamples = nn.ModuleList()
        for s, c in enumerate(channels):
            first = sum(num_blocks[:s])
            self.layers.append(_Stage([
                OctFormerBlock(c, num_heads[s], patch_size, 1 if i % 2 == 0 else dilation,
                               drop_path=dp[first + i], dtype=dtype)
                for i in range(num_blocks[s])]))
            if s < len(channels) - 1:
                self.downsamples.append(ConvBn(
                    OcnnConv(c, channels[s + 1], "down", bias=True, dtype=dtype),
                    _bn(channels[s + 1], 0.1, dtype), norm_name="norm"))
        fpn = fpn_channels
        self.decoder = _Decoder(
            [Linear(channels[-1 - i], fpn, dtype=dtype) for i in range(len(channels))],
            [ConvBn(OcnnConv(fpn, fpn, "subm", dtype=dtype), _bn(fpn, 0.01, dtype))
             for _ in channels],
            [ConvBn(OcnnConv(fpn, fpn, "deconv", dtype=dtype), _bn(fpn, 0.01, dtype))
             for _ in range(min(head_up, stem_down))])
        if num_classes > 0:
            self.seg_head = nn.ModuleDict({"0": Linear(fpn, fpn, dtype=dtype),
                                           "1": _bn(fpn, 0.1, dtype),
                                           "3": Linear(fpn, num_classes, dtype=dtype)})
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (OcnnConv, DWConv)):
                _trunc_normal(mod.weights.data, gen)
            elif isinstance(mod, RPE):
                _trunc_normal(mod.rpe_table.data, gen)
            elif isinstance(mod, Linear):
                mod.reset_parameters(gen)

    def leaves(self, point: PointBatch):
        """Level 0 (the octree's leaves) and the leaf plan ("ocnn"; None
        for "cmin") with the leaves' features."""
        depth = self.serialization_depth
        coord, mask = point.coord, point.mask
        # tensor divisors: CUDA divides by a Python scalar as a product with
        # its reciprocal, whose rounding can move a point across a cell
        scale = torch.tensor(self.octree_scale_factor, dtype=coord.dtype, device=coord.device)
        if self.quantization == "ocnn":
            half = float(1 << (self.octree_depth - 1))
            gc = torch.floor((coord / scale + 1.0) * half).long()
            gc = gc.clamp(0, (1 << self.octree_depth) - 1)
            gc = torch.where(mask[..., None], gc, 0)
            ser = serialize(gc, mask, ("z",), depth)
            plan = build_pooling_plan(ser, mask, gc.shape[1], 0)
            feat = pool_values(plan, point.feat.to(self.dtype), "mean")
            gc = torch.where(plan.out_mask[..., None], take_along_points(gc, plan.head_index), 0)
            return make_level(gc, plan.out_mask, pool_serialization(plan, ser, 0), depth), \
                plan, feat
        voxel = scale / float(1 << self.octree_depth)
        big = torch.tensor(1e10, dtype=coord.dtype, device=coord.device)
        cmin = torch.where(mask[..., None], coord, big).amin(1, keepdim=True)
        gc = torch.floor((coord - cmin) / voxel).long()
        gc = torch.where(mask[..., None], gc.clamp(min=0), 0).clamp(max=(1 << depth) - 1)
        return make_level(gc, mask, serialize(gc, mask, ("z",), depth), depth), None, \
            point.feat.to(self.dtype)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None):
        """The logits (or, with ``num_classes`` 0, the head-up features) at
        the input points (``plans``: the leaf plan, if any, and every
        pool's); a training forward draws drop path from ``generator``."""
        depth = self.serialization_depth
        n0 = point.num_points
        level, leaf_plan, feat = self.leaves(point)
        plans = [] if leaf_plan is None else [leaf_plan]
        caps = iter(self.stage_capacity)

        def downsample(x, lvl, module, relu):
            plan = build_pooling_plan(lvl.ser, lvl.mask, _round_cap(n0, next(caps)), 1)
            plans.append(plan)
            new = downsampled_level(lvl, plan, depth)
            return module(x, new, plan, lvl.grid_coord, relu=relu), new, plan

        stem_records = []  # (plan, the finer level) for the head-up deconvs
        embed = self.patch_embed
        for conv, down in zip(embed.convs, embed.downsamples):
            feat = conv(feat, level, level.conv_plan)
            child = level
            feat, level, plan = downsample(feat, level, down, True)
            stem_records.append((plan, child))
        feat = embed.proj(feat, level, level.conv_plan)

        stage_feats, stage_levels, stage_plans = [], [], []
        for s, stage in enumerate(self.layers):
            for blk in stage.blocks:
                feat = blk(feat, level, generator)
            stage_feats.append(feat)
            stage_levels.append(level)
            if s < len(self.layers) - 1:
                feat, level, plan = downsample(feat, level, self.downsamples[s], False)
                stage_plans.append(plan)

        dec = self.decoder
        last = len(stage_feats) - 1

        def up_to_stage0(x, from_stage):
            for t in reversed(range(from_stage)):
                x = unpool_values(x, stage_plans[t].cluster_of_point)
            return x

        feature = dec.conv1x1[0](stage_feats[-1])
        out = up_to_stage0(dec.conv3x3[0](feature, stage_levels[-1], stage_levels[-1].conv_plan),
                           last)
        for i in range(1, last + 1):
            s = last - i
            feature = unpool_values(feature, stage_plans[s].cluster_of_point)
            feature = dec.conv1x1[i](stage_feats[s]) + feature
            out = out + up_to_stage0(
                dec.conv3x3[i](feature, stage_levels[s], stage_levels[s].conv_plan), s)
        parent = stage_levels[0]
        for i, up in enumerate(dec.up_conv):
            plan, child = stem_records[self.stem_down - 1 - i]
            out = up(out, child, parent, child, depth)
            parent = child
        for j in range(len(dec.up_conv), self.stem_down):
            out = unpool_values(out, stem_records[self.stem_down - 1 - j][0].cluster_of_point)
        if leaf_plan is not None:
            out = unpool_values(out, leaf_plan.cluster_of_point)
        if self.num_classes > 0:
            head = self.seg_head
            out = head["3"](F.relu(head["1"](head["0"](out), point.mask)))
        return point.replace(feat=out, plans=tuple(plans))
