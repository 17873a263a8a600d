"""Point Transformer V2 backbone (counterpart of
``scenesplat_tpu/models/ptv2.py``), on padded batches:

  - pointops.knn_query: ``ops/pointops.py:knn``, exact, over hashed cells;
    one neighbour index a ``BlockSequence``, as the reference;
  - pointops.grouping: masked row gathers, invalid slots zeroed;
  - GridPool (torch_geometric.voxel_grid + torch.unique): the cluster plan
    of ``ops/pointops.py:grid_cluster_plan`` at a static capacity a stage
    (``stage_capacity``, fractions of the input's slots); clusters past it
    are counted (``PoolingPlan.n_overflow``, the output's ``plans``). The
    valid clusters are a prefix of each row, so the stage then runs on the
    slots up to the global batch's largest cluster count (rounded up to
    16; under data parallel one all_reduce of it a stage): no
    valid point reads the rest, so the outputs are those of the full
    capacity at a fraction of the memory (one host read a stage);
  - PointBatchNorm (BatchNorm1d, eps 1e-5, momentum 0.1) over the valid
    points of [B, N, C] or the valid neighbour slots of [B, N, K, C]:
    ``PointBN``, whose ``models/norm.py:PointBatchNorm`` normalizes every
    slot with the valid ones' moments as the JAX package does, since
    ``GroupedVectorAttention`` keeps invalid slots in its softmax's
    denominator (the reference's ``sign(idx + 1)`` zeroes them only after
    it) and so reads their values;
  - "map" unpooling: a gather by cluster; "interp": inverse-distance
    interpolation over the 3 nearest (``ops/pointops.py:interpolation``).

Registered: PT-v2m2 (point_transformer_v2m2_base.py), PT-v2m1 (the
GroupedLinear weight encoding of point_transformer_v2m1_origin.py) and
PT-v2m3 (every norm a PDNorm of the batch's dataset ``condition``, looked up
by name, point_transformer_v2m3_pdnorm.py). Parameter names are the
reference's (``patch_embed.proj.{0,1}``, ``patch_embed.blocks.blocks.{i}``,
``enc_stages.{s}.down.{fc,norm}``, ``enc_stages.{s}.blocks.blocks.{i}``,
``dec_stages.{s}.up.{proj,proj_skip}.{0,1}``, ``seg_head.{0,1,3}``; a
block's ``fc1``, ``norm{1,2,3}``, ``fc3`` and ``attn.linear_{q,k}.{0,1}``,
``attn.linear_v``, ``attn.linear_p_{bias,multiplier}.{0,1,3}``,
``attn.weight_encoding.{0,1,3}``; a PointBatchNorm's ``.norm``, a PDNorm's
``norm.{c}`` and ``modulation.1``), so the reference's state dict, or the
JAX package's weights carried by ``utils/weights.py``, loads with
``strict=True``. Parameters are drawn from ``seed``. In training the
forward takes a ``torch.Generator`` for its drop path (whole points, the
reference's timm DropPath) and attention dropout.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops import pointops as po
from scenesplat_tpu_torch.ops.segops import at_least_fp32, pool_values, unpool_values
from scenesplat_tpu_torch.ops.serialization import take_along_points
from scenesplat_tpu_torch.parallel.dist import max_on_ranks

from .builder import MODELS
from .norm import PDNorm, PointBatchNorm
from .ptv3 import Linear, PDCfg, as_dtype, dropout


class PointBN(nn.Module):
    """The reference PointBatchNorm: its BatchNorm1d ``norm``."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.norm = PointBatchNorm(features, eps=1e-5, momentum=0.1, dtype=dtype)

    def forward(self, x, mask):
        return self.norm(x, mask)


def point_norm(features: int, pd: Optional[PDCfg], dtype) -> nn.Module:
    """A PointBN, or with ``pd`` the PDNorm of BatchNorms in its place."""
    if pd is None:
        return PointBN(features, dtype)
    return PDNorm(features, pd.conditions, norm_type="bn", decouple=pd.decouple,
                  adaptive=pd.adaptive, context_channels=pd.context_channels, dtype=dtype,
                  batch_norm=PointBatchNorm)


def norm_points(norm: nn.Module, x: torch.Tensor, mask: torch.Tensor, cond=None):
    """``norm`` over the valid rows of ``x`` [B, N, C] (``mask`` [B, N]) or
    the valid slots of ``x`` [B, N, K, C] (``mask`` [B, N, K], or [B, N]
    for every slot of a valid point); a PDNorm also takes ``cond`` =
    (condition name, context or None)."""
    shape = x.shape
    if x.dim() == 4:
        if mask.dim() == 2:
            mask = mask[..., None].expand(shape[:3])
        x, mask = x.reshape(shape[0], -1, shape[3]), mask.reshape(shape[0], -1)
    if isinstance(norm, PDNorm):
        if cond is None or cond[0] is None:
            raise ValueError("a PDNorm-conditioned PTv2 needs the batch's condition")
        y = norm(x, cond[0], context=cond[1], mask=mask)
    else:
        y = norm(x, mask)
    return y.reshape(shape)


def _linear_norm_relu(cin: int, cout: int, pd, dtype, bias: bool = True) -> nn.ModuleList:
    """The reference's Sequential(Linear, PointBatchNorm, ReLU): ``.0``, ``.1``."""
    return nn.ModuleList([Linear(cin, cout, bias=bias, dtype=dtype), point_norm(cout, pd, dtype),
                          nn.ReLU()])


def _run(seq: nn.ModuleList, x, mask, cond):
    """Linear, norm, ReLU, then a second Linear if ``seq`` has one (.3)."""
    x = F.relu(norm_points(seq[1], seq[0](x), mask, cond))
    return seq[3](x) if len(seq) > 3 else x


class GroupedLinear(nn.Module):
    """PT-v2m1's weight encoding: per-channel weights [1, C] summed within
    each of ``groups`` groups."""

    def __init__(self, in_features: int, groups: int, dtype=torch.float32):
        super().__init__()
        self.groups, self.dtype = groups, dtype
        self.weight = nn.Parameter(torch.empty(1, in_features))

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        y = x * self.weight.to(x.dtype)
        return y.reshape(x.shape[:-1] + (self.groups, -1)).sum(-1)


class GroupedVectorAttention(nn.Module):
    """The reference GroupedVectorAttention on padded neighbour slots."""

    def __init__(self, embed_channels: int, groups: int, attn_drop_rate: float = 0.0,
                 qkv_bias: bool = True, pe_multiplier: bool = False, pe_bias: bool = True,
                 grouped_linear: bool = False, pd: Optional[PDCfg] = None,
                 dtype=torch.float32):
        super().__init__()
        c = embed_channels
        self.groups, self.attn_drop_rate = groups, attn_drop_rate
        self.linear_q = _linear_norm_relu(c, c, pd, dtype, bias=qkv_bias)
        self.linear_k = _linear_norm_relu(c, c, pd, dtype, bias=qkv_bias)
        self.linear_v = Linear(c, c, bias=qkv_bias, dtype=dtype)
        self.linear_p_multiplier = (
            nn.ModuleList([*_linear_norm_relu(3, c, pd, dtype), Linear(c, c, dtype=dtype)])
            if pe_multiplier else None)
        self.linear_p_bias = (
            nn.ModuleList([*_linear_norm_relu(3, c, pd, dtype), Linear(c, c, dtype=dtype)])
            if pe_bias else None)
        first = GroupedLinear(c, groups, dtype) if grouped_linear else Linear(c, groups,
                                                                              dtype=dtype)
        self.weight_encoding = nn.ModuleList([first, point_norm(groups, pd, dtype), nn.ReLU(),
                                              Linear(groups, groups, dtype=dtype)])

    def forward(self, feat, coord, mask, ref_index, generator=None, cond=None):
        q = _run(self.linear_q, feat, mask, cond)
        k = _run(self.linear_k, feat, mask, cond)
        v = self.linear_v(feat)
        kg = po.grouping(ref_index, k, coord)
        vg = po.grouping(ref_index, v, coord)
        pos = po.grouped_offsets(ref_index, coord, coord).to(kg.dtype)
        relation = kg - q[:, :, None, :]
        slot_ok = ref_index >= 0
        if self.linear_p_multiplier is not None:
            relation = relation * _run(self.linear_p_multiplier, pos, slot_ok, cond)
        if self.linear_p_bias is not None:
            peb = _run(self.linear_p_bias, pos, slot_ok, cond)
            relation = relation + peb
            vg = vg + peb
        w = _run(self.weight_encoding, relation, slot_ok, cond)
        w = torch.softmax(at_least_fp32(w), dim=2).to(w.dtype)
        w = dropout(w, self.attn_drop_rate if self.training else 0.0, generator)
        w = w * slot_ok[..., None].to(w.dtype)
        return po.aggregation(vg, w, self.groups)


class Block(nn.Module):
    """fc1 -> attention -> fc3, each with its norm, and the residual; in
    training the branch is dropped per point at ``drop_path_rate``."""

    def __init__(self, embed_channels: int, groups: int, qkv_bias: bool = True,
                 pe_multiplier: bool = False, pe_bias: bool = True, grouped_linear: bool = False,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 pd: Optional[PDCfg] = None, dtype=torch.float32):
        super().__init__()
        c = embed_channels
        self.drop_path_rate = drop_path_rate
        self.fc1 = Linear(c, c, bias=False, dtype=dtype)
        self.norm1 = point_norm(c, pd, dtype)
        self.attn = GroupedVectorAttention(c, groups, attn_drop_rate, qkv_bias, pe_multiplier,
                                           pe_bias, grouped_linear, pd, dtype)
        self.norm2 = point_norm(c, pd, dtype)
        self.fc3 = Linear(c, c, bias=False, dtype=dtype)
        self.norm3 = point_norm(c, pd, dtype)

    def forward(self, feat, coord, mask, ref_index, generator=None, cond=None):
        x = F.relu(norm_points(self.norm1, self.fc1(feat), mask, cond))
        x = self.attn(x, coord, mask, ref_index, generator, cond)
        x = F.relu(norm_points(self.norm2, x, mask, cond))
        x = norm_points(self.norm3, self.fc3(x), mask, cond)
        x = dropout(x, self.drop_path_rate if self.training else 0.0, generator, per_point=True)
        return F.relu(feat + x)


class BlockSequence(nn.Module):
    """One kNN at the sequence's resolution, then its blocks (``blocks``)."""

    def __init__(self, depth: int, embed_channels: int, groups: int, neighbours: int = 16,
                 drop_path_rates: Sequence[float] = (), **block):
        super().__init__()
        self.neighbours = neighbours
        rates = list(drop_path_rates) or [0.0] * depth
        self.blocks = nn.ModuleList([Block(embed_channels, groups, drop_path_rate=rates[i],
                                           **block) for i in range(depth)])

    def forward(self, feat, coord, mask, generator=None, cond=None):
        ref_index, _ = po.knn(coord, mask, self.neighbours)
        for blk in self.blocks:
            feat = blk(feat, coord, mask, ref_index, generator, cond)
        return feat


class GridPool(nn.Module):
    """fc + norm + ReLU, then voxel clusters: coordinates averaged
    (``mean_coord``), features max-pooled."""

    def __init__(self, in_channels: int, out_channels: int, grid_size: float,
                 pd: Optional[PDCfg] = None, dtype=torch.float32):
        super().__init__()
        self.grid_size = grid_size
        self.fc = Linear(in_channels, out_channels, bias=False, dtype=dtype)
        self.norm = point_norm(out_channels, pd, dtype)

    def forward(self, feat, coord, mask, out_capacity: int, cond=None):
        x = F.relu(norm_points(self.norm, self.fc(feat), mask, cond))
        plan = po.grid_cluster_plan(coord, mask, self.grid_size, out_capacity)
        return pool_values(plan, x, "max"), mean_coord(plan, coord), plan


def mean_coord(plan, coord: torch.Tensor) -> torch.Tensor:
    """Each cluster's mean coordinate [B, M, 3], summed in float64 and
    rounded once: the next stage clusters these coordinates by the floor
    of their grid cell, so a last-bit change moves a point to another
    cluster. fp32 atomic sums on the card change their last bits from run
    to run, and the CPU sums in another order; float64 sums round to the
    same fp32 mean on both."""
    b, n, _ = coord.shape
    m = plan.head_index.shape[1]
    vals = take_along_points(coord.double(), plan.order0)
    sums = vals.new_zeros(b, m + 1, 3).scatter_add_(
        1, plan.seg_sorted.unsqueeze(-1).expand(b, n, 3), vals)[:, :m]
    return (sums / plan.counts.clamp(min=1).unsqueeze(-1)).to(coord.dtype)


class UnpoolWithSkip(nn.Module):
    """Map or interpolation unpooling plus the projected skip."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 backend: str = "map", pd: Optional[PDCfg] = None, dtype=torch.float32):
        super().__init__()
        if backend not in ("map", "interp"):
            raise ValueError(f"unpool_backend {backend!r}: 'map' or 'interp'")
        self.backend = backend
        self.proj = _linear_norm_relu(in_channels, out_channels, pd, dtype)
        self.proj_skip = _linear_norm_relu(skip_channels, out_channels, pd, dtype)

    def forward(self, feat, coord, mask, skip_feat, skip_coord, skip_mask, plan, cond=None):
        x = _run(self.proj, feat, mask, cond)
        if self.backend == "map":
            x = unpool_values(x, plan.cluster_of_point)
        else:
            x = po.interpolation(coord, mask, skip_coord, skip_mask, x)
        return x + _run(self.proj_skip, skip_feat, skip_mask, cond)


class _Stage(nn.Module):
    """An encoder (``down``, ``blocks``) or decoder (``up``, ``blocks``)."""

    def __init__(self, blocks: BlockSequence, **resample: nn.Module):
        super().__init__()
        for name, mod in resample.items():
            self.add_module(name, mod)
        self.blocks = blocks


@MODELS.register_module("PT-v2m2")
class PointTransformerV2(nn.Module):
    """Takes a PointBatch and returns it with per-point logits
    (``num_classes`` > 0) or the decoder's features, and the pooling
    plans in ``plans``. ``conditions`` makes every norm a PDNorm (PT-v2m3);
    the forward then takes ``condition`` by name and the adaptive norms'
    ``context`` [B, context_channels]."""

    def __init__(self, in_channels: int, num_classes: int = 0, patch_embed_depth: int = 1,
                 patch_embed_channels: int = 48, patch_embed_groups: int = 6,
                 patch_embed_neighbours: int = 8,
                 enc_depths: Sequence[int] = (2, 2, 6, 2),
                 enc_channels: Sequence[int] = (96, 192, 384, 512),
                 enc_groups: Sequence[int] = (12, 24, 48, 64),
                 enc_neighbours: Sequence[int] = (16, 16, 16, 16),
                 dec_depths: Sequence[int] = (1, 1, 1, 1),
                 dec_channels: Sequence[int] = (48, 96, 192, 384),
                 dec_groups: Sequence[int] = (6, 12, 24, 48),
                 dec_neighbours: Sequence[int] = (16, 16, 16, 16),
                 grid_sizes: Sequence[float] = (0.06, 0.12, 0.24, 0.48),
                 attn_qkv_bias: bool = True, pe_multiplier: bool = False, pe_bias: bool = True,
                 grouped_linear: bool = False, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, unpool_backend: str = "map",
                 stage_capacity: Sequence[float] = (0.75, 0.4, 0.2, 0.1),
                 conditions: Optional[Sequence[str]] = None,
                 pd_decouple: bool = True, pd_adaptive: bool = False,
                 context_channels: int = 256, enable_checkpoint: bool = False,
                 dtype="float32", seed: int = 0):
        super().__init__()
        if enable_checkpoint:
            raise NotImplementedError("enable_checkpoint is not ported")
        dtype = as_dtype(dtype)
        pd = (PDCfg(tuple(conditions), decouple=pd_decouple, adaptive=pd_adaptive,
                    context_channels=context_channels) if conditions else None)
        self.conditions = None if pd is None else pd.conditions
        self.dtype = dtype
        self.num_stages = len(enc_depths)
        # the first num_stages fractions, as the JAX package reads them
        self.stage_capacity = tuple(stage_capacity)[:self.num_stages]
        if len(self.stage_capacity) != self.num_stages:
            raise ValueError("stage_capacity needs a fraction per encoder stage")
        self.out_channels = num_classes if num_classes > 0 else dec_channels[0]
        block = dict(qkv_bias=attn_qkv_bias, pe_multiplier=pe_multiplier, pe_bias=pe_bias,
                     grouped_linear=grouped_linear, attn_drop_rate=attn_drop_rate, pd=pd,
                     dtype=dtype)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = _linear_norm_relu(in_channels, patch_embed_channels, pd, dtype,
                                                  bias=False)
        self.patch_embed.blocks = BlockSequence(patch_embed_depth, patch_embed_channels,
                                                patch_embed_groups, patch_embed_neighbours,
                                                **block)
        enc_dp = torch.linspace(0, drop_path_rate, sum(enc_depths), dtype=torch.float64).tolist()
        dec_dp = torch.linspace(0, drop_path_rate, sum(dec_depths), dtype=torch.float64).tolist()
        enc_ch = [patch_embed_channels] + list(enc_channels)
        dec_ch = list(dec_channels) + [enc_ch[-1]]
        self.enc_stages = nn.ModuleList()
        self.dec_stages = nn.ModuleList()
        for s in range(self.num_stages):
            rates = enc_dp[sum(enc_depths[:s]):sum(enc_depths[:s + 1])]
            self.enc_stages.append(_Stage(
                BlockSequence(enc_depths[s], enc_ch[s + 1], enc_groups[s], enc_neighbours[s],
                              rates, **block),
                down=GridPool(enc_ch[s], enc_ch[s + 1], grid_sizes[s], pd, dtype)))
            rates = dec_dp[sum(dec_depths[:s]):sum(dec_depths[:s + 1])]
            self.dec_stages.append(_Stage(
                BlockSequence(dec_depths[s], dec_ch[s], dec_groups[s], dec_neighbours[s],
                              rates, **block),
                up=UnpoolWithSkip(dec_ch[s + 1], enc_ch[s], dec_ch[s], unpool_backend, pd,
                                  dtype)))
        self.seg_head = (nn.ModuleList([*_linear_norm_relu(dec_ch[0], dec_ch[0], pd, dtype),
                                        Linear(dec_ch[0], num_classes, dtype=dtype)])
                         if num_classes > 0 else None)
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Linear, GroupedLinear)):
                mod.reset_parameters(gen)

    def capacity(self, n0: int, s: int) -> int:
        """Stage ``s``'s cluster slots for ``n0`` input slots: the fraction
        rounded up to a multiple of 16 (16 at least, ``n0`` at most)."""
        cap = max(16, int(math.ceil(n0 * self.stage_capacity[s] / 16)) * 16)
        return min(cap, n0)

    def forward(self, point, generator: Optional[torch.Generator] = None, condition=None,
                context: Optional[torch.Tensor] = None):
        cond = None if self.conditions is None else (condition, context)
        coord, mask = point.coord, point.mask
        n0 = point.num_points
        feat = _run(self.patch_embed.proj, point.feat.to(self.dtype), mask, cond)
        feat = self.patch_embed.blocks(feat, coord, mask, generator, cond)
        skips, plans = [], []
        for s, stage in enumerate(self.enc_stages):
            # no more clusters than the stage's input slots hold
            cap = min(self.capacity(n0, s), coord.shape[1])
            x, new_coord, plan = stage.down(feat, coord, mask, cap, cond)
            skips.append((feat, coord, mask, plan))
            plans.append(plan)
            # the valid clusters are a prefix of each row: cut the slots
            # past the (global) batch's largest count, rounded up to 16, so
            # that draws at the global batch's shape see one shape
            m = min(cap, max(16, -(-max_on_ranks(plan.n_clusters) // 16) * 16))
            feat, coord, mask = x[:, :m], new_coord[:, :m], plan.out_mask[:, :m]
            feat = stage.blocks(feat, coord, mask, generator, cond)
        for s in reversed(range(self.num_stages)):
            skip_feat, skip_coord, skip_mask, plan = skips.pop()
            stage = self.dec_stages[s]
            feat = stage.up(feat, coord, mask, skip_feat, skip_coord, skip_mask, plan, cond)
            coord, mask = skip_coord, skip_mask
            feat = stage.blocks(feat, coord, mask, generator, cond)
        if self.seg_head is not None:
            feat = _run(self.seg_head, feat, mask, cond)
        return point.replace(feat=feat, coord=coord, mask=mask, plans=tuple(plans))


@MODELS.register_module("PT-v2m1")
class PointTransformerV2M1(PointTransformerV2):
    """PT-v2m1: the GroupedLinear weight encoding."""

    def __init__(self, in_channels: int, grouped_linear: bool = True, **kwargs):
        super().__init__(in_channels, grouped_linear=grouped_linear, **kwargs)


@MODELS.register_module("PT-v2m3")
class PointTransformerV2M3(PointTransformerV2):
    """PT-v2m3: prompt-driven normalization (Point Prompt Training), every
    norm a PDNorm of the dataset conditions, adaptive by default."""

    def __init__(self, in_channels: int,
                 conditions: Sequence[str] = ("ScanNet", "S3DIS", "Structured3D"),
                 pd_adaptive: bool = True, **kwargs):
        super().__init__(in_channels, conditions=conditions, pd_adaptive=pd_adaptive, **kwargs)
