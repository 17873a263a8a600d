"""Stratified Transformer, ST-v1m2 and its ST-v1m1 alias (counterpart of
``scenesplat_tpu/models/stratified.py``), on padded batches:

  - the stratified key set: every point attends over a fixed slot table,
    up to ``fine_capacity`` members of its window and ``coarse_capacity``
    FPS-sampled members of its 2x window that lie in other windows
    (``window_members``: one stable sort of int64 z-codes a grid); shifted
    blocks move both grids by half a window. A window holding more members
    than its capacity keeps the first by position (the reference densifies
    to the largest count): the members dropped are counted per table, in
    the output's ``plans`` (``TableOverflow.n_overflow``, as
    ``PoolingPlan.n_overflow``);
  - the relative position bias of the three quantized per-axis tables
    (query, key, value), bin first: q and k are contracted with each table
    over its 2L bins ([B, N, 3, 2L, H]), then read at each slot's bin; the
    attention is summed into the bins for the value term, then contracted.
    The same products as the JAX module's, which gathers each table per
    slot ([B, N, K, H, hd], about 1.3 GB a table and axis at stage 0 of
    rows of 102,912 slots), summed in another order;
  - the KPConv stem (torch_points3d KPConvLayer, linear influence) over a
    ball query with -1 shadow neighbours; its kernel points, the JAX
    module's Fibonacci sphere scaled by the influence, are the buffer
    ``K_points`` (a reference checkpoint brings its own);
  - TransitionDown: FPS to int(n * down_ratio) + 1 samples (on the card
    one launch of ``csrc/farthest_point_sampling.cu``; a stage's key set
    and its transition down take the same samples of the same level, so
    they are drawn once), the ``knn`` of each, LayerNorm + Linear and a
    masked max; TransitionUp through ``interpolation``.

Parameter names are the reference's (stratified_transformer_v1m2_refine.py,
as ``scenesplat_tpu/utils/ckpt_bridge.py:convert_stratified_checkpoint``
maps them): ``point_embed.0.{kpconv,bn.batch_norm}``,
``point_embed.1.{unary_1,unary_2}.{0,1.batch_norm}``,
``point_embed.1.kpconv``, ``point_embed.1.bn.batch_norm`` (declared by the
reference's KPConvResBlock and never applied), ``down.{norm,linear}``,
``layers.{i}.blocks.{j}.{norm1,norm2,attn.qkv,attn.proj,
attn.relative_pos_{query,key,value}_table,mlp.fc1,mlp.fc2}``,
``layers.{i}.down.{norm,linear}``, ``up.{j}.linear{1,2}.{0,1}`` and
``classifier.{0,1,3}``. ``knn_tile`` is accepted and ignored (a TPU
tiling). Parameters are drawn from ``seed``; a training forward's drop
path (per point) draws from its generator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops import pointops as po
from scenesplat_tpu_torch.ops.bitonic_sort import sort_int64
from scenesplat_tpu_torch.ops.curves import encode
from scenesplat_tpu_torch.ops.segops import at_least_fp32
from scenesplat_tpu_torch.ops.serialization import take_along_points

from .builder import MODELS
from .norm import LayerNorm, PointBatchNorm
from .ptv3 import Linear, as_dtype, dropout

_BIG = 1e10
# a padded point's sort key: above every z-code of depth 16 (48 bits) shifted
# by the subset flag, with the flag set (not a subset member)
_PADDED_KEY = (1 << 50) | 1


class WindowTable(NamedTuple):
    """A point's window members: ``idx`` [B, N, C] int64, ``valid``
    [B, N, C], ``window_coord`` [B, N, 3] int64, ``n_overflow`` [B] the
    members that truncation at the capacity dropped."""

    idx: torch.Tensor
    valid: torch.Tensor
    window_coord: torch.Tensor
    n_overflow: torch.Tensor


@dataclass(frozen=True)
class TableOverflow:
    """One slot table's truncation (``n_overflow`` [B]) at its level
    (``out_mask`` [B, N]), as a pooling plan reports its clusters lost."""

    n_overflow: torch.Tensor
    out_mask: torch.Tensor


def window_members(coord: torch.Tensor, mask: torch.Tensor, window: float, start: torch.Tensor,
                   capacity: int, subset: Optional[torch.Tensor] = None) -> WindowTable:
    """Each point's window members (the JAX ``window_members``): the points
    of its window of side ``window`` on the grid from ``start`` [B, 1, 3],
    ordered by position, the ``subset`` members (when given; subset points
    lie among the valid ones) first and only they valid, at most
    ``capacity``. One stable sort of ``sort_int64`` (K3 with its switch on)
    of int64 keys: the window's z-code at depth 16, then the not-subset
    flag, the position the stable sort's own tie rule."""
    b, n = mask.shape
    dev = coord.device
    cell = torch.tensor(window, dtype=coord.dtype, device=dev)  # true division on the card
    gc = torch.floor((coord - start) / cell).long()
    gc = torch.where(mask[..., None], gc.clamp(min=0), 0)
    member = mask if subset is None else subset
    key = torch.where(mask, encode(gc, "z", 16) << 1 | (~member).long(), _PADDED_KEY)
    skey, order = sort_int64(key)
    code = skey >> 1
    changed = torch.ones(b, n, dtype=torch.bool, device=dev)
    changed[:, 1:] = code[:, 1:] != code[:, :-1]
    window_sorted = changed.long().cumsum(1) - 1  # [B, N] the window of each sorted slot
    window_of_point = torch.empty_like(window_sorted).scatter_(1, order, window_sorted)
    pos = torch.arange(n, device=dev).expand(b, n)
    starts = torch.full((b, n), n, dtype=torch.long, device=dev).scatter_reduce(
        1, window_sorted, pos, "amin")
    counts = torch.zeros(b, n, dtype=torch.long, device=dev).scatter_add(
        1, window_sorted, ((skey & 1) == 0).long())
    t = torch.arange(capacity, device=dev)
    mem_pos = (starts[..., None] + t).clamp(max=n - 1).reshape(b, -1)
    members = order.gather(1, mem_pos).reshape(b, n, capacity)
    mem_valid = t < counts.clamp(max=capacity)[..., None]
    index = window_of_point[..., None].expand(b, n, capacity)
    idx = members.gather(1, index)
    valid = mem_valid.gather(1, index) & mask[..., None]
    return WindowTable(idx, valid, gc, (counts - capacity).clamp(min=0).sum(1))


def kernel_points(k: int) -> np.ndarray:
    """The JAX KPConv's deterministic disposition [k, 3]: the centre and a
    Fibonacci sphere of k - 1 unit points."""
    pts = [[0.0, 0.0, 0.0]]
    m = k - 1
    phi = (1 + 5 ** 0.5) / 2
    for i in range(m):
        z = 1 - 2 * (i + 0.5) / m
        r = (1 - z * z) ** 0.5
        th = 2 * np.pi * i / phi
        pts.append([r * np.cos(th), r * np.sin(th), z])
    return np.asarray(pts, np.float32)


class KPConv(nn.Module):
    """Kernel-point convolution (torch_points3d KPConvLayer): each
    neighbour's features weighted by its linear influence max(0, 1 - d /
    sigma) on every kernel point (``K_points`` [P, 3], offsets in metres),
    summed, then ``weight`` [P, Cin, Cout]; -1 neighbours contribute
    nothing."""

    def __init__(self, in_channels: int, out_channels: int, point_influence: float,
                 num_kernel_points: int = 15, dtype=torch.float32):
        super().__init__()
        self.point_influence, self.dtype = point_influence, dtype
        self.weight = nn.Parameter(torch.empty(num_kernel_points, in_channels, out_channels))
        self.register_buffer("K_points", torch.from_numpy(
            kernel_points(num_kernel_points) * np.float32(point_influence)))

    def reset_parameters(self, gen: torch.Generator):
        p, cin, _ = self.weight.shape
        bound = (3.0 / (p * cin)) ** 0.5  # lecun normal's variance, uniform
        self.weight.data.uniform_(-bound, bound, generator=gen)

    def forward(self, feat, neighbor_idx, coord, query_coord=None):
        g = po.grouping(neighbor_idx, feat.to(self.dtype), coord, query_coord=query_coord,
                        with_xyz=True)
        rel, gf = g[..., :3], g[..., 3:]
        # each kernel point's distance as the root of (dx dx + dy dy) + dz
        # dz, one rounding an operation, and a tensor divisor, on the CPU and
        # the card alike (the card's vector_norm and its product with a
        # Python scalar's reciprocal round otherwise)
        e = rel[..., None, :] - self.K_points.to(rel.dtype)
        d = (e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]).sqrt()
        sigma = torch.tensor(self.point_influence, dtype=d.dtype, device=d.device)
        infl = torch.clamp(1.0 - d / sigma, min=0.0)
        infl = infl * (neighbor_idx >= 0)[..., None].to(infl.dtype)
        agg = torch.einsum("bnkp,bnkc->bnpc", infl.to(gf.dtype), gf)
        return torch.einsum("bnpc,pcd->bnd", agg, self.weight.to(gf.dtype))


def _bin_rows(b: int, n: int, bins: int, point: torch.Tensor, ridx: torch.Tensor) -> torch.Tensor:
    """Rows [B, N, K, 3] of a [B * N * 3 * bins, H] table: point ``point``
    [B, N, K] (of its row), axis a, bin ``ridx`` [B, N, K, 3]."""
    base = (torch.arange(b, device=point.device).view(b, 1, 1) * n + point) * 3
    axis = torch.arange(3, device=point.device)
    return (base[..., None] + axis) * bins + ridx


def _binned(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x [B, N, H, hd] contracted with a table [2L, H, hd, 3] over hd, for
    every bin and axis: [B * N * 3 * 2L, H] (fp32 at least)."""
    x = at_least_fp32(x)
    t = torch.einsum("bnhd,lhda->bnalh", x, table.to(x.dtype))
    return t.reshape(-1, t.shape[-1])


class StratifiedAttention(nn.Module):
    """Masked softmax attention over each point's slot table with the
    quantized relative position bias (reference WindowAttention)."""

    def __init__(self, embed_channels: int, num_heads: int, window_size: float,
                 quant_size: float, rel_query: bool = True, rel_key: bool = True,
                 rel_value: bool = True, qkv_bias: bool = True, dtype=torch.float32):
        super().__init__()
        c, h = embed_channels, num_heads
        self.num_heads, self.window_size, self.quant_size = h, window_size, quant_size
        self.bins = 2 * int((2 * window_size + 1e-4) // quant_size)
        self.qkv = Linear(c, 3 * c, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(c, c, dtype=dtype)
        shape = (self.bins, h, c // h, 3)
        for name, on in (("query", rel_query), ("key", rel_key), ("value", rel_value)):
            table = nn.Parameter(torch.empty(shape)) if on else None
            setattr(self, f"relative_pos_{name}_table", table)

    def tables(self):
        return [t for t in (self.relative_pos_query_table, self.relative_pos_key_table,
                            self.relative_pos_value_table) if t is not None]

    def forward(self, feat, coord, slot_idx, slot_valid):
        b, n, k = slot_idx.shape
        c = feat.shape[-1]
        h = self.num_heads
        hd = c // h
        qkv = self.qkv(feat).reshape(b, n, 3, h, hd)
        q, key, v = qkv[:, :, 0] * hd ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
        kg = po._gather_slots(key.reshape(b, n, c), slot_idx).view(b, n, k, h, hd)
        vg = po._gather_slots(v.reshape(b, n, c), slot_idx).view(b, n, k, h, hd)
        attn = at_least_fp32(torch.einsum("bnhd,bnkhd->bnkh", q, kg))

        rel = coord[:, :, None, :] - po._gather_slots(coord, slot_idx)
        dev = coord.device
        # JAX's round half to even and true divisions (a Python-scalar
        # divisor is a reciprocal product on the card: other lattice bins)
        rel = torch.round(rel * 1e5) / torch.tensor(1e5, dtype=rel.dtype, device=dev)
        quant = torch.tensor(self.quant_size, dtype=rel.dtype, device=dev)
        ridx = torch.floor((rel + 2 * self.window_size - 1e-4) / quant).long()
        ridx = ridx.clamp(0, self.bins - 1)
        own = torch.arange(n, device=dev).view(1, n, 1).expand(b, n, k)
        own_rows = _bin_rows(b, n, self.bins, own, ridx).reshape(-1)
        if self.relative_pos_query_table is not None:
            qt = _binned(q, self.relative_pos_query_table)
            attn = attn + qt.index_select(0, own_rows).view(b, n, k, 3, h).sum(3)
        if self.relative_pos_key_table is not None:
            kt = _binned(key, self.relative_pos_key_table)
            key_rows = _bin_rows(b, n, self.bins, slot_idx, ridx).reshape(-1)
            attn = attn + kt.index_select(0, key_rows).view(b, n, k, 3, h).sum(3)

        attn = torch.where(slot_valid[..., None], attn, -1e9)
        attn = torch.softmax(attn, dim=2) * slot_valid[..., None]
        out = torch.einsum("bnkh,bnkhd->bnhd", attn.to(vg.dtype), vg)
        if self.relative_pos_value_table is not None:
            src = attn[:, :, :, None, :].expand(b, n, k, 3, h).reshape(-1, h)
            binned = attn.new_zeros(b * n * 3 * self.bins, h).index_add(0, own_rows, src)
            rv = torch.einsum("bnalh,lhda->bnhd", binned.view(b, n, 3, self.bins, h),
                              self.relative_pos_value_table.to(binned.dtype))
            out = out + rv.to(out.dtype)
        return self.proj(out.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, channels: int, hidden: int, dtype):
        super().__init__()
        self.fc1 = Linear(channels, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, channels, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class StratifiedBlock(nn.Module):
    """Pre-norm attention and MLP (exact GELU) residuals, each dropped per
    point at ``drop_path`` in training."""

    def __init__(self, embed_channels: int, num_heads: int, window_size: float,
                 quant_size: float, mlp_expend_ratio: float = 4.0, drop_path: float = 0.0,
                 dtype=torch.float32, **attn):
        super().__init__()
        c = embed_channels
        self.drop_path = drop_path
        self.norm1 = LayerNorm(c, dtype=dtype)
        self.attn = StratifiedAttention(c, num_heads, window_size, quant_size, dtype=dtype,
                                        **attn)
        self.norm2 = LayerNorm(c, dtype=dtype)
        self.mlp = Mlp(c, int(c * mlp_expend_ratio), dtype)

    def forward(self, feat, coord, slot_idx, slot_valid, generator=None):
        p = self.drop_path if self.training else 0.0
        x = self.attn(self.norm1(feat), coord, slot_idx, slot_valid)
        feat = feat + dropout(x, p, generator, per_point=True)
        return feat + dropout(self.mlp(self.norm2(feat)), p, generator, per_point=True)


class PointBN(nn.Module):
    """The reference's FastBatchNorm1d: its BatchNorm1d ``batch_norm``,
    over the valid points."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.batch_norm = PointBatchNorm(features, eps=1e-5, momentum=0.1, dtype=dtype)

    def forward(self, x, mask):
        return self.batch_norm(x, mask)


class UnaryBlock(nn.Module):
    """Linear without bias (``0``), then the FastBatchNorm1d (``1``)."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.add_module("0", Linear(cin, cout, bias=False, dtype=dtype))
        self.add_module("1", PointBN(cout, dtype))

    def forward(self, x, mask):
        return F.leaky_relu(getattr(self, "1")(getattr(self, "0")(x), mask), 0.2)


class KPConvSimpleBlock(nn.Module):
    def __init__(self, cin: int, cout: int, sigma: float, dtype):
        super().__init__()
        self.kpconv = KPConv(cin, cout, sigma, dtype=dtype)
        self.bn = PointBN(cout, dtype)

    def forward(self, feat, nidx, coord, mask):
        return F.leaky_relu(self.bn(self.kpconv(feat, nidx, coord), mask), 0.2)


class KPConvResBlock(nn.Module):
    """unary_1, KPConv, unary_2 and the residual (reference l.544-591; its
    ``bn`` is declared and never applied, so it is kept for the names)."""

    def __init__(self, channels: int, sigma: float, dtype):
        super().__init__()
        d2 = channels // 4
        self.unary_1 = UnaryBlock(channels, d2, dtype)
        self.kpconv = KPConv(d2, d2, sigma, dtype=dtype)
        self.unary_2 = UnaryBlock(d2, channels, dtype)
        self.bn = PointBN(channels, dtype)

    def forward(self, feat, nidx, coord, mask):
        y = self.kpconv(self.unary_1(feat, mask), nidx, coord)
        return feat + self.unary_2(y, mask)


def neighbour_max(g: torch.Tensor, kidx: torch.Tensor) -> torch.Tensor:
    """g [B, M, K, C] maxed over its neighbours (dim 2); -1 neighbours are
    left out."""
    return torch.where((kidx >= 0)[..., None], g, float("-inf")).amax(2)


class TransitionDown(nn.Module):
    """The samples' k nearest points of the level, each grouped, LayerNorm
    + Linear (no bias), the max over the neighbours."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.norm = LayerNorm(cin, dtype=dtype)
        self.linear = Linear(cin, cout, bias=False, dtype=dtype)

    def forward(self, feat, coord, mask, idx, ratio: float, k: int):
        m = idx.shape[1]
        n_new = ((mask.sum(1).float() * ratio).long() + 1).clamp(min=1)
        new_mask = torch.arange(m, device=coord.device) < n_new.clamp(max=m)[:, None]
        new_coord = take_along_points(coord, idx)
        kidx, _ = po.knn(coord, mask, k, query=new_coord, query_mask=new_mask)
        g = neighbour_max(self.linear(self.norm(po.grouping(kidx, feat, coord))), kidx)
        g = torch.where(new_mask[..., None], g, torch.zeros((), dtype=g.dtype, device=g.device))
        return g, new_coord, new_mask


class TransitionUp(nn.Module):
    """``linear1`` (LayerNorm + Linear) of the skip plus the interpolation
    of ``linear2`` of the coarser level."""

    def __init__(self, cin: int, cout: int, dtype):
        super().__init__()
        self.linear1 = nn.Sequential(LayerNorm(cout, dtype=dtype), Linear(cout, cout, dtype=dtype))
        self.linear2 = nn.Sequential(LayerNorm(cin, dtype=dtype), Linear(cin, cout, dtype=dtype))

    def forward(self, feat, coord, mask, skip_feat, skip_coord, skip_mask):
        return self.linear1(skip_feat) + po.interpolation(coord, mask, skip_coord, skip_mask,
                                                          self.linear2(feat))


class Stage(nn.Module):
    def __init__(self, blocks: Sequence[nn.Module], down: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.down = down


@MODELS.register_module("ST-v1m2")
class StratifiedTransformer(nn.Module):
    """Takes a PointBatch and returns it with per-point logits; its
    ``plans`` hold each slot table's truncation (``TableOverflow``: for
    every stage the fine and coarse tables, unshifted then shifted)."""

    def __init__(self, in_channels: int, num_classes: int,
                 channels: Sequence[int] = (48, 96, 192, 384, 384),
                 num_heads: Sequence[int] = (6, 12, 24, 24),
                 depths: Sequence[int] = (3, 9, 3, 3),
                 window_size: Sequence[float] = (0.2, 0.4, 0.8, 1.6),
                 quant_size: Sequence[float] = (0.01, 0.02, 0.04, 0.08),
                 mlp_expend_ratio: float = 4.0, down_ratio: float = 0.25,
                 down_num_sample: int = 16, kp_ball_radius: float = 0.05,
                 kp_max_neighbor: int = 34, kp_sigma_radius: float = 0.02,
                 drop_path_rate: float = 0.2, rel_query: bool = True, rel_key: bool = True,
                 rel_value: bool = True, qkv_bias: bool = True, stem: bool = True,
                 fine_capacity: int = 48, coarse_capacity: int = 16, knn_tile: int = 512,
                 dtype="float32", seed: int = 0):
        super().__init__()
        del knn_tile  # the JAX module's TPU tiling
        dtype = as_dtype(dtype)
        self.dtype, self.stem = dtype, stem
        self.window_size, self.down_ratio = tuple(window_size), down_ratio
        self.down_num_sample = down_num_sample
        self.kp_ball_radius, self.kp_max_neighbor = kp_ball_radius, kp_max_neighbor
        self.fine_capacity, self.coarse_capacity = fine_capacity, coarse_capacity
        num_layers = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.point_embed = nn.ModuleList([KPConvSimpleBlock(in_channels, channels[0],
                                                            kp_sigma_radius, dtype)])
        if stem:
            self.point_embed.append(KPConvResBlock(channels[0], kp_sigma_radius, dtype))
            self.down = TransitionDown(channels[0], channels[1], dtype)
        attn = dict(rel_query=rel_query, rel_key=rel_key, rel_value=rel_value,
                    qkv_bias=qkv_bias)
        self.layers = nn.ModuleList()
        for li in range(num_layers):
            cc = channels[li + 1]
            blocks = [StratifiedBlock(cc, num_heads[li], window_size[li], quant_size[li],
                                      mlp_expend_ratio, dpr[sum(depths[:li]) + d], dtype,
                                      **attn) for d in range(depths[li])]
            down = (TransitionDown(cc, channels[li + 2], dtype) if li < num_layers - 1
                    else None)
            self.layers.append(Stage(blocks, down))
        # up.{j}: j = 0 the deepest transition, the stem's last
        self.up = nn.ModuleList([TransitionUp(channels[li + 2], channels[li + 1], dtype)
                                 for li in reversed(range(num_layers - 1))])
        if stem:
            self.up.append(TransitionUp(channels[1], channels[0], dtype))
        else:
            self.proj_out = Linear(channels[1], channels[0], dtype=dtype)
        self.classifier = nn.ModuleList([Linear(channels[0], channels[0], dtype=dtype),
                                         PointBatchNorm(channels[0], eps=1e-5, momentum=0.1,
                                                        dtype=dtype),
                                         nn.ReLU(), Linear(channels[0], num_classes,
                                                           dtype=dtype)])
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Linear, KPConv)):
                mod.reset_parameters(gen)
            elif isinstance(mod, StratifiedAttention):
                for table in mod.tables():
                    nn.init.trunc_normal_(table, std=0.02, a=-0.04, b=0.04, generator=gen)

    def _samples(self, coord, mask):
        """FPS ids of int(n * down_ratio) + 1 samples of the level."""
        m = int(mask.shape[1] * self.down_ratio) + 1
        return po.farthest_point_sampling(coord, mask, m)[0]

    def _tables(self, coord, mask, ws: float, keys: torch.Tensor):
        """The slot tables (idx, valid), unshifted and shifted, and their
        truncations."""
        big = torch.tensor(_BIG, dtype=coord.dtype, device=coord.device)
        cmin = torch.where(mask[..., None], coord, big).amin(1, keepdim=True)
        tables, overflow = [], []
        for shifted in (False, True):
            off = 0.5 * ws if shifted else 0.0
            fine = window_members(coord + off, mask, ws, cmin, self.fine_capacity)
            coarse = window_members(coord + 2 * off, mask, 2 * ws, cmin, self.coarse_capacity,
                                    subset=keys)
            # coarse keys in the query's own fine window are dropped
            key_wc = take_along_points(fine.window_coord, coarse.idx.reshape(coarse.idx.shape[0], -1))
            key_wc = key_wc.reshape(coarse.idx.shape + (3,))
            other = (key_wc != fine.window_coord[:, :, None, :]).any(-1)
            tables.append((torch.cat([fine.idx, coarse.idx], -1),
                           torch.cat([fine.valid, coarse.valid & other], -1)))
            overflow += [TableOverflow(t.n_overflow, mask) for t in (fine, coarse)]
        return tables, overflow

    def forward(self, point, generator: Optional[torch.Generator] = None):
        coord, mask = point.coord, point.mask
        feat = point.feat.to(self.dtype)
        nidx, _ = po.ball_query(coord, mask, self.kp_max_neighbor, self.kp_ball_radius,
                                pad_mode="shadow")
        feat = self.point_embed[0](feat, nidx, coord, mask)
        stem_skip = None
        if self.stem:
            feat = self.point_embed[1](feat, nidx, coord, mask)
            stem_skip = (feat, coord, mask)
            feat, coord, mask = self.down(feat, coord, mask, self._samples(coord, mask),
                                          self.down_ratio, self.down_num_sample)
        stages, overflow = [], []
        for li, stage in enumerate(self.layers):
            samples = self._samples(coord, mask)
            n_keys = ((mask.sum(1).float() * self.down_ratio).long() + 1).clamp(
                max=samples.shape[1])
            pick = torch.arange(samples.shape[1], device=coord.device) < n_keys[:, None]
            keys = torch.zeros(mask.shape, dtype=torch.long, device=coord.device).scatter_reduce(
                1, samples, pick.long(), "amax").bool() & mask
            tables, stage_overflow = self._tables(coord, mask, self.window_size[li], keys)
            overflow += stage_overflow
            for d, blk in enumerate(stage.blocks):
                slot_idx, slot_valid = tables[d % 2]
                feat = blk(feat, coord, slot_idx, slot_valid, generator)
            stages.append((feat, coord, mask))
            if stage.down is not None:
                feat, coord, mask = stage.down(feat, coord, mask, samples, self.down_ratio,
                                               self.down_num_sample)
        feat, coord, mask = stages.pop()
        skips = stages[::-1] + ([stem_skip] if self.stem else [])
        for up, (skip_feat, skip_coord, skip_mask) in zip(self.up, skips):
            feat = up(feat, coord, mask, skip_feat, skip_coord, skip_mask)
            coord, mask = skip_coord, skip_mask
        if not self.stem:
            feat = self.proj_out(feat)
        fc1, bn, _, fc2 = self.classifier
        logits = fc2(F.relu(bn(fc1(feat), mask)))
        return point.replace(feat=logits, coord=coord, mask=mask, plans=tuple(overflow))


@MODELS.register_module("ST-v1m1")
class StratifiedTransformerV1M1(StratifiedTransformer):
    """The original formulation's name (stratified_transformer_v1m1_origin.py):
    the reference differs from v1m2 only in its CUDA attention steps, which
    have one formulation here, as in the JAX package."""
