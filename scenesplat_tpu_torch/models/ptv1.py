"""Point Transformer V1 (counterpart of ``scenesplat_tpu/models/ptv1.py``), on
padded batches:

  - pointops.knn_query_and_group: ``ops/pointops.py:knn`` and ``grouping``;
  - pointops.farthest_point_sampling in TransitionDown: the batched FPS at
    n_valid // stride samples a row (``ops/pointops.py``; on the card one
    launch of the kernel ``csrc/farthest_point_sampling.cu``);
  - pointops.interpolation in TransitionUp: inverse-distance 3-NN;
  - LayerNorm1d (a transposed BatchNorm1d) and BatchNorm1d:
    ``models/norm.py:PointBatchNorm`` (eps 1e-5, momentum 0.1) over the
    valid points or neighbour slots, as the JAX package normalizes them.

Registered: PointTransformer-Seg26/38/50 (point_transformer_seg.py),
PointTransformer-Cls26/38/50 (point_transformer_cls.py: an encoder, the
rows' mean and an MLP; its stages build ``blocks - 1`` bottlenecks, as the
reference does) and PointTransformer-PartSeg26/38/50 (Seg with the
optional ``num_shape_classes``: the head conditioned on each row's shape
category, ``cls_token``). Parameter names are the reference's:
``enc{s}.0.{linear,bn}`` (TransitionDown), ``enc{s}.{i}`` bottlenecks
(``linear1``, ``bn1``, ``transformer.{linear_q,linear_k,linear_v,
linear_p.{0,1,3},linear_w.{0,2,3,5}}``, ``bn2``, ``linear3``, ``bn3``),
``dec{s}.0.{linear1,linear2,linear3}.{0,1}`` (TransitionUp), ``dec{s}.1``
and ``cls.{0,1,3}`` (Seg) or ``cls.{0,1,4,5,8}`` (Cls). Parameters are
drawn from ``seed``; the Cls head's dropout draws from the forward's
generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops import pointops as po
from scenesplat_tpu_torch.ops.segops import at_least_fp32, masked_mean_pool
from scenesplat_tpu_torch.ops.serialization import take_along_points

from .builder import MODELS
from .norm import MaskedBatchNorm, PointBatchNorm
from .ptv3 import Linear, as_dtype, dropout

PLANES = (32, 64, 128, 256, 512)
STRIDE = (1, 4, 4, 4, 4)
NSAMPLE = (8, 16, 16, 16, 16)


def _bn(features: int, dtype) -> PointBatchNorm:
    return PointBatchNorm(features, eps=1e-5, momentum=0.1, dtype=dtype)


class PointTransformerLayer(nn.Module):
    """Vector self-attention over each point's k nearest."""

    def __init__(self, in_planes: int, out_planes: int, share_planes: int = 8,
                 nsample: int = 16, dtype=torch.float32):
        super().__init__()
        c, s = out_planes, share_planes
        self.share_planes, self.nsample = s, nsample
        self.linear_q = Linear(in_planes, c, dtype=dtype)
        self.linear_k = Linear(in_planes, c, dtype=dtype)
        self.linear_v = Linear(in_planes, c, dtype=dtype)
        self.linear_p = nn.ModuleList([Linear(3, 3, dtype=dtype), _bn(3, dtype), nn.ReLU(),
                                       Linear(3, c, dtype=dtype)])
        self.linear_w = nn.ModuleList([_bn(c, dtype), nn.ReLU(), Linear(c, c // s, dtype=dtype),
                                       _bn(c // s, dtype), nn.ReLU(),
                                       Linear(c // s, c // s, dtype=dtype)])

    def forward(self, feat, coord, mask):
        q, k, v = self.linear_q(feat), self.linear_k(feat), self.linear_v(feat)
        idx, _ = po.knn(coord, mask, self.nsample)
        kg = po.grouping(idx, k, coord)
        vg = po.grouping(idx, v, coord)
        pos = po.grouped_offsets(idx, coord).to(kg.dtype)
        ok = idx >= 0
        p = self.linear_p
        pr = p[3](F.relu(p[1](p[0](pos), ok)))
        w = self.linear_w
        r = F.relu(w[0](kg - q[:, :, None, :] + pr, ok))
        r = F.relu(w[3](w[2](r), ok))
        r = w[5](r)
        r = torch.softmax(torch.where(ok[..., None], at_least_fp32(r), -1e9), dim=2).to(r.dtype)
        b, n, kk, c = vg.shape
        s = self.share_planes
        val = (vg + pr).reshape(b, n, kk, s, c // s)
        return torch.einsum("bntsi,bnti->bnsi", val, r).reshape(b, n, c)


class TransitionDown(nn.Module):
    """Stride 1: linear + BN + ReLU. Otherwise FPS to n_valid // stride
    points a row, each one's k nearest grouped with their offsets, linear +
    BN + ReLU, and the max over the neighbours."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1, nsample: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.stride, self.nsample = stride, nsample
        cin = in_planes if stride == 1 else 3 + in_planes
        self.linear = Linear(cin, out_planes, bias=False, dtype=dtype)
        self.bn = _bn(out_planes, dtype)

    def forward(self, feat, coord, mask):
        if self.stride == 1:
            return F.relu(self.bn(self.linear(feat), mask)), coord, mask
        m = max(1, coord.shape[1] // self.stride)
        idx, _ = po.farthest_point_sampling(coord, mask, m)
        n_new = (mask.sum(1) // self.stride).clamp(min=1)
        new_mask = torch.arange(m, device=coord.device) < n_new[:, None]
        new_coord = take_along_points(coord, idx)
        nidx, _ = po.knn(coord, mask, self.nsample, query=new_coord, query_mask=new_mask)
        g = po.grouping(nidx, feat, coord, query_coord=new_coord, with_xyz=True)
        ok = nidx >= 0
        x = F.relu(self.bn(self.linear(g), ok))
        x = torch.where(ok[..., None], x, float("-inf")).amax(2)
        x = torch.where(new_mask[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
        return x, new_coord, new_mask


class TransitionUp(nn.Module):
    """``out_planes`` 0 (the head): each row's mean context, ReLU(linear2),
    concatenated to every point (and with ``num_shape_classes`` a 1024-wide
    embedding of the row's shape category, ``linear3``), then linear1 + BN
    + ReLU. Otherwise linear1 + BN + ReLU of the points plus the
    interpolation of linear2 + BN + ReLU of the coarser points."""

    def __init__(self, in_planes: int, out_planes: int = 0,
                 num_shape_classes: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.head = out_planes == 0
        self.num_shape_classes = num_shape_classes
        if self.head:
            extra = 1024 if num_shape_classes is not None else 0
            self.linear1 = nn.ModuleList([Linear(2 * in_planes + extra, in_planes, dtype=dtype),
                                          _bn(in_planes, dtype), nn.ReLU()])
            self.linear2 = nn.ModuleList([Linear(in_planes, in_planes, dtype=dtype), nn.ReLU()])
            if num_shape_classes is not None:
                self.linear3 = nn.ModuleList([Linear(num_shape_classes, 1024, dtype=dtype),
                                              nn.ReLU()])
        else:
            self.linear1 = nn.ModuleList([Linear(out_planes, out_planes, dtype=dtype),
                                          _bn(out_planes, dtype), nn.ReLU()])
            self.linear2 = nn.ModuleList([Linear(in_planes, out_planes, dtype=dtype),
                                          _bn(out_planes, dtype), nn.ReLU()])

    def forward(self, feat, coord, mask, sub=None, cls_token=None):
        if self.head:
            b, n, _ = feat.shape
            ctx = F.relu(self.linear2[0](masked_mean_pool(feat, mask)))
            parts = [feat, ctx[:, None, :].expand(b, n, -1)]
            if self.num_shape_classes is not None:
                if cls_token is None:
                    raise ValueError("a PartSeg head with num_shape_classes needs cls_token")
                onehot = F.one_hot(cls_token.reshape(-1).long(), self.num_shape_classes)
                y = F.relu(self.linear3[0](onehot.to(feat.dtype)))
                parts.append(y[:, None, :].expand(b, n, -1))
            return F.relu(self.linear1[1](self.linear1[0](torch.cat(parts, -1)), mask))
        sub_feat, sub_coord, sub_mask = sub
        x1 = F.relu(self.linear1[1](self.linear1[0](feat), mask))
        x2 = F.relu(self.linear2[1](self.linear2[0](sub_feat), sub_mask))
        return x1 + po.interpolation(sub_coord, sub_mask, coord, mask, x2)


class Bottleneck(nn.Module):
    """linear -> transformer -> linear, with BNs and the residual."""

    def __init__(self, planes: int, share_planes: int = 8, nsample: int = 16,
                 dtype=torch.float32):
        super().__init__()
        self.linear1 = Linear(planes, planes, bias=False, dtype=dtype)
        self.bn1 = _bn(planes, dtype)
        self.transformer = PointTransformerLayer(planes, planes, share_planes, nsample, dtype)
        self.bn2 = _bn(planes, dtype)
        self.linear3 = Linear(planes, planes, bias=False, dtype=dtype)
        self.bn3 = _bn(planes, dtype)

    def forward(self, feat, coord, mask):
        x = F.relu(self.bn1(self.linear1(feat), mask))
        x = F.relu(self.bn2(self.transformer(x, coord, mask), mask))
        x = self.bn3(self.linear3(x), mask)
        return F.relu(feat + x)


def _init(model: nn.Module, seed: int):
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, Linear):
            mod.reset_parameters(gen)


class _Encoder(nn.Module):
    """Five stages ``enc1`` .. ``enc5``: a TransitionDown (``.0``) and
    bottlenecks."""

    def _build_encoder(self, in_channels, blocks, share_planes, first_block, dtype):
        for s in range(5):
            layers = [TransitionDown(in_channels if s == 0 else PLANES[s - 1], PLANES[s],
                                     STRIDE[s], NSAMPLE[s], dtype)]
            layers += [Bottleneck(PLANES[s], share_planes, NSAMPLE[s], dtype)
                       for _ in range(first_block, blocks[s])]
            self.add_module(f"enc{s + 1}", nn.ModuleList(layers))

    def _encode(self, feat, coord, mask):
        stages = []
        for s in range(5):
            down, *blocks = getattr(self, f"enc{s + 1}")
            feat, coord, mask = down(feat, coord, mask)
            for blk in blocks:
                feat = blk(feat, coord, mask)
            stages.append((feat, coord, mask))
        return stages


class PointTransformerSeg(_Encoder):
    """Five encoder stages (FPS at stride 4 after the first), five decoder
    stages, a per-point classifier; returns the PointBatch with logits."""

    def __init__(self, blocks: Sequence[int] = (1, 1, 1, 1, 1), in_channels: int = 6,
                 num_classes: int = 13, share_planes: int = 8,
                 num_shape_classes: Optional[int] = None, dtype="float32", seed: int = 0):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.out_channels = num_classes
        self._build_encoder(in_channels, blocks, share_planes, 0, dtype)
        self.dec5 = nn.ModuleList([TransitionUp(PLANES[4], 0, num_shape_classes, dtype),
                                   Bottleneck(PLANES[4], share_planes, NSAMPLE[4], dtype)])
        for s in reversed(range(4)):
            self.add_module(f"dec{s + 1}", nn.ModuleList([
                TransitionUp(PLANES[s + 1], PLANES[s], dtype=dtype),
                Bottleneck(PLANES[s], share_planes, NSAMPLE[s], dtype)]))
        self.cls = nn.ModuleList([Linear(PLANES[0], PLANES[0], dtype=dtype),
                                  _bn(PLANES[0], dtype), nn.ReLU(),
                                  Linear(PLANES[0], num_classes, dtype=dtype)])
        _init(self, seed)

    def forward(self, point, generator: Optional[torch.Generator] = None,
                cls_token: Optional[torch.Tensor] = None):
        stages = self._encode(point.feat.to(self.dtype), point.coord, point.mask)
        feat, coord, mask = stages[4]
        up, blk = self.dec5
        feat = blk(up(feat, coord, mask, cls_token=cls_token), coord, mask)
        for s in reversed(range(4)):
            up, blk = getattr(self, f"dec{s + 1}")
            up_feat, up_coord, up_mask = stages[s]
            feat = up(up_feat, up_coord, up_mask, sub=(feat, coord, mask))
            coord, mask = up_coord, up_mask
            feat = blk(feat, coord, mask)
        c = self.cls
        logits = c[3](F.relu(c[1](c[0](feat), mask)))
        return point.replace(feat=logits, coord=coord, mask=mask)


class PointTransformerCls(_Encoder):
    """The encoder (``blocks[s] - 1`` bottlenecks a stage), each row's mean
    and an MLP head (BatchNorm1d, dropout 0.5); returns logits [B,
    num_classes]. ``in_channels`` counts the 3 coordinates the reference
    prepends to the features."""

    def __init__(self, blocks: Sequence[int] = (1, 1, 1, 1, 1), in_channels: int = 6,
                 num_classes: int = 40, share_planes: int = 8, dtype="float32",
                 seed: int = 0):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dtype, self.in_channels = dtype, in_channels
        self._build_encoder(in_channels, blocks, share_planes, 1, dtype)
        bn = lambda c: MaskedBatchNorm(c, eps=1e-5, momentum=0.1)  # noqa: E731
        self.cls = nn.ModuleList([Linear(PLANES[4], 256), bn(256), nn.ReLU(), nn.Dropout(0.5),
                                  Linear(256, 128), bn(128), nn.ReLU(), nn.Dropout(0.5),
                                  Linear(128, num_classes)])
        _init(self, seed)

    def forward(self, point, generator: Optional[torch.Generator] = None):
        coord = point.coord
        feat = coord.to(self.dtype)
        if self.in_channels != 3:
            feat = torch.cat([feat, point.feat.to(self.dtype)[..., :self.in_channels - 3]], -1)
        feat, _, mask = self._encode(feat, coord, point.mask)[4]
        x = masked_mean_pool(feat, mask).float()
        rows = torch.ones(1, x.shape[0], dtype=torch.bool, device=x.device)
        p = 0.5 if self.training else 0.0
        c = self.cls
        for lin, norm in ((c[0], c[1]), (c[4], c[5])):
            x = dropout(F.relu(norm(lin(x)[None], rows)[0]), p, generator)
        return c[8](x)


def _variant(base, blocks, doc):
    """``base`` with its ``blocks`` default replaced."""

    class Variant(base):
        __doc__ = doc

        def __init__(self, blocks: Sequence[int] = blocks, **kwargs):
            super().__init__(blocks=blocks, **kwargs)

    return Variant


for _name, _blocks in (("26", (1, 1, 1, 1, 1)), ("38", (1, 2, 2, 2, 2)),
                       ("50", (1, 2, 3, 5, 2))):
    MODELS.register_module(f"PointTransformer-Seg{_name}")(
        _variant(PointTransformerSeg, _blocks, f"Reference Seg{_name}."))
    MODELS.register_module(f"PointTransformer-Cls{_name}")(
        _variant(PointTransformerCls, _blocks, f"Reference Cls{_name}."))
    MODELS.register_module(f"PointTransformer-PartSeg{_name}")(
        _variant(PointTransformerSeg, _blocks, f"Reference PartSeg{_name}: set "
                 "num_shape_classes for category-conditioned part segmentation."))
