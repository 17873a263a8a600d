"""Point Transformer V3 backbone, eval and train forward (counterpart of
``scenesplat_tpu/models/ptv3.py``).

Fixed-shape padded batches as in the JAX package: serialized attention is
the flash-window kernel over contiguous windows of the curve-sorted
sequence; SubMConv3d is a gather per kernel offset over a neighbour plan
built once per stage; pooling clusters come from sorted curve codes into
static per-stage capacities with a discard bin; BatchNorm excludes padding.

Submodule names follow the Pointcept PTv3 state-dict layout
(``embedding.stem.conv``, ``enc.enc{s}.block{i}.cpe.0``, ``attn.qkv``,
``mlp.0.fc1``, ``dec.dec{s}.up.proj_skip.1``, ...), so a reference
checkpoint, or the JAX package's weights carried by utils/weights.py, loads
with ``load_state_dict(strict=True)``. Parameters are fp32 and cast to the
compute dtype at each linear and conv, which accumulate in fp32; norms
compute in fp32. GELU is the exact (erf) form.

In training (``self.training``) the forward takes a ``torch.Generator``
for its random draws, as the JAX package takes its ``shuffle`` and
``dropout`` keys: the logical curve order is shuffled (``shuffle_orders``),
drop-path drops whole points of the attention and of the MLP branch with
independent draws, and MLP and projection dropout act at ``proj_drop``.
All of them are identity at eval.

With ``pdnorm_conditions`` every norm (the stem's, pooling's and
unpooling's BatchNorms with ``pdnorm_bn``, the blocks' LayerNorms with
``pdnorm_ln``) is a PDNorm (models/norm.py) and the forward takes the
batch's dataset ``condition`` by name, with an optional ``context``
[B, context_channels] for the adaptive affine (Point Prompt Training,
models/ppt.py). ``enable_rpe`` adds the relative-position bias table to
every attention, which then takes the plain dense path
(ops/window_attention.py:window_attention_rpe) and not the flash-window
kernels, as in the JAX package and the reference.

Under tensor parallel (``parallel/tp.py:shard_model_tp``) a block's qkv and
fc1 are column-parallel and its attention proj and fc2 row-parallel
``Linear``s over the layout's model group: the attention runs K1 and K2 on
the rank's H / tp heads, and the MLP on its share of the hidden width.
Under context parallel (a layout with a seq axis, ``parallel/context.py``)
a rank holds a block of each stage's slots (``StageState.part``): the
forward gathers the geometry once, runs the per-point layers on its block
and K1 and K2 on its whole windows, and gathers features at the ops that
mix points; its output is the rank's block of the input's slots.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from scenesplat_tpu_torch.ops.segops import (
    PoolingPlan,
    build_pooling_plan,
    pool_serialization,
    pool_values,
    unpool_values,
)
from scenesplat_tpu_torch.ops.serialization import Serialization, take_along_points
from scenesplat_tpu_torch.ops.subm_conv import (
    SubMConvPlan,
    build_subm_conv_plan,
    plan_rows,
    subm_conv_apply,
    subplan,
)
from scenesplat_tpu_torch.ops.window_attention import (
    rank_windows,
    rpe_pos_bnd,
    window_attention,
    window_attention_rpe,
)
from scenesplat_tpu_torch.parallel.context import Part, seq_gather
from scenesplat_tpu_torch.parallel.dist import (
    batch_rand,
    copy_to_group,
    layout,
    reduce_from_group,
)

from .builder import MODELS
from .norm import LayerNorm, MaskedBatchNorm, PDNorm
from .structure import PointBatch


def as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            per_point: bool = False, channels=None) -> torch.Tensor:
    """flax ``nn.Dropout`` on ``x`` [B, N, ...] (axis 1 the points): keep
    with probability 1 - p and scale kept values by 1 / (1 - p).
    ``per_point`` draws one value per point and broadcasts it over channels
    (drop-path, flax ``broadcast_dims=(2,)``). Under data parallel the
    masks are this process's rows of one draw at the global batch's shape
    (``parallel/dist.py:batch_rand``; under context parallel its points of
    it too), and ``channels`` (a tensor-parallel share of the hidden width)
    its columns."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("a training forward with dropout or drop-path needs a "
                         "torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = x.shape[:-1] + (1,) if per_point else x.shape
    keep = batch_rand(shape, generator, x.device, points=True, channels=channels) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


@dataclass(frozen=True)
class PDCfg:
    """The PDNorm switches of a PT-v3m1 (its ``pdnorm_*`` arguments)."""

    conditions: Tuple[str, ...]
    bn: bool = True
    ln: bool = True
    decouple: bool = True
    adaptive: bool = False
    context_channels: int = 256


def make_norm(features: int, kind: str, dtype, pd: Optional[PDCfg] = None) -> nn.Module:
    """A LayerNorm (``kind`` "ln") or MaskedBatchNorm ("bn"), or the PDNorm
    that takes its place when ``pd`` conditions that kind."""
    if pd is None or not getattr(pd, kind):
        return LayerNorm(features, dtype=dtype) if kind == "ln" else MaskedBatchNorm(
            features, dtype=dtype)
    return PDNorm(features, pd.conditions, norm_type=kind, decouple=pd.decouple,
                  adaptive=pd.adaptive, context_channels=pd.context_channels, dtype=dtype)


def apply_norm(norm: nn.Module, x, cond=None, mask=None):
    """``norm`` on ``x`` (a BatchNorm with the valid ``mask``); a PDNorm
    also takes ``cond`` = (condition name, context or None)."""
    if isinstance(norm, PDNorm):
        if cond is None or cond[0] is None:
            raise ValueError("a PDNorm-conditioned backbone needs the batch's condition")
        return norm(x, cond[0], context=cond[1], mask=mask)
    return norm(x) if mask is None else norm(x, mask)


@dataclass(frozen=True)
class StageState:
    """Per-stage geometry shared by all blocks of the stage. Under context
    parallel ``part`` is the rank's block of the stage's slots: the
    geometry is the whole stage's, ``conv_plan`` the block's rows of it."""

    coord: torch.Tensor
    grid_coord: torch.Tensor
    mask: torch.Tensor
    ser: Serialization
    conv_plan: SubMConvPlan
    part: Optional[Part] = None

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's slots of a whole-stage tensor (all of it without
        context parallel)."""
        return x if self.part is None else self.part.own(x)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The stage's features from every rank's block (``x`` itself
        without context parallel)."""
        return x if self.part is None else self.part.whole(x)


def stage_state(coord, grid_coord, mask, ser, plan: SubMConvPlan, cp: bool) -> StageState:
    """The StageState of a stage; under context parallel (``cp``) with the
    rank's block of its slots and of its conv plan's rows."""
    if not cp:
        return StageState(coord, grid_coord, mask, ser, plan)
    part = Part.of(mask.shape[1])
    return StageState(coord, grid_coord, mask, ser, plan_rows(plan, part.lo, part.hi), part)


class Linear(nn.Module):
    """Dense layer: fp32 parameters cast to the compute dtype per call.
    ``tp`` (set by ``Block.shard_tp``) makes it a share of a
    tensor-parallel layer over a process group: ("column", group) holds
    some output features (its input summed over the group in the
    backward), ("row", group) some input features (its partial products
    summed in the forward, then the bias added once)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None
        self.tp = None

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is None:
            return F.linear(x.to(dt), self.weight.to(dt), b)
        kind, group = self.tp
        if kind == "column":
            return F.linear(copy_to_group(x.to(dt), group), self.weight.to(dt), b)
        y = reduce_from_group(F.linear(x.to(dt), self.weight.to(dt)), group)
        return y if b is None else y + b


class SubMConv(nn.Module):
    """spconv.SubMConv3d stand-in; weight in spconv's [k, k, k, Cin, Cout]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        k = kernel_size
        self.weight = nn.Parameter(torch.empty(k, k, k, in_channels, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        k, _, _, cin, _ = self.weight.shape
        bound = 1.0 / math.sqrt(cin * k ** 3)
        self.weight.data.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, feat, plan: SubMConvPlan):
        k, _, _, cin, cout = self.weight.shape
        dt = self.dtype
        return subm_conv_apply(
            feat.to(dt), plan, self.weight.reshape(k ** 3, cin, cout).to(dt),
            None if self.bias is None else self.bias.to(dt))


class MLP(nn.Module):
    """fc1 - GELU - dropout - fc2 - dropout. Under tensor parallel
    ``hidden_span`` = (hidden width, first, end) is the rank's share of the
    hidden features, whose dropout mask is cut from a draw at the whole
    width."""

    def __init__(self, channels: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.hidden = hidden
        self.drop = drop
        self.fc1 = Linear(channels, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, channels, dtype=dtype)
        self.hidden_span = None

    def forward(self, x, generator=None):
        p = self.drop if self.training else 0.0
        x = F.gelu(self.fc1(x))
        if self.hidden_span is None:
            x = dropout(x, p, generator)
        else:  # the rank's columns of a draw at the whole hidden width
            x = dropout(x, p, generator, channels=self.hidden_span)
        return dropout(self.fc2(x), p, generator)


class RPE(nn.Module):
    """The relative-position bias table of a window of ``patch_size``:
    [3 * (2 * pos_bnd + 1), heads], one block of rows per axis."""

    def __init__(self, patch_size: int, num_heads: int):
        super().__init__()
        self.rpe_table = nn.Parameter(torch.zeros(3 * (2 * rpe_pos_bnd(patch_size) + 1),
                                                  num_heads))

    def reset_parameters(self, gen: torch.Generator):
        # flax's truncated_normal(0.02): cut at 2 std
        nn.init.trunc_normal_(self.rpe_table.data, std=0.02, a=-0.04, b=0.04, generator=gen)


class SerializedAttention(nn.Module):
    """Window attention over one curve order; with ``enable_rpe``, plus the
    relative-position bias of the points' grid coordinates (``rpe``).
    Under tensor parallel (``tp_degree`` > 1) qkv, proj and the RPE table
    hold the rank's num_heads / tp_degree heads; ``scale`` stays that of
    the whole layer's head width. Under context parallel the rank runs its
    whole windows of the curve order (``_forward_windows``)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int = 0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 use_kernel: Optional[bool] = None, enable_rpe: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.order_index, self.use_kernel = order_index, use_kernel
        self.proj_drop = proj_drop
        self.scale = qk_scale or (channels // num_heads) ** -0.5
        self.qkv = Linear(channels, 3 * channels, bias=qkv_bias, dtype=dtype)
        self.rpe = RPE(patch_size, num_heads) if enable_rpe else None
        self.proj = Linear(channels, channels, dtype=dtype)
        self.tp_degree = 1

    def _attend(self, qkv, valid, grid):
        """Window attention of curve-sorted qkv [B, M, 3 * C_rank] of the
        rank's heads -> [B, M, C_rank]."""
        b, m = qkv.shape[:2]
        c, heads = self.channels // self.tp_degree, self.num_heads // self.tp_degree
        qkv = qkv.view(b, m, 3, c)
        if m == 0:  # a context-parallel rank without windows at this stage
            return qkv[:, :, 0]
        if self.rpe is not None:
            return window_attention_rpe(qkv, valid, grid, self.rpe.rpe_table, self.patch_size,
                                        heads, scale=self.scale)
        return window_attention(qkv, valid, self.patch_size, heads, scale=self.scale,
                                use_kernel=self.use_kernel)

    def forward(self, feat, state: StageState, generator=None):
        order = state.ser.curve_order(self.order_index)
        inverse = state.ser.curve_inverse(self.order_index)
        if state.part is not None:
            out = self._forward_windows(feat, state, order, inverse)
        else:
            grid = None if self.rpe is None else take_along_points(state.grid_coord, order)
            out_sorted = self._attend(take_along_points(self.qkv(feat), order),
                                      take_along_points(state.mask, order), grid)
            out = self.proj(take_along_points(out_sorted, inverse))
        return dropout(out, self.proj_drop if self.training else 0.0, generator)

    def _forward_windows(self, feat, state: StageState, order, inverse):
        """Context parallel: the stage's features gathered, this rank's
        whole windows of the curve order through qkv, the attention and
        proj, every rank's windows gathered and the rank's slots kept."""
        n = state.mask.shape[1]
        grid = layout()
        lo, hi = rank_windows(n, self.patch_size, grid.seq, grid.seq_rank)
        mine = order[:, lo:hi]
        coords = None if self.rpe is None else take_along_points(state.grid_coord, mine)
        out = self.proj(self._attend(self.qkv(take_along_points(state.whole(feat), mine)),
                                     take_along_points(state.mask, mine), coords))
        return take_along_points(seq_gather(out, n, lo, hi), state.own(inverse))


class Block(nn.Module):
    """xCPE + pre-norm attention + pre-norm MLP; in training, drop-path on
    the attention and the MLP branch (independent draws)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 drop_path: float = 0.0, pre_norm: bool = True,
                 order_index: int = 0, use_kernel: Optional[bool] = None,
                 enable_rpe: bool = False, pd: Optional[PDCfg] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.pre_norm = pre_norm
        self.drop_path = drop_path
        self.cpe = nn.ModuleList([
            SubMConv(c, c, kernel_size=3, dtype=dtype),
            Linear(c, c, dtype=dtype),
            make_norm(c, "ln", dtype, pd),
        ])
        self.norm1 = nn.ModuleList([make_norm(c, "ln", dtype, pd)])
        self.attn = SerializedAttention(
            c, num_heads, patch_size, order_index=order_index, qkv_bias=qkv_bias,
            qk_scale=qk_scale, proj_drop=proj_drop, use_kernel=use_kernel,
            enable_rpe=enable_rpe, dtype=dtype)
        self.norm2 = nn.ModuleList([make_norm(c, "ln", dtype, pd)])
        self.mlp = nn.ModuleList([MLP(c, mlp_ratio, drop=proj_drop, dtype=dtype)])

    def tp_divides(self, degree: int) -> bool:
        """Whether tensor parallel at ``degree`` cuts this block: its heads
        and its hidden width split evenly (else it stays whole)."""
        return self.attn.num_heads % degree == 0 and self.mlp[0].hidden % degree == 0

    def shard_tp(self, degree: int, index: int, group) -> None:
        """Makes the block model rank ``index``'s share of a tensor-parallel
        block over ``group`` (``parallel/tp.py:shard_model_tp`` cuts its
        parameters): qkv and fc1 column-parallel, proj and fc2
        row-parallel, the attention on num_heads / degree heads, the MLP's
        dropout on the rank's share of the hidden width."""
        attn, mlp = self.attn, self.mlp[0]
        attn.tp_degree = degree
        attn.qkv.tp = mlp.fc1.tp = ("column", group)
        attn.proj.tp = mlp.fc2.tp = ("row", group)
        mlp.hidden_span = (mlp.hidden, index * mlp.hidden // degree,
                           (index + 1) * mlp.hidden // degree)

    def forward(self, feat, state: StageState, cpe_feat=None, generator=None, cond=None):
        # cpe_feat: the first block after unpooling convolves the proj_skip
        # features (see SerializedUnpooling); cond: (condition, context)
        # for PDNorms
        conv, linear, norm = self.cpe
        x = conv(state.whole(feat if cpe_feat is None else cpe_feat), state.conv_plan)
        feat = feat + apply_norm(norm, linear(x), cond)

        dp = self.drop_path if self.training else 0.0
        shortcut = feat
        if self.pre_norm:
            feat = apply_norm(self.norm1[0], feat, cond)
        feat = shortcut + dropout(self.attn(feat, state, generator), dp, generator,
                                  per_point=True)
        if not self.pre_norm:
            feat = apply_norm(self.norm1[0], feat, cond)

        shortcut = feat
        if self.pre_norm:
            feat = apply_norm(self.norm2[0], feat, cond)
        feat = shortcut + dropout(self.mlp[0](feat, generator), dp, generator,
                                  per_point=True)
        if not self.pre_norm:
            feat = apply_norm(self.norm2[0], feat, cond)
        return feat


class SerializedPooling(nn.Module):
    """Grid pooling by right-shifted curve-0 codes. Under context parallel
    the stage's features are gathered and pooled whole; the features
    returned are the rank's block of the clusters (``Part.of``)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 reduce: str = "mean", pd: Optional[PDCfg] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooling_depth = (math.ceil(stride) - 1).bit_length()
        self.reduce = reduce
        self.proj = Linear(in_channels, out_channels, dtype=dtype)
        self.norm = nn.ModuleList([make_norm(out_channels, "bn", dtype, pd)])

    def forward(self, feat, state: StageState, out_capacity: int, cond=None):
        depth = self.pooling_depth
        plan = build_pooling_plan(state.ser, state.mask, out_capacity, depth)
        x = pool_values(plan, self.proj(state.whole(feat)), self.reduce)
        coord = pool_values(plan, state.coord, "mean")
        grid_coord = take_along_points(state.grid_coord, plan.head_index) >> depth
        ser = pool_serialization(plan, state.ser, depth)
        mask = plan.out_mask
        if state.part is not None:
            part = Part.of(out_capacity)
            x, mask = part.own(x), part.own(mask)
        x = F.gelu(apply_norm(self.norm[0], x, cond, mask))
        return x, coord, grid_coord, plan.out_mask, ser, plan


class SerializedUnpooling(nn.Module):
    """Broadcast pooled features back to the parent points, plus a skip.

    Returns (unpooled_feat, skip_feat). The reference assigns the summed
    feature without re-syncing its sparse-conv feature, so the first
    decoder block's xCPE conv reads the proj_skip output, not the sum.
    ``coarse`` and ``parent`` are the two stages' StageStates: under
    context parallel the pooled features are gathered and the rank's
    parent slots kept."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 pd: Optional[PDCfg] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.ModuleList([Linear(in_channels, out_channels, dtype=dtype),
                                   make_norm(out_channels, "bn", dtype, pd)])
        self.proj_skip = nn.ModuleList([
            Linear(skip_channels, out_channels, dtype=dtype),
            make_norm(out_channels, "bn", dtype, pd)])

    def forward(self, feat, parent_feat, coarse: StageState, parent: StageState,
                plan: PoolingPlan, cond=None):
        x = F.gelu(apply_norm(self.proj[1], self.proj[0](feat), cond, coarse.own(coarse.mask)))
        skip = F.gelu(apply_norm(self.proj_skip[1], self.proj_skip[0](parent_feat), cond,
                                 parent.own(parent.mask)))
        return skip + unpool_values(coarse.whole(x), parent.own(plan.cluster_of_point)), skip


class Embedding(nn.Module):
    """Stem: submanifold conv k=5 + BN + GELU."""

    def __init__(self, in_channels: int, embed_channels: int, pd: Optional[PDCfg] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = nn.ModuleDict(dict(
            conv=SubMConv(in_channels, embed_channels, kernel_size=5, bias=False,
                          dtype=dtype),
            norm=make_norm(embed_channels, "bn", dtype, pd),
        ))

    def forward(self, feat, plan: SubMConvPlan, mask, cond=None):
        return F.gelu(apply_norm(self.stem["norm"], self.stem["conv"](feat, plan), cond, mask))


def _round_capacity(n: int, frac: float, patch: int) -> int:
    cap = max(patch, int(math.ceil(n * frac / patch)) * patch)
    return min(cap, max(patch, int(math.ceil(n / patch)) * patch))


class _Stage(nn.Module):
    """Container whose children are named ``down``/``up`` and ``block{i}``."""

    def __init__(self, blocks: Sequence[nn.Module], **resample: nn.Module):
        super().__init__()
        for name, mod in resample.items():
            self.add_module(name, mod)
        for i, blk in enumerate(blocks):
            self.add_module(f"block{i}", blk)
        self.num_blocks = len(blocks)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]


@MODELS.register_module("PT-v3m1")
class PointTransformerV3(nn.Module):
    """Flagship backbone. ``drop_path``, ``proj_drop`` and
    ``shuffle_orders`` act only in training. ``attn_drop`` is accepted and,
    as in the JAX package, never applied (neither attention kernel drops
    probabilities); ``upcast_softmax`` is accepted for config
    compatibility, the softmax always runs in fp32. ``use_kernel`` is
    passed to ops.window_attention. ``remat_blocks`` recomputes each
    block in the backward instead of keeping its activations
    (``_block``). ``enable_rpe`` and the ``pdnorm_*`` switches are the
    reference's (see the module docstring). ``cls_mode`` builds the
    encoder alone (no ``dec.*`` module): the forward returns the coarsest
    stage's features, coordinates, mask and serialization, for a
    classification head. Parameters are drawn from ``seed``."""

    def __init__(
        self,
        in_channels: int = 6,
        order: Sequence[str] = ("z", "z-trans"),
        stride: Sequence[int] = (2, 2, 2, 2),
        enc_depths: Sequence[int] = (2, 2, 2, 6, 2),
        enc_channels: Sequence[int] = (32, 64, 128, 256, 512),
        enc_num_head: Sequence[int] = (2, 4, 8, 16, 32),
        enc_patch_size: Sequence[int] = (48, 48, 48, 48, 48),
        dec_depths: Sequence[int] = (2, 2, 2, 2),
        dec_channels: Sequence[int] = (64, 64, 128, 256),
        dec_num_head: Sequence[int] = (4, 4, 8, 16),
        dec_patch_size: Sequence[int] = (48, 48, 48, 48),
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        qk_scale: Optional[float] = None,
        attn_drop: float = 0.0,
        proj_drop: float = 0.0,
        drop_path: float = 0.3,
        pre_norm: bool = True,
        shuffle_orders: bool = True,
        upcast_softmax: bool = True,
        pool_reduce: str = "mean",
        serialization_depth: int = 16,
        stage_capacity: Optional[Sequence[float]] = None,
        use_kernel: Optional[bool] = None,
        enable_mask_token: bool = False,
        remat_blocks: bool = False,
        enable_rpe: bool = False,
        cls_mode: bool = False,
        pdnorm_conditions: Optional[Sequence[str]] = None,
        pdnorm_bn: bool = True,
        pdnorm_ln: bool = True,
        pdnorm_decouple: bool = True,
        pdnorm_adaptive: bool = False,
        context_channels: int = 256,
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        dtype = as_dtype(dtype)
        pd = (PDCfg(tuple(pdnorm_conditions), bn=pdnorm_bn, ln=pdnorm_ln,
                    decouple=pdnorm_decouple, adaptive=pdnorm_adaptive,
                    context_channels=context_channels) if pdnorm_conditions else None)
        self.pdnorm_conditions = None if pd is None else pd.conditions
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        self.order = (order,) if isinstance(order, str) else tuple(order)
        self.stride = tuple(stride)
        self.enc_patch_size = tuple(enc_patch_size)
        self.serialization_depth = serialization_depth
        self.num_stages = len(enc_depths)
        self.enc_channels = tuple(enc_channels)
        self.cls_mode = cls_mode
        # the width of the output: the decoder's, or the coarsest stage's
        self.out_channels = enc_channels[-1] if cls_mode else dec_channels[0]
        self.shuffle_orders = shuffle_orders
        self.stage_capacity = tuple(
            stage_capacity or (0.5 ** s for s in range(1, self.num_stages)))
        if len(self.stage_capacity) != self.num_stages - 1:
            raise ValueError("stage_capacity needs one fraction per pooling")

        def block(c, heads, patch, i, rate):
            return Block(c, heads, patch, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, proj_drop=proj_drop, drop_path=rate,
                         pre_norm=pre_norm, order_index=i % len(self.order),
                         use_kernel=use_kernel, enable_rpe=enable_rpe, pd=pd, dtype=dtype)

        # drop-path rates: one linspace over the encoder's blocks; the
        # decoder's per-stage slices of a second linspace, reversed
        enc_dp = torch.linspace(0, drop_path, sum(enc_depths), dtype=torch.float64).tolist()
        dec_dp = torch.linspace(0, drop_path, sum(dec_depths), dtype=torch.float64).tolist()

        self.embedding = Embedding(in_channels, enc_channels[0], pd=pd, dtype=dtype)
        # SSL: a learnable token that replaces the embedding's output at
        # masked points (Pointcept's [1, C] ``mask_token``)
        self.mask_token = (nn.Parameter(torch.empty(1, enc_channels[0]))
                           if enable_mask_token else None)
        self.enc = nn.ModuleDict()
        for s in range(self.num_stages):
            down = {}
            if s > 0:
                down["down"] = SerializedPooling(
                    enc_channels[s - 1], enc_channels[s], stride=stride[s - 1],
                    reduce=pool_reduce, pd=pd, dtype=dtype)
            first = sum(enc_depths[:s])
            blocks = [block(enc_channels[s], enc_num_head[s], enc_patch_size[s], i,
                            enc_dp[first + i]) for i in range(enc_depths[s])]
            self.enc[f"enc{s}"] = _Stage(blocks, **down)
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.ModuleDict()
        for s in reversed(range(0 if cls_mode else self.num_stages - 1)):
            up = SerializedUnpooling(dec_ch[s + 1], enc_channels[s], dec_ch[s], pd=pd,
                                     dtype=dtype)
            rates = dec_dp[sum(dec_depths[:s]):sum(dec_depths[:s + 1])][::-1]
            blocks = [block(dec_ch[s], dec_num_head[s], dec_patch_size[s], i, rates[i])
                      for i in range(dec_depths[s])]
            self.dec[f"dec{s}"] = _Stage(blocks, up=up)
        if remat_blocks and any(isinstance(m, MaskedBatchNorm) for stage in
                                (*self.enc.values(), *self.dec.values())
                                for blk in stage.blocks() for m in blk.modules()):
            raise ValueError("remat_blocks recomputes each block: a BatchNorm in a block "
                             "would update its statistics twice")
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Linear, SubMConv, RPE)):
                mod.reset_parameters(gen)
        if self.mask_token is not None:  # flax's truncated_normal(0.02): 2 std
            nn.init.trunc_normal_(self.mask_token.data, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)

    def _block(self, blk: Block, feat, state: StageState, cpe_feat, generator, cond=None):
        """``blk`` on ``feat``; with ``remat_blocks``, in a training forward
        that records gradients, under non-reentrant activation checkpointing
        (the JAX package's ``nn.remat(Block)``): the block keeps only its
        inputs and runs again in the backward. The recompute draws its
        dropout and drop-path masks from ``generator`` set back to the
        state it had at the block's entry, then leaves the generator where
        it was, so the forward, the masks and the draws after it are those
        of a run without ``remat_blocks``. A block holds no BatchNorm (its
        norms are LayerNorms, or PDNorms of LayerNorms), so a recompute
        updates no statistics. ``cond`` (the condition and the context
        tensor) reaches the recompute through the closure, so the context's
        gradient flows through the checkpoint."""
        if not (self.remat_blocks and self.training and torch.is_grad_enabled()):
            return blk(feat, state, cpe_feat=cpe_feat, generator=generator, cond=cond)
        entry = None if generator is None else generator.get_state()
        calls = [0]

        def run(feat, cpe_feat):
            calls[0] += 1
            if calls[0] == 1 or entry is None:
                return blk(feat, state, cpe_feat=cpe_feat, generator=generator, cond=cond)
            now = generator.get_state()
            generator.set_state(entry)
            try:
                return blk(feat, state, cpe_feat=cpe_feat, generator=generator, cond=cond)
            finally:
                generator.set_state(now)

        return checkpoint(run, feat, cpe_feat, use_reentrant=False)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None,
                token_mask: Optional[torch.Tensor] = None, return_enc: bool = False,
                condition=None, context: Optional[torch.Tensor] = None):
        """Returns the decoder output at the input points (with
        ``cls_mode``, the coarsest encoder stage's output); ``plans`` holds
        the pooling plans (their ``n_overflow`` counts clusters lost to the
        stage capacities). In training, ``generator`` (on the points'
        device) draws the curve shuffle and the dropout masks; a point that
        arrives serialized keeps its serialization.

        With ``enable_mask_token``, ``token_mask`` [B, N] bool puts the mask
        token in place of the embedding at its true points, before the first
        block (whose xCPE sees the masked features, as the reference's
        in-place assignment gives). ``return_enc`` returns (output, the
        coarsest encoder stage's features, its mask).

        With ``pdnorm_conditions``, ``condition`` names the batch's dataset
        (a name, or one name a row, all equal) and ``context`` [B,
        context_channels] feeds the adaptive PDNorms.

        Under context parallel (the layout has a seq axis) ``point`` holds
        the rank's block of each row's slots (``parallel/context.py:
        shard_point_batch``) and arrives unserialized; the output and
        ``token_mask`` are of that block, the serialization and the plans
        of whole rows."""
        cond = None if self.pdnorm_conditions is None else (condition, context)
        depth = self.serialization_depth
        cp = layout().seq > 1
        feat_in = point.feat
        if cp:
            if point.ser is not None:
                raise ValueError("under context parallel the backbone serializes the "
                                 "gathered rows itself: pass the points unserialized")
            part = Part.of(point.num_points * layout().seq)
            point = point.replace(coord=part.whole_exact(point.coord),
                                  grid_coord=part.whole_exact(point.grid_coord),
                                  mask=part.whole_exact(point.mask))
            feat_in = part.whole(feat_in)
        if point.ser is None:
            shuffle = self.training and self.shuffle_orders and len(self.order) > 1
            if shuffle and generator is None:
                raise ValueError("a training forward with shuffle_orders needs a "
                                 "torch.Generator")
            point = point.serialized(self.order, depth=depth,
                                     generator=generator if shuffle else None)
        n0 = point.num_points
        stem_plan = build_subm_conv_plan(point.grid_coord, point.mask, 5, depth)
        state = stage_state(point.coord, point.grid_coord, point.mask, point.ser,
                            subplan(stem_plan, 3), cp)
        if cp:
            stem_plan = plan_rows(stem_plan, state.part.lo, state.part.hi)
        feat = self.embedding(feat_in.to(self.dtype), stem_plan, state.own(state.mask), cond)
        if token_mask is not None:
            if self.mask_token is None:
                raise ValueError("token_mask needs enable_mask_token=True")
            feat = torch.where(token_mask[..., None], self.mask_token.to(feat.dtype), feat)

        skips, plans = [], []
        for s in range(self.num_stages):
            stage = self.enc[f"enc{s}"]
            if s > 0:
                cap = _round_capacity(n0, self.stage_capacity[s - 1],
                                      self.enc_patch_size[s])
                x, coord, grid_coord, mask, ser, plan = stage.down(feat, state, cap, cond)
                skips.append((feat, state, plan))
                plans.append(plan)
                feat = x
                state = stage_state(coord, grid_coord, mask, ser,
                                    build_subm_conv_plan(grid_coord, mask, 3, depth), cp)
            for blk in stage.blocks():
                feat = self._block(blk, feat, state, None, generator, cond)
        enc_feat, enc_mask = feat, state.own(state.mask)

        for s in reversed(range(0 if self.cls_mode else self.num_stages - 1)):
            parent_feat, parent_state, plan = skips.pop()
            stage = self.dec[f"dec{s}"]
            feat, skip_feat = stage.up(feat, parent_feat, state, parent_state, plan, cond)
            state = parent_state
            for i, blk in enumerate(stage.blocks()):
                feat = self._block(blk, feat, state, skip_feat if i == 0 else None, generator,
                                   cond)

        out = point.replace(feat=feat, coord=state.own(state.coord),
                            grid_coord=state.own(state.grid_coord), mask=state.own(state.mask),
                            ser=state.ser, plans=tuple(plans))
        return (out, enc_feat, enc_mask) if return_enc else out
