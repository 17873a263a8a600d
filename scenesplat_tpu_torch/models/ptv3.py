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
    subm_conv_apply,
    subplan,
)
from scenesplat_tpu_torch.ops.window_attention import window_attention
from scenesplat_tpu_torch.parallel.dist import batch_rand

from .builder import MODELS
from .norm import LayerNorm, MaskedBatchNorm
from .structure import PointBatch


def as_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator],
            per_point: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - p and scale kept
    values by 1 / (1 - p). ``per_point`` draws one value per point and
    broadcasts it over channels (drop-path, flax ``broadcast_dims=(2,)``).
    Under data parallel the masks are this process's rows of one draw at
    the global batch's shape (``parallel/dist.py:batch_rand``)."""
    if p <= 0.0:
        return x
    if generator is None:
        raise ValueError("a training forward with dropout or drop-path needs a "
                         "torch.Generator")
    if p >= 1.0:
        return torch.zeros_like(x)
    shape = x.shape[:-1] + (1,) if per_point else x.shape
    keep = batch_rand(shape, generator, x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                          device=x.device))


@dataclass(frozen=True)
class StageState:
    """Per-stage geometry shared by all blocks of the stage."""

    coord: torch.Tensor
    grid_coord: torch.Tensor
    mask: torch.Tensor
    ser: Serialization
    conv_plan: SubMConvPlan


class Linear(nn.Module):
    """Dense layer: fp32 parameters cast to the compute dtype per call."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, gen: torch.Generator):
        bound = 1.0 / math.sqrt(self.weight.shape[1])
        self.weight.data.uniform_(-bound, bound, generator=gen)
        if self.bias is not None:
            self.bias.data.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


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
    def __init__(self, channels: int, mlp_ratio: float = 4.0, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(channels * mlp_ratio)
        self.drop = drop
        self.fc1 = Linear(channels, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, channels, dtype=dtype)

    def forward(self, x, generator=None):
        p = self.drop if self.training else 0.0
        x = dropout(F.gelu(self.fc1(x)), p, generator)
        return dropout(self.fc2(x), p, generator)


class SerializedAttention(nn.Module):
    """Window attention over one curve order."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 order_index: int = 0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 use_kernel: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.num_heads, self.patch_size = channels, num_heads, patch_size
        self.order_index, self.use_kernel = order_index, use_kernel
        self.proj_drop = proj_drop
        self.scale = qk_scale or (channels // num_heads) ** -0.5
        self.qkv = Linear(channels, 3 * channels, bias=qkv_bias, dtype=dtype)
        self.proj = Linear(channels, channels, dtype=dtype)

    def forward(self, feat, state: StageState, generator=None):
        c = self.channels
        order = state.ser.curve_order(self.order_index)
        inverse = state.ser.curve_inverse(self.order_index)
        qkv = self.qkv(feat)
        b, n = qkv.shape[:2]
        qkv_sorted = take_along_points(qkv, order).view(b, n, 3, c)
        valid_sorted = take_along_points(state.mask, order)
        out_sorted = window_attention(
            qkv_sorted, valid_sorted, self.patch_size, self.num_heads,
            scale=self.scale, use_kernel=self.use_kernel)
        out = self.proj(take_along_points(out_sorted, inverse))
        return dropout(out, self.proj_drop if self.training else 0.0, generator)


class Block(nn.Module):
    """xCPE + pre-norm attention + pre-norm MLP; in training, drop-path on
    the attention and the MLP branch (independent draws)."""

    def __init__(self, channels: int, num_heads: int, patch_size: int,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, proj_drop: float = 0.0,
                 drop_path: float = 0.0, pre_norm: bool = True,
                 order_index: int = 0, use_kernel: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.pre_norm = pre_norm
        self.drop_path = drop_path
        self.cpe = nn.ModuleList([
            SubMConv(c, c, kernel_size=3, dtype=dtype),
            Linear(c, c, dtype=dtype),
            LayerNorm(c, dtype=dtype),
        ])
        self.norm1 = nn.ModuleList([LayerNorm(c, dtype=dtype)])
        self.attn = SerializedAttention(
            c, num_heads, patch_size, order_index=order_index, qkv_bias=qkv_bias,
            qk_scale=qk_scale, proj_drop=proj_drop, use_kernel=use_kernel, dtype=dtype)
        self.norm2 = nn.ModuleList([LayerNorm(c, dtype=dtype)])
        self.mlp = nn.ModuleList([MLP(c, mlp_ratio, drop=proj_drop, dtype=dtype)])

    def forward(self, feat, state: StageState, cpe_feat=None, generator=None):
        # cpe_feat: the first block after unpooling convolves the proj_skip
        # features (see SerializedUnpooling)
        conv, linear, norm = self.cpe
        x = conv(feat if cpe_feat is None else cpe_feat, state.conv_plan)
        feat = feat + norm(linear(x))

        dp = self.drop_path if self.training else 0.0
        shortcut = feat
        if self.pre_norm:
            feat = self.norm1[0](feat)
        feat = shortcut + dropout(self.attn(feat, state, generator), dp, generator,
                                  per_point=True)
        if not self.pre_norm:
            feat = self.norm1[0](feat)

        shortcut = feat
        if self.pre_norm:
            feat = self.norm2[0](feat)
        feat = shortcut + dropout(self.mlp[0](feat, generator), dp, generator,
                                  per_point=True)
        if not self.pre_norm:
            feat = self.norm2[0](feat)
        return feat


class SerializedPooling(nn.Module):
    """Grid pooling by right-shifted curve-0 codes."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 reduce: str = "mean", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.pooling_depth = (math.ceil(stride) - 1).bit_length()
        self.reduce = reduce
        self.proj = Linear(in_channels, out_channels, dtype=dtype)
        self.norm = nn.ModuleList([MaskedBatchNorm(out_channels, dtype=dtype)])

    def forward(self, feat, state: StageState, out_capacity: int):
        depth = self.pooling_depth
        plan = build_pooling_plan(state.ser, state.mask, out_capacity, depth)
        x = pool_values(plan, self.proj(feat), self.reduce)
        coord = pool_values(plan, state.coord, "mean")
        grid_coord = take_along_points(state.grid_coord, plan.head_index) >> depth
        ser = pool_serialization(plan, state.ser, depth)
        x = F.gelu(self.norm[0](x, plan.out_mask))
        return x, coord, grid_coord, plan.out_mask, ser, plan


class SerializedUnpooling(nn.Module):
    """Broadcast pooled features back to the parent points, plus a skip.

    Returns (unpooled_feat, skip_feat). The reference assigns the summed
    feature without re-syncing its sparse-conv feature, so the first
    decoder block's xCPE conv reads the proj_skip output, not the sum."""

    def __init__(self, in_channels: int, skip_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = nn.ModuleList([Linear(in_channels, out_channels, dtype=dtype),
                                   MaskedBatchNorm(out_channels, dtype=dtype)])
        self.proj_skip = nn.ModuleList([
            Linear(skip_channels, out_channels, dtype=dtype),
            MaskedBatchNorm(out_channels, dtype=dtype)])

    def forward(self, feat, parent_feat, parent_mask, mask, plan: PoolingPlan):
        x = F.gelu(self.proj[1](self.proj[0](feat), mask))
        skip = F.gelu(self.proj_skip[1](self.proj_skip[0](parent_feat), parent_mask))
        return skip + unpool_values(x, plan.cluster_of_point), skip


class Embedding(nn.Module):
    """Stem: submanifold conv k=5 + BN + GELU."""

    def __init__(self, in_channels: int, embed_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem = nn.ModuleDict(dict(
            conv=SubMConv(in_channels, embed_channels, kernel_size=5, bias=False,
                          dtype=dtype),
            norm=MaskedBatchNorm(embed_channels, dtype=dtype),
        ))

    def forward(self, feat, plan: SubMConvPlan, mask):
        return F.gelu(self.stem["norm"](self.stem["conv"](feat, plan), mask))


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
    (``_block``). Parameters are drawn from ``seed``."""

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
        dtype="float32",
        seed: int = 0,
    ):
        super().__init__()
        dtype = as_dtype(dtype)
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        self.order = (order,) if isinstance(order, str) else tuple(order)
        self.stride = tuple(stride)
        self.enc_patch_size = tuple(enc_patch_size)
        self.serialization_depth = serialization_depth
        self.num_stages = len(enc_depths)
        self.enc_channels = tuple(enc_channels)
        self.out_channels = dec_channels[0]  # the decoder output's width
        self.shuffle_orders = shuffle_orders
        self.stage_capacity = tuple(
            stage_capacity or (0.5 ** s for s in range(1, self.num_stages)))
        if len(self.stage_capacity) != self.num_stages - 1:
            raise ValueError("stage_capacity needs one fraction per pooling")

        def block(c, heads, patch, i, rate):
            return Block(c, heads, patch, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                         qk_scale=qk_scale, proj_drop=proj_drop, drop_path=rate,
                         pre_norm=pre_norm, order_index=i % len(self.order),
                         use_kernel=use_kernel, dtype=dtype)

        # drop-path rates: one linspace over the encoder's blocks; the
        # decoder's per-stage slices of a second linspace, reversed
        enc_dp = torch.linspace(0, drop_path, sum(enc_depths), dtype=torch.float64).tolist()
        dec_dp = torch.linspace(0, drop_path, sum(dec_depths), dtype=torch.float64).tolist()

        self.embedding = Embedding(in_channels, enc_channels[0], dtype=dtype)
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
                    reduce=pool_reduce, dtype=dtype)
            first = sum(enc_depths[:s])
            blocks = [block(enc_channels[s], enc_num_head[s], enc_patch_size[s], i,
                            enc_dp[first + i]) for i in range(enc_depths[s])]
            self.enc[f"enc{s}"] = _Stage(blocks, **down)
        dec_ch = list(dec_channels) + [enc_channels[-1]]
        self.dec = nn.ModuleDict()
        for s in reversed(range(self.num_stages - 1)):
            up = SerializedUnpooling(dec_ch[s + 1], enc_channels[s], dec_ch[s],
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
            if isinstance(mod, (Linear, SubMConv)):
                mod.reset_parameters(gen)
        if self.mask_token is not None:  # flax's truncated_normal(0.02): 2 std
            nn.init.trunc_normal_(self.mask_token.data, std=0.02, a=-0.04, b=0.04,
                                  generator=gen)

    def _block(self, blk: Block, feat, state: StageState, cpe_feat, generator):
        """``blk`` on ``feat``; with ``remat_blocks``, in a training forward
        that records gradients, under non-reentrant activation checkpointing
        (the JAX package's ``nn.remat(Block)``): the block keeps only its
        inputs and runs again in the backward. The recompute draws its
        dropout and drop-path masks from ``generator`` set back to the
        state it had at the block's entry, then leaves the generator where
        it was, so the forward, the masks and the draws after it are those
        of a run without ``remat_blocks``. A block holds no BatchNorm (its
        norms are LayerNorms), so a recompute updates no statistics."""
        if not (self.remat_blocks and self.training and torch.is_grad_enabled()):
            return blk(feat, state, cpe_feat=cpe_feat, generator=generator)
        entry = None if generator is None else generator.get_state()
        calls = [0]

        def run(feat, cpe_feat):
            calls[0] += 1
            if calls[0] == 1 or entry is None:
                return blk(feat, state, cpe_feat=cpe_feat, generator=generator)
            now = generator.get_state()
            generator.set_state(entry)
            try:
                return blk(feat, state, cpe_feat=cpe_feat, generator=generator)
            finally:
                generator.set_state(now)

        return checkpoint(run, feat, cpe_feat, use_reentrant=False)

    def forward(self, point: PointBatch, generator: Optional[torch.Generator] = None,
                token_mask: Optional[torch.Tensor] = None, return_enc: bool = False):
        """Returns the decoder output at the input points; ``plans`` holds
        the pooling plans (their ``n_overflow`` counts clusters lost to the
        stage capacities). In training, ``generator`` (on the points'
        device) draws the curve shuffle and the dropout masks; a point that
        arrives serialized keeps its serialization.

        With ``enable_mask_token``, ``token_mask`` [B, N] bool puts the mask
        token in place of the embedding at its true points, before the first
        block (whose xCPE sees the masked features, as the reference's
        in-place assignment gives). ``return_enc`` returns (output, the
        coarsest encoder stage's features, its mask)."""
        depth = self.serialization_depth
        if point.ser is None:
            shuffle = self.training and self.shuffle_orders and len(self.order) > 1
            if shuffle and generator is None:
                raise ValueError("a training forward with shuffle_orders needs a "
                                 "torch.Generator")
            point = point.serialized(self.order, depth=depth,
                                     generator=generator if shuffle else None)
        n0 = point.num_points
        stem_plan = build_subm_conv_plan(point.grid_coord, point.mask, 5, depth)
        state = StageState(point.coord, point.grid_coord, point.mask, point.ser,
                           subplan(stem_plan, 3))
        feat = self.embedding(point.feat.to(self.dtype), stem_plan, state.mask)
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
                x, coord, grid_coord, mask, ser, plan = stage.down(feat, state, cap)
                skips.append((feat, state, plan))
                plans.append(plan)
                feat = x
                state = StageState(coord, grid_coord, mask, ser,
                                   build_subm_conv_plan(grid_coord, mask, 3, depth))
            for blk in stage.blocks():
                feat = self._block(blk, feat, state, None, generator)
        enc_feat, enc_mask = feat, state.mask

        for s in reversed(range(self.num_stages - 1)):
            parent_feat, parent_state, plan = skips.pop()
            stage = self.dec[f"dec{s}"]
            feat, skip_feat = stage.up(feat, parent_feat, parent_state.mask,
                                       state.mask, plan)
            state = parent_state
            for i, blk in enumerate(stage.blocks()):
                feat = self._block(blk, feat, state, skip_feat if i == 0 else None, generator)

        out = point.replace(feat=feat, coord=state.coord, grid_coord=state.grid_coord,
                            mask=state.mask, ser=state.ser, plans=tuple(plans))
        return (out, enc_feat, enc_mask) if return_enc else out
