"""SimDINO self-supervised pretraining components (counterpart of
``scenesplat_tpu/models/ssl.py``).

  - ``DINOHead``: fp32 linears with exact GELU between them, L2-normalized
    output (eps 1e-4); a bf16 input is promoted to fp32, as flax promotes
    it against fp32 parameters.
  - ``mcr_loss``: the coding-rate expansion (a Cholesky log-determinant of
    each teacher view's ``I + p / (m eps) cov``) plus cosine compression
    between student and teacher crops, the teacher side detached; its
    row sums (similarities, covariances, m) span the global batch under
    data parallel (``parallel/dist.py:all_reduce_sum``).
  - ``cosine_patch_loss``: the masked iBOT-style cosine loss, summed over
    the global batch.
  - ``generate_token_masks``: per-point Bernoulli ("splats") or voxel-patch
    ("patch") token masks with per-point weights, split into the random
    draws (``draw_token_mask_randoms``) and the function of them
    (``token_masks_from_draws``), so the draws can come from elsewhere.
  - ``SimDINOSSL``: the student backbone (PT-v3m1 with its mask token), the
    DINO, iBOT and optional MAE heads, and the teacher: a copy of the
    backbone that takes no gradient and follows the student by EMA
    (``engines/pretrain.py``).

State-dict names: ``backbone.*`` (Pointcept's PTv3 names, ``mask_token``
[1, C] among them), ``teacher.*`` (the same names), ``dino_head.fc{1,2,3}``,
``ibot_head.fc{1,2,3}``, ``mae_fc1``, ``mae_norm``, ``mae_fc2`` (the JAX
package's module names; the reference's heads have no counterpart in its
checkpoints that the JAX package bridges).
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.parallel.dist import all_reduce_sum, batch_rand, batch_randint, world

from .builder import MODELS, build_model
from .norm import LayerNorm
from .ptv3 import Linear


def _l2n(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


def _trunc_normal_linear(layer: Linear, gen: torch.Generator) -> None:
    """flax's truncated_normal(0.02) kernel (cut at 2 std), zero bias."""
    nn.init.trunc_normal_(layer.weight.data, std=0.02, a=-0.04, b=0.04, generator=gen)
    layer.bias.data.zero_()


class DINOHead(nn.Module):
    """``nlayers`` fp32 linears, in_dim -> hidden -> ... -> bottleneck, exact
    GELU between them, L2-normalized output."""

    def __init__(self, in_dim: int, out_dim: int = 256, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3):
        super().__init__()
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        self.nlayers = nlayers
        for i in range(nlayers):
            self.add_module(f"fc{i + 1}", Linear(dims[i], dims[i + 1], dtype=torch.float32))

    def reset_parameters(self, gen: torch.Generator) -> None:
        for i in range(self.nlayers):
            _trunc_normal_linear(getattr(self, f"fc{i + 1}"), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for i in range(self.nlayers):
            x = getattr(self, f"fc{i + 1}")(x)
            if i < self.nlayers - 1:
                x = F.gelu(x)
        return _l2n(x)


def half_logdet(x: torch.Tensor) -> torch.Tensor:
    """Half the log-determinant of SPD ``x`` [..., p, p] from its Cholesky
    factor (``cholesky_ex``: no host sync on the error check)."""
    chol = torch.linalg.cholesky_ex(x).L
    return chol.diagonal(dim1=-2, dim2=-1).clamp(min=1e-12).log().sum(-1)


def mcr_loss(student_feats: Sequence[torch.Tensor], teacher_feats: Sequence[torch.Tensor],
             eps: float = 0.05, coeff: float = 0.1, expa_type: int = 1,
             no_diag: bool = True):
    """student_feats: crops x [M, D] (L2-normalized); teacher: 2 x [M, D].
    Returns (loss, {"mcr_comp_loss", "mcr_expa_loss"})."""
    s = torch.stack(list(student_feats)).float()  # [S, M, D]
    t = torch.stack(list(teacher_feats)).float().detach()  # [T, M, D]
    n_s, n_t = s.shape[0], t.shape[0]

    expa_feat = (s[:n_t] + t) / 2 if expa_type == 1 else s[:n_t]
    p = expa_feat.shape[2]
    # sums over the rows of the global batch (every process holds as many):
    # the similarities and the covariances in one reduction
    m = s.shape[1] * world()
    sums = all_reduce_sum(torch.cat([
        torch.einsum("tmd,smd->ts", t, s).reshape(-1),
        torch.einsum("nbc,nbd->ncd", expa_feat, expa_feat).reshape(-1)]))
    sim = sums[:n_t * n_s].reshape(n_t, n_s) / m
    cov = sums[n_t * n_s:].reshape(n_t, p, p)
    if no_diag:
        eye = torch.eye(n_t, n_s, dtype=torch.bool, device=sim.device)
        sim = torch.where(eye, torch.zeros((), device=sim.device), sim)
    comp_loss = sim.sum() / (n_t * n_s - min(n_t, n_s))

    eye = torch.eye(p, device=cov.device)
    expa = half_logdet(eye + (p / (m * eps)) * cov).sum() / n_t
    expa = expa * (p + m) / (p * m)

    loss = -coeff * comp_loss - expa
    return loss, {"mcr_comp_loss": comp_loss, "mcr_expa_loss": expa}


def cosine_patch_loss(student_tokens: torch.Tensor, teacher_tokens: torch.Tensor,
                      weights: torch.Tensor, view_nums: int = 1) -> torch.Tensor:
    """[M, D] head outputs (L2-normalized); weights zero for unmasked slots."""
    cos = (teacher_tokens.detach().float() * student_tokens.float()).sum(-1)
    return -all_reduce_sum((cos * weights).sum()) / view_nums


# the patch hash's primes (int32 products that wrap, as the JAX function's)
_PRIMES = (73856093, 19349663, 83492791)


def _patch_hash(pc: torch.Tensor) -> torch.Tensor:
    """XOR of the int32 products of ``pc`` [..., 3] with the primes, as
    int64 holding the 32-bit pattern of the wrapped int32 result (the low
    32 bits of a product do not depend on the wider type)."""
    pc = pc.long()
    h = (pc[..., 0] * _PRIMES[0]) ^ (pc[..., 1] * _PRIMES[1]) ^ (pc[..., 2] * _PRIMES[2])
    return h & 0xFFFFFFFF


def draw_token_mask_randoms(generator: Optional[torch.Generator], shape: Tuple[int, int],
                            mask_type: str = "patch",
                            mask_ratio_min_max: Tuple[float, float] = (0.1, 0.5),
                            mask_sample_probability: float = 0.5, device=None):
    """The random draws of ``generate_token_masks`` for a [B, N] batch:
    (sample_on [B, 1] bool, rate [B, 1] f32, unit), where unit is a [B, N]
    uniform for "splats" and a [B, 1] int32 seed in [0, 2^30) for
    "patch". Under data parallel each is this process's rows of the draw at
    the global batch's shape (``parallel/dist.py:batch_rand``)."""
    b, n = shape
    sample_on = batch_rand((b, 1), generator, device) < mask_sample_probability
    lo, hi = mask_ratio_min_max
    rate = lo + (hi - lo) * batch_rand((b, 1), generator, device)
    if mask_type == "splats":
        unit = batch_rand((b, n), generator, device, points=True)
    elif mask_type == "patch":
        unit = batch_randint(0, 2 ** 30, (b, 1), generator, device, dtype=torch.int32)
    else:
        raise ValueError(f"unknown mask_type {mask_type!r}")
    return sample_on, rate, unit


def token_masks_from_draws(coord: torch.Tensor, mask: torch.Tensor, sample_on: torch.Tensor,
                           rate: torch.Tensor, unit: torch.Tensor,
                           mask_type: str = "patch", mask_grid_size: float = 0.2):
    """(token_mask [B, N] bool, weight [B, N] f32) from the draws. A sample
    with ``sample_on`` hides a ``rate`` share of its points ("splats") or
    of its ``mask_grid_size`` voxel patches ("patch"); each masked point
    weighs 1 / the sample's masked units (patches estimated from the
    occupied hash bins)."""
    if mask_type == "splats":
        token_mask = (unit < rate) & mask & sample_on
        n_masked = token_mask.sum(-1, keepdim=True).clamp(min=1)
        return token_mask, token_mask / n_masked
    if mask_type != "patch":
        raise ValueError(f"unknown mask_type {mask_type!r}")
    pc = torch.floor(coord / mask_grid_size).to(torch.int32)
    pc = pc - pc.amin(dim=1, keepdim=True)  # over every slot, padding included
    h = _patch_hash(pc) ^ (unit.long() & 0xFFFFFFFF)
    u = (h & 0xFFFFF).float() / float(1 << 20)  # uint32 % 2^20
    token_mask = (u < rate) & mask & sample_on
    n_masked = token_mask.sum(-1, keepdim=True).clamp(min=1)
    total_valid = mask.sum(-1, keepdim=True).clamp(min=1)
    est_patches = (n_masked * _estimate_patch_count(pc, mask) / total_valid).clamp(min=1.0)
    return token_mask, token_mask / est_patches


_PATCH_BINS = 1024


def _estimate_patch_count(pc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Occupied hash bins of each row's valid points, [B, 1] f32, at least 1
    (the JAX function's one-hot sum, counted by a scatter)."""
    hb = torch.where(mask, _patch_hash(pc) % _PATCH_BINS, _PATCH_BINS)
    occupied = torch.zeros(mask.shape[0], _PATCH_BINS + 1, dtype=torch.bool, device=mask.device)
    occupied.scatter_(1, hb, True)
    return occupied[:, :_PATCH_BINS].sum(-1, keepdim=True).float().clamp(min=1.0)


def generate_token_masks(generator: Optional[torch.Generator], coord: torch.Tensor,
                         mask: torch.Tensor, mask_type: str = "patch",
                         mask_grid_size: float = 0.2,
                         mask_ratio_min_max: Tuple[float, float] = (0.1, 0.5),
                         mask_sample_probability: float = 0.5):
    """Per-point token masks and weights, fixed shapes: the draws from
    ``generator`` (on the points' device), then the masks from them."""
    draws = draw_token_mask_randoms(generator, tuple(mask.shape), mask_type,
                                    mask_ratio_min_max, mask_sample_probability,
                                    device=mask.device)
    return token_masks_from_draws(coord, mask, *draws, mask_type=mask_type,
                                  mask_grid_size=mask_grid_size)


@MODELS.register_module("SimDINOSSL")
@MODELS.register_module("DefaultContrastiverSimDinoV2")
class SimDINOSSL(nn.Module):
    """Student backbone + DINO / iBOT / MAE heads + the EMA teacher.

    The DINO head reads the pooled coarsest encoder stage
    (``enc_channels[-1]`` wide), the iBOT and MAE heads the decoder output
    (``dec_channels[0]``); all compute in fp32. The heads are drawn from the
    backbone's ``seed`` + 1; the teacher starts as an exact copy of the
    backbone (mask token included), takes no gradient and runs in the
    model's mode."""

    def __init__(self, backbone: dict, dino_out_dim: int = 256, dino_hidden_dim: int = 2048,
                 ibot_out_dim: int = 32, ibot_hidden_dim: int = 256,
                 enable_mae: bool = False, mae_out_dim: int = 11):
        super().__init__()
        bcfg = dict(backbone, enable_mask_token=True)
        self.backbone = build_model(bcfg)
        self.teacher = copy.deepcopy(self.backbone).requires_grad_(False)
        enc_c, dec_c = self.backbone.enc_channels[-1], self.backbone.out_channels
        self.dino_head = DINOHead(enc_c, dino_out_dim, dino_hidden_dim, dino_out_dim)
        self.ibot_head = DINOHead(dec_c, ibot_out_dim, ibot_hidden_dim, ibot_out_dim)
        self.enable_mae = enable_mae
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        self.dino_head.reset_parameters(gen)
        self.ibot_head.reset_parameters(gen)
        if enable_mae:
            self.mae_fc1 = Linear(dec_c, 32, dtype=torch.float32)
            self.mae_norm = LayerNorm(32, eps=1e-5, dtype=torch.float32)
            self.mae_fc2 = Linear(32, mae_out_dim, dtype=torch.float32)
            self.mae_fc1.reset_parameters(gen)
            self.mae_fc2.reset_parameters(gen)

    def mae_head(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.mae_fc2(F.relu(self.mae_norm(self.mae_fc1(tokens.float()))))
