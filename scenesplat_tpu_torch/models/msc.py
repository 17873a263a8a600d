"""Masked Scene Contrast (counterpart of ``scenesplat_tpu/models/msc.py``):
MSC-v1m1 and its CSC-partitioned MSC-v1m2, Pointcept's SpUNet pretraining
(reference masked_scene_contrast_v1m1_base.py, _v1m2_csc.py), on padded
two-view batches.

  - cross masks: the grid clusters of each scene's union of both views'
    origin coordinates (``ops/pointops.py:grid_cluster_plan``), each patch
    tagged 1 (masked in view 1) or 2 (view 2) with probability
    ``mask_rate`` each, drawn i.i.d. (the JAX package's fixed-shape form of
    the reference's permutation: the same rate in expectation);
  - matching: one random partner of each view-1 point among its
    ``matching_max_k`` nearest view-2 points closer than
    ``matching_max_radius`` (``knn`` with that radius), and ``matching_max_pair``
    rows of the batch chosen by random priority, a fixed buffer whose
    surplus slots are masked;
  - the masked InfoNCE over the [P, P] similarity, with its ``pos_sim`` /
    ``neg_sim`` monitors, the colour L2 head and the normal head on the
    masked points; the normal term keeps the reference's sign (it adds the
    dot products, ``reconstruct_normal_sign`` 1);
  - view mixing (``view1_mix_prob``, ``view2_mix_prob``): with that
    probability a step merges each pair of a view's rows into one row for
    the backbone, as the reference merges offsets; matching and the losses
    stay per original scene. The JAX package refuses both keys and mixes
    nothing (ROADMAP Queue 3).

The replay keys of the JAX module (``view{1,2}_point_mask``,
``match_{scene,i1,i2,valid}``) bypass the draws. Every draw comes from the
caller's ``generator``. Under data parallel the draws are made at the
global batch's shape (``batch_rand``), the rows' validity and partners are
gathered so that every process picks the same global pairs, and the pair
features are summed over the processes, so the InfoNCE spans the global
batch as the JAX step does under pjit (the reference computes it per GPU).

Parameter names are the reference's: ``mask_token`` [1, Cin],
``color_head``, ``normal_head`` and the backbone under ``backbone.``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from scenesplat_tpu_torch.ops.pointops import grid_cluster_plan, knn
from scenesplat_tpu_torch.ops.segops import unpool_values
from scenesplat_tpu_torch.parallel.dist import (
    all_gather_rows,
    all_reduce_sum,
    batch_rand,
    rank,
    world,
)

from .builder import MODELS, build_model
from .ptv3 import Linear
from .structure import PointBatch


def _merge_pairs(x: torch.Tensor) -> torch.Tensor:
    """[B, N, ...] -> [ceil(B / 2), 2 N, ...]: rows 2i and 2i + 1 side by
    side (an odd last row beside an empty one)."""
    if x.shape[0] % 2:
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return x.reshape((x.shape[0] // 2, 2 * x.shape[1]) + x.shape[2:])


def _split_pairs(x: torch.Tensor, b: int) -> torch.Tensor:
    """The inverse of ``_merge_pairs`` for ``b`` rows."""
    return x.reshape((-1, x.shape[1] // 2) + x.shape[2:])[:b]


def _pair_rows(x: torch.Tensor, scene: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``x[scene, idx]`` [P, ...] of the global batch from this
    process's block x [B_local, N, ...]: each process fills the pairs of
    its rows and the sum over the processes holds all."""
    b, n = x.shape[:2]
    flat = x.reshape((b * n,) + x.shape[2:])
    if world() == 1:
        return flat[scene * n + idx]
    local = scene - rank() * b
    mine = (local >= 0) & (local < b)
    rows = flat[local.clamp(0, b - 1) * n + idx]
    mine = mine.reshape((-1,) + (1,) * (rows.ndim - 1))
    return all_reduce_sum(torch.where(mine, rows, torch.zeros_like(rows)))


def _l2n(x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x / (x.norm(dim=-1, keepdim=True) + eps)


@MODELS.register_module("MSC-v1m1")
class MaskedSceneContrast(nn.Module):
    def __init__(self, backbone: dict, backbone_in_channels: int, backbone_out_channels: int,
                 mask_grid_size: float = 0.1, mask_rate: float = 0.4,
                 view1_mix_prob: float = 0.0, view2_mix_prob: float = 0.0,
                 matching_max_k: int = 8, matching_max_radius: float = 0.03,
                 matching_max_pair: int = 8192, nce_t: float = 0.4,
                 contrast_weight: float = 1.0, reconstruct_weight: float = 1.0,
                 reconstruct_color: bool = True, reconstruct_normal: bool = True,
                 reconstruct_normal_sign: float = 1.0):
        super().__init__()
        self.backbone = build_model(dict(backbone))
        self.mask_grid_size, self.mask_rate = mask_grid_size, mask_rate
        self.mix_prob = (view1_mix_prob, view2_mix_prob)
        self.matching_max_k, self.matching_max_radius = matching_max_k, matching_max_radius
        self.matching_max_pair, self.nce_t = matching_max_pair, nce_t
        self.contrast_weight, self.reconstruct_weight = contrast_weight, reconstruct_weight
        self.reconstruct_normal_sign = reconstruct_normal_sign
        gen = torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)
        self.mask_token = nn.Parameter(torch.empty(1, backbone_in_channels))
        nn.init.trunc_normal_(self.mask_token, std=0.02, a=-0.04, b=0.04, generator=gen)
        self.color_head = self.normal_head = None
        if reconstruct_color:
            self.color_head = Linear(backbone_out_channels, 3, dtype=torch.float32)
            self.color_head.reset_parameters(gen)
        if reconstruct_normal:
            self.normal_head = Linear(backbone_out_channels, 3, dtype=torch.float32)
            self.normal_head.reset_parameters(gen)

    def generate_cross_masks(self, oc1, m1, oc2, m2, generator):
        """Patch tags 0/1/2 of the grid clusters of each scene's union of
        both views; view 1 masks its tag-1 points, view 2 its tag-2."""
        plan = grid_cluster_plan(torch.cat([oc1, oc2], 1), torch.cat([m1, m2], 1),
                                 self.mask_grid_size, oc1.shape[1] + oc2.shape[1])
        r = batch_rand(plan.out_mask.shape, generator, device=oc1.device)
        tag = torch.where(r < self.mask_rate, 1, torch.where(r < 2 * self.mask_rate, 2, 0))
        tag_point = unpool_values(tag[..., None], plan.cluster_of_point)[..., 0]
        n1 = oc1.shape[1]
        return (tag_point[:, :n1] == 1) & m1, (tag_point[:, n1:] == 2) & m2

    def match_contrastive_pair(self, oc1, m1, oc2, m2, generator):
        """(scene, i1, i2, valid) [P] of ``matching_max_pair`` pairs of the
        global batch: one random in-radius view-2 partner a view-1 point,
        rows picked by random priority among those with one."""
        b, n1 = m1.shape
        idx, dist = knn(oc2, m2, self.matching_max_k, query=oc1, query_mask=m1,
                        radius=self.matching_max_radius)
        valid = (idx >= 0) & (dist < self.matching_max_radius)
        prio = batch_rand(valid.shape, generator, device=oc1.device) * valid
        partner = idx.gather(-1, prio.argmax(-1, keepdim=True))[..., 0]
        rows_local = torch.stack([valid.any(-1).double(), partner.double()], -1)
        rows_all = all_gather_rows(rows_local)  # [B_global, n1, 2]
        flat_valid = rows_all[..., 0].reshape(-1) > 0
        scores = torch.rand(flat_valid.shape, generator=generator, device=oc1.device)
        scores = torch.where(flat_valid, scores, -1.0)
        top, rows = torch.topk(scores, min(self.matching_max_pair, flat_valid.numel()))
        i2 = rows_all[..., 1].reshape(-1)[rows].long().clamp(min=0)
        return rows // n1, rows % n1, i2, top >= 0.0

    def contrastive_loss(self, f1, f2, oc1, oc2, scene, i1, i2, pair_valid):
        """The masked InfoNCE (reference v1m1 l.174-204): (nce, pos_sim,
        neg_sim), the monitors detached."""
        g1 = _l2n(_pair_rows(f1, scene, i1), 1e-7)
        g2 = _l2n(_pair_rows(f2, scene, i2), 1e-7)
        sim = g1 @ g2.T  # [P, P]
        w = pair_valid.float()
        denom = w.sum().clamp(min=1.0)
        pos_sim = (sim.diagonal() * w).sum() / denom
        # reference l.191: the diagonal's share of the row means is removed
        neg_sim = (((sim * w[None, :]).sum(-1) * w).sum() / (w.sum() * w).sum().clamp(min=1.0)
                   - pos_sim / denom)
        logits = sim / self.nce_t + torch.where(pair_valid, 0.0, -1e9)[None, :]
        nce = -(F.log_softmax(logits, -1).diagonal() * w).sum() / denom
        return nce, pos_sim.detach(), neg_sim.detach()

    def _backbone_pass(self, view: str, batch, feat, mix: bool):
        """One backbone pass over a view's rows, the pairs of rows merged
        into one with ``mix``; returns (features [B, N, C], the largest
        pooling overflow, a 0-d tensor)."""
        coord, grid, mask = (batch[f"{view}_{k}"] for k in ("coord", "grid_coord", "mask"))
        if mix:
            coord, feat, grid, mask = map(_merge_pairs, (coord, feat, grid, mask))
        out = self.backbone(PointBatch(coord=coord, feat=feat, grid_coord=grid, mask=mask))
        overflow = torch.stack([p.n_overflow.max() for p in out.plans]).max()
        f = _split_pairs(out.feat, batch[f"{view}_mask"].shape[0]) if mix else out.feat
        return f, overflow

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The loss and its terms (``loss``, ``nce_loss``, ``pos_sim``,
        ``neg_sim``, ``color_loss``, ``normal_loss``) of the two-view
        ``batch``, and monitors: ``pairs`` (valid pairs), the masked share
        of each view's points, whether each view was mixed and the largest
        pooling overflow of the passes."""
        oc1, oc2 = batch["view1_origin_coord"], batch["view2_origin_coord"]
        m1, m2 = batch["view1_mask"], batch["view2_mask"]
        dev = m1.device
        if "view1_point_mask" in batch:  # replay: injected masks
            pm1, pm2 = batch["view1_point_mask"] & m1, batch["view2_point_mask"] & m2
        else:
            pm1, pm2 = self.generate_cross_masks(oc1, m1, oc2, m2, generator)
        mixed = [p > 0 and bool(torch.rand((), generator=generator, device=dev) < p)
                 for p in self.mix_prob]

        feats, overflow = [], []
        for view, pm, mix in zip(("view1", "view2"), (pm1, pm2), mixed):
            f_in = batch[f"{view}_feat"]
            f_in = torch.where(pm[..., None], self.mask_token.to(f_in.dtype), f_in)
            f, o = self._backbone_pass(view, batch, f_in, mix)
            feats.append(f)
            overflow.append(o)
        f1, f2 = feats

        if "match_scene" in batch:  # replay: injected pairs
            scene, i1, i2, pair_valid = (batch[k] for k in (
                "match_scene", "match_i1", "match_i2", "match_valid"))
        else:
            scene, i1, i2, pair_valid = self.match_contrastive_pair(oc1, m1, oc2, m2, generator)
        nce, pos_sim, neg_sim = self._contrastive(f1, f2, oc1, oc2, scene, i1, i2, pair_valid)
        loss = nce * self.contrast_weight
        out = dict(nce_loss=nce, pos_sim=pos_sim, neg_sim=neg_sim)

        w1, w2 = pm1.float(), pm2.float()
        if self.color_head is not None:
            num = sum((((self.color_head(f) - batch[f"{v}_color"]) ** 2) * w[..., None]).sum()
                      for f, v, w in ((f1, "view1", w1), (f2, "view2", w2)))
            num, count = all_reduce_sum(torch.stack([num, w1.sum() + w2.sum()]))
            out["color_loss"] = num / count.clamp(min=1.0)
            loss = loss + out["color_loss"] * self.reconstruct_weight
        if self.normal_head is not None:
            dots = sum(((_l2n(self.normal_head(f), 1e-10) * batch[f"{v}_normal"]).sum(-1) * w).sum()
                       for f, v, w in ((f1, "view1", w1), (f2, "view2", w2)))
            dots, count = all_reduce_sum(torch.stack([dots, w1.sum() + w2.sum()]))
            out["normal_loss"] = self.reconstruct_normal_sign * dots / count.clamp(min=1.0)
            loss = loss + out["normal_loss"] * self.reconstruct_weight
        out["loss"] = loss
        with torch.no_grad():
            shares = all_reduce_sum(torch.stack([w1.sum(), m1.sum(), w2.sum(), m2.sum()]).float())
            out.update(pairs=pair_valid.sum().float(),
                       view1_mask_share=shares[0] / shares[1].clamp(min=1.0),
                       view2_mask_share=shares[2] / shares[3].clamp(min=1.0),
                       view1_mixed=torch.tensor(float(mixed[0]), device=dev),
                       view2_mixed=torch.tensor(float(mixed[1]), device=dev),
                       n_overflow=torch.stack(overflow).max().float())
        return out

    def _contrastive(self, f1, f2, oc1, oc2, scene, i1, i2, pair_valid):
        """v1m1's InfoNCE; MSC-v1m2 partitions it."""
        return self.contrastive_loss(f1, f2, oc1, oc2, scene, i1, i2, pair_valid)


@MODELS.register_module("MSC-v1m2")
class MaskedSceneContrastCSC(MaskedSceneContrast):
    """MSC-v1m2: the InfoNCE split by CSC's spatial partitions of the pairs
    (reference masked_scene_contrast_v1m2_csc.py:182-240). A pair (i, j)'s
    partition comes from the origin coordinates' displacement c1[j] -
    c2[i]: 0-3 for (r1 < d <= r2 | d > r2) x (dz > 0 | dz < 0), -1 (the
    reference's -1e7 initial value, which its ``unique`` surfaces as a
    fifth partition) for the rest, the diagonal included. Each scene's
    InfoNCE runs once a partition with the diagonal always in; the sum
    divides by ``partitions`` (4) and the scene count. The pos/neg monitors
    keep the reference's running formula (neg reads pos summed over the
    scenes so far, v1m2 l.236-238)."""

    def __init__(self, *args, partitions: int = 4, r1: float = 0.125, r2: float = 2.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.partitions, self.r1, self.r2 = partitions, r1, r2

    def _partitions(self, c1, c2):
        """[n, n] int8 partition ids of one scene's pairs: pair (i, j) from
        c1[j] - c2[i]."""
        rel = c1[None, :, :] - c2[:, None, :]
        dist = ((rel ** 2).sum(-1) + 1e-7).sqrt()
        up, down = rel[..., 2] > 0.0, rel[..., 2] < 0.0
        mid = (dist > self.r1) & (dist <= self.r2)
        far = dist > self.r2
        part = torch.full(dist.shape, -1, dtype=torch.int8, device=dist.device)
        for pid, sel in enumerate((mid & up, mid & down, far & up, far & down)):
            part[sel] = pid
        return part

    def _contrastive(self, f1, f2, oc1, oc2, scene, i1, i2, pair_valid):
        """Each scene's InfoNCE over its own valid pairs only: the JAX
        module's [P, P] form masks the other rows (weight 0) and columns
        (-1e9, whose exponentials vanish), so both give the same loss and
        gradients, here at a scene's [n, n] instead of B times [P, P]."""
        b_scenes = f1.shape[0] * world()
        g1 = _l2n(_pair_rows(f1, scene, i1), 1e-7)
        g2 = _l2n(_pair_rows(f2, scene, i2), 1e-7)
        with torch.no_grad():
            c1 = _pair_rows(oc1.float(), scene, i1)
            c2 = _pair_rows(oc2.float(), scene, i2)
        loss = g1.new_zeros(())
        pos = g1.new_zeros(())
        neg = g1.new_zeros(())
        for s in range(b_scenes):
            idx = torch.nonzero(pair_valid & (scene == s))[:, 0]
            cnt = idx.numel()
            if cnt == 0:  # an absent scene adds nothing
                continue
            sim = g1[idx] @ g2[idx].T  # [n, n]
            pos = pos + sim.diagonal().sum().detach() / cnt
            neg = neg + sim.detach().sum() / cnt ** 2 - pos / cnt
            with torch.no_grad():
                part = self._partitions(c1[idx], c2[idx])
                eye = torch.eye(cnt, dtype=torch.bool, device=sim.device)
            for pid in (-1, 0, 1, 2, 3):
                logits = (sim / self.nce_t).masked_fill(~((part == pid) | eye), -1e9)
                loss = loss - F.log_softmax(logits, -1).diagonal().sum() / cnt
        return (loss / (b_scenes * self.partitions), pos / b_scenes, neg / b_scenes)
