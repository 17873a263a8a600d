"""Point Prompt Training (counterpart of ``scenesplat_tpu/models/ppt.py``):
multi-dataset training of a PDNorm-conditioned backbone (PT-v3m1 with
``pdnorm_conditions``) with a per-dataset context embedding, and either

  - PPT-v1m1 (language-guided): features projected into a text-embedding
    space and scored against the condition's classes of a fixed class
    embedding table (a ``.npy``, as in the JAX package: no CLIP here), or
  - PPT-v1m2 (decoupled): one linear head per condition.

A batch holds one condition, named as the dataset's ``Add`` transform sets
it (``condition``); the model looks its own index up by that name and hands
the NAME to the backbone, whose PDNorms look theirs up in their own
``conditions`` (the reference's behaviour; the JAX package hands its index
on, so two tuples in different orders pick another dataset's norms).
Logits live in the condition's local class space, padded to the largest
class count with -1e9 as in the JAX package. ``backbone_mode`` returns the
backbone's output.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .builder import MODELS, build_model
from .norm import condition_name
from .ptv3 import Linear
from .structure import PointBatch

PAD_LOGIT = -1e9


def label_list(class_name) -> list:
    """A sequence of names, a label file (one name a line) or a packaged
    table's names (``builtin:<name>``, data/metadata)."""
    if isinstance(class_name, (list, tuple)):
        return list(class_name)
    if class_name.startswith("builtin:"):
        from scenesplat_tpu_torch.data import metadata

        return metadata.class_labels(class_name.split(":", 1)[1])
    with open(class_name) as f:
        return [ln.strip() for ln in f if ln.strip()]


def valid_index_by_name(class_name, condition_classes) -> tuple:
    """PPT-v1m1's ``valid_index`` for conditions whose class lists are
    ``condition_classes`` (each as ``label_list`` takes it), over the
    embedding rows ``class_name``: a class whose name is in ``class_name``
    takes that row; every other class takes the first row that its
    condition does not use yet, so each class of a condition has a row of
    its own (its logit is then learned through ``proj_head`` alone, with no
    language prior)."""
    names = label_list(class_name)
    row = {n: i for i, n in enumerate(names)}
    out = []
    for classes in condition_classes:
        classes = label_list(classes)
        ids = [row.get(n) for n in classes]
        used = set(ids)
        free = iter(i for i in range(len(names)) if i not in used)
        out.append(tuple(i if i is not None else next(free) for i in ids))
    return tuple(out)


def _head_generator(backbone: dict) -> torch.Generator:
    """The heads' and the context table's draws, from the backbone's seed."""
    return torch.Generator().manual_seed(int(backbone.get("seed", 0)) + 1)


class _PPTBase(nn.Module):
    def __init__(self, backbone: dict, context_channels: int, conditions: Sequence[str],
                 gen: torch.Generator):
        super().__init__()
        self.conditions = tuple(conditions)
        self.backbone = build_model(dict(backbone))
        self.embedding_table = nn.Embedding(len(self.conditions), context_channels)
        nn.init.normal_(self.embedding_table.weight, generator=gen)

    def condition_index(self, condition) -> int:
        name = condition_name(condition)
        if name not in self.conditions:
            raise KeyError(f"condition {name!r} is not one of {self.conditions}")
        return self.conditions.index(name)

    def encode(self, point: PointBatch, generator, condition):
        """(backbone output, this condition's index)."""
        if condition is None:
            raise ValueError("PPT needs the batch's condition")
        ci = self.condition_index(condition)
        idx = torch.full((point.mask.shape[0],), ci, dtype=torch.long,
                         device=self.embedding_table.weight.device)
        out = self.backbone(point, generator=generator, condition=condition_name(condition),
                            context=self.embedding_table(idx))
        return out, ci


@MODELS.register_module("PPT-v1m1")
class PointPromptTraining(_PPTBase):
    """Language-guided PPT: ``proj_head`` maps the backbone's features into
    the class embedding's space; logits = exp(``logit_scale``) x cosine
    similarity to the condition's classes ``valid_index[c]`` (indices into
    ``class_name``), in that order. ``class_embedding`` is a buffer loaded
    from ``class_embedding_path`` (a ``.npy`` or ``builtin:<name>``; rows =
    ``class_name``, names or as ``label_list`` takes them), or rows drawn
    N(0, 0.02) from the model's seed at ``text_channels`` without one."""

    def __init__(self, backbone: dict, backbone_out_channels: int = 96,
                 context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 class_name=(), valid_index: Sequence[Sequence[int]] = (),
                 class_embedding_path: Optional[str] = None, text_channels: int = 512,
                 backbone_mode: bool = False):
        gen = _head_generator(backbone)
        super().__init__(backbone, context_channels, conditions, gen)
        if len(self.conditions) != len(valid_index):
            raise ValueError(f"{len(valid_index)} valid_index lists for "
                             f"{len(self.conditions)} conditions")
        self.backbone_mode = backbone_mode
        if backbone_mode:
            return
        n_cls = len(label_list(class_name))
        if class_embedding_path:
            if class_embedding_path.startswith("builtin:"):
                from scenesplat_tpu_torch.data import metadata

                class_embedding_path = metadata.embedding_file(class_embedding_path[8:])
            emb = np.load(class_embedding_path).astype(np.float32)
            if emb.shape[0] != n_cls:
                raise ValueError(f"{emb.shape[0]} class embeddings for {n_cls} class names")
            emb = torch.from_numpy(emb)
        else:
            emb = torch.empty(n_cls, text_channels).normal_(0.0, 0.02, generator=gen)
        self.register_buffer("class_embedding", emb)
        self.proj_head = Linear(backbone_out_channels, emb.shape[1], dtype=torch.float32)
        self.proj_head.reset_parameters(gen)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))
        max_k = max(len(ix) for ix in valid_index)
        ids = torch.zeros(len(self.conditions), max_k, dtype=torch.long)
        for ci, ix in enumerate(valid_index):
            if min(ix) < 0 or max(ix) >= n_cls:
                raise ValueError(f"valid_index[{ci}] outside the {n_cls} classes")
            ids[ci, :len(ix)] = torch.tensor(list(ix))
        self.register_buffer("class_ids", ids, persistent=False)
        self.register_buffer("class_counts", torch.tensor([len(ix) for ix in valid_index]),
                             persistent=False)

    def forward(self, point: PointBatch, generator=None, condition=None) -> PointBatch:
        out, ci = self.encode(point, generator, condition)
        if self.backbone_mode:
            return out
        feat = self.proj_head(out.feat).float()
        feat = feat / (feat.norm(dim=-1, keepdim=True) + 1e-8)
        emb = self.class_embedding[self.class_ids[ci]]  # [max_k, text]
        emb = emb / (emb.norm(dim=-1, keepdim=True) + 1e-8)
        logits = self.logit_scale.exp() * (feat @ emb.T)
        slot = torch.arange(emb.shape[0], device=logits.device)
        return out.replace(feat=logits.masked_fill(slot >= self.class_counts[ci], PAD_LOGIT))


@MODELS.register_module("PPT-v1m2")
class PointPromptTrainingDecoupled(_PPTBase):
    """Decoupled PPT: one linear head per condition (``seg_heads.{i}``), each
    padded to the largest class count; the condition's head scores its
    points, its columns past the condition's count set to -1e9. Only the
    active head runs, so the others get no gradient."""

    def __init__(self, backbone: dict, backbone_out_channels: int = 96,
                 context_channels: int = 256,
                 conditions: Sequence[str] = ("Structured3D", "ScanNet", "S3DIS"),
                 num_classes: Sequence[int] = (25, 20, 13), backbone_mode: bool = False):
        gen = _head_generator(backbone)
        super().__init__(backbone, context_channels, conditions, gen)
        if len(self.conditions) != len(num_classes):
            raise ValueError(f"{len(num_classes)} class counts for {len(self.conditions)} "
                             "conditions")
        self.backbone_mode = backbone_mode
        self.num_classes = tuple(num_classes)
        self.seg_heads = nn.ModuleList(
            [Linear(backbone_out_channels, max(num_classes), dtype=torch.float32)
             for _ in self.conditions])
        for head in self.seg_heads:
            head.reset_parameters(gen)

    def forward(self, point: PointBatch, generator=None, condition=None) -> PointBatch:
        out, ci = self.encode(point, generator, condition)
        if self.backbone_mode:
            return out
        logits = self.seg_heads[ci](out.feat)
        cls = torch.arange(logits.shape[-1], device=logits.device)
        return out.replace(feat=logits.masked_fill(cls >= self.num_classes[ci], PAD_LOGIT))
