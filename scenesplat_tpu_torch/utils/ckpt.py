"""SSL backbone extraction (counterpart of
``tools/rename_ckpt_dino_to_ptv3.py``; reference
``scripts/rename_ckpt_dino_to_ptv3.py``).

A SimDINOSSL checkpoint of the port holds the student as ``backbone.*`` and
the EMA teacher as ``teacher.*`` (``models/ssl.py``). ``extract_backbone``
takes the chosen one's tensors, BatchNorm statistics included, renamed to
``backbone.*``, which is the name a ``LangPretrainer`` or a
``DefaultSegmentorV2`` gives its backbone, and drops ``mask_token``, which
neither of them has. The result goes under ``state_dict`` as
``CheckpointSaver`` writes it, so ``weight=<out>.pth`` warm-starts either
model through ``CheckpointLoader`` (a stem of other ``in_channels`` is
skipped by its shape)."""

from __future__ import annotations

from typing import Dict

import torch

SOURCES = {"teacher": "teacher.", "student": "backbone."}


def extract_backbone(state: Dict[str, torch.Tensor], source: str = "teacher"
                     ) -> Dict[str, torch.Tensor]:
    """``backbone.*`` of a SimDINOSSL state dict's ``source`` ("teacher" or
    "student"; a DDP ``module.`` prefix dropped), without ``mask_token``.
    Raises if the state dict has no such tensors."""
    if source not in SOURCES:
        raise ValueError(f"source must be one of {sorted(SOURCES)}, got {source!r}")
    prefix = SOURCES[source]
    out = {}
    for key, value in state.items():
        key = key.removeprefix("module.")
        if key.startswith(prefix) and key != prefix + "mask_token":
            out["backbone." + key[len(prefix):]] = value
    if not out:
        raise ValueError(f"no {prefix}* tensor in the checkpoint: not an SSL checkpoint")
    return out


def extract_backbone_file(src: str, dst: str, source: str = "teacher") -> int:
    """``extract_backbone`` from the checkpoint file ``src`` (its
    ``state_dict``, or the file's dict itself) into ``dst`` as
    ``{"state_dict": ...}``; returns the number of tensors written."""
    ckpt = torch.load(src, map_location="cpu", weights_only=False)
    state = extract_backbone(ckpt.get("state_dict", ckpt), source)
    torch.save(dict(state_dict=state), dst)
    return len(state)
