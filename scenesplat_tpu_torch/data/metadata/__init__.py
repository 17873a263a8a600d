"""Packaged zero-shot metadata: class names and SigLIP2 text embeddings
(copied from ``scenesplat_tpu/data/metadata``). Configs name a table as
``builtin:<name>``. ScanNet-20 and ScanNet++ top-100 have their class names
only (Point Prompt Training matches them to the ScanNet200 table's rows by
name, models/ppt.py:valid_index_by_name). ``scannet_class_ids`` gives
the ScanNet benchmark ids that the submission writers map train indices
to."""

from __future__ import annotations

from pathlib import Path
from typing import List

import numpy as np

_ROOT = Path(__file__).resolve().parent

#: builtin name -> (labels file, embedding file)
_BUILTIN = {
    "scannet200": ("scannet200_labels.txt", "scannet200_siglip2.npy"),
    "scannet20": ("scannet20_labels.txt", None),
    "scannetpp_top100": ("scannetpp_top100_labels.txt", None),
}


def class_labels(name: str) -> List[str]:
    lines = (_ROOT / _BUILTIN[name][0]).read_text().splitlines()
    return [ln.strip() for ln in lines if ln.strip()]


def embedding_file(name: str) -> str:
    """The path of a builtin table's SigLIP2 embeddings (``.npy``, as stored)."""
    if _BUILTIN[name][1] is None:
        raise KeyError(f"builtin {name!r} has class names and no text embeddings")
    return str(_ROOT / "emb" / _BUILTIN[name][1])


def text_embeddings(name: str) -> np.ndarray:
    """L2-normalized SigLIP2 text embeddings [num_classes, 768]."""
    emb = np.load(embedding_file(name)).astype(np.float32)
    emb = emb[: len(class_labels(name))]
    emb /= np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    return emb


#: ScanNet-20's benchmark id of each train index
SCANNET20_CLASS_IDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39)


def scannet_class_ids(num_classes: int = 20) -> np.ndarray:
    """Benchmark submission ids (train index -> raw ScanNet id) of
    ScanNet-20 or ScanNet200."""
    if num_classes == 20:
        return np.asarray(SCANNET20_CLASS_IDS)
    if num_classes == 200:
        return np.loadtxt(_ROOT / "scannet200_class_ids.txt", dtype=np.int64)
    raise KeyError(f"no ScanNet benchmark id table for {num_classes} classes")
