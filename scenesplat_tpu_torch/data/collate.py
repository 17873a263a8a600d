"""Fixed-shape padded collation with Mix3D (the port's copy of
``scenesplat_tpu/data/collate.py:collate_padded``).

Each sample is padded to ``num_points`` slots with a ``mask``. Mix3D merges
consecutive sample pairs with probability ``mix_prob``: a mixed pair's
points are concatenated into one slot and the batch dimension stays
static. A sample above ``num_points`` is randomly downsampled. The JAX
package drops its host-built conv-plan keys on both paths; the port builds
every plan on the card and has no such keys.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from .transforms import trng

PAD_VALUES = {"segment": -1, "instance": -1, "pc_segment": -1}
INT_KEYS = ("segment", "instance", "grid_coord", "index", "pc_segment")
BOOL_KEYS = ("valid_feat_mask",)


def _per_point(key, value, n):
    return (isinstance(value, np.ndarray) and value.shape[:1] == (n,)
            and not key.startswith(("pc_", "origin_")))


def _merge_two(a: Dict[str, np.ndarray], b: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    na, nb = a["coord"].shape[0], b["coord"].shape[0]
    merged = {}
    for key, va in a.items():
        if _per_point(key, va, na) and key in b and _per_point(key, b[key], nb):
            merged[key] = np.concatenate([va, b[key]], axis=0)
        else:
            merged[key] = va
    return merged


def collate_padded(samples: List[Dict[str, np.ndarray]], num_points: int,
                   mix_prob: float = 0.0) -> Dict[str, np.ndarray]:
    """Sample dicts -> dict of [B, num_points, ...] arrays plus ``mask``.

    With ``mix_prob`` > 0 the loader supplies 2B samples; slot i keeps
    sample 2i and, with probability ``mix_prob``, merges sample 2i+1 into
    it. Integer keys become int32, float keys float32 except float16
    (SigLIP2 ``lang_feat`` ships as stored)."""
    if mix_prob > 0 and len(samples) > 1:
        mixed = []
        it = iter(samples)
        for a in it:
            b = next(it, None)
            if b is not None and trng().random() < mix_prob:
                mixed.append(_merge_two(a, b))
            else:
                mixed.append(a)
        samples = mixed

    shrunk = []
    for s in samples:
        n = s["coord"].shape[0]
        if n > num_points:
            keep = trng().choice(n, num_points, replace=False)
            s = {k: (v[keep] if _per_point(k, v, n) else v) for k, v in s.items()}
        shrunk.append(s)
    samples = shrunk

    keys = set(samples[0])
    for s in samples[1:]:
        keys &= set(s)
    b = len(samples)
    lengths = [s["coord"].shape[0] for s in samples]
    batch = {}
    for key in keys:
        vals = [s[key] for s in samples]
        if not isinstance(vals[0], np.ndarray):
            if isinstance(vals[0], (int, float)):
                batch[key] = np.asarray(vals)
            continue
        if any(v.shape[:1] != (n,) for v, n in zip(vals, lengths)) or (
                key.startswith(("pc_", "origin_"))):
            continue  # per-scene full-resolution arrays do not batch
        dtype = vals[0].dtype
        if key in INT_KEYS:
            dtype = np.int32
        elif key in BOOL_KEYS or dtype == bool:
            dtype = np.dtype(bool)
        elif dtype != np.float16 and np.issubdtype(dtype, np.floating):
            dtype = np.float32
        fill = PAD_VALUES.get(key, 0)
        arr = np.empty((b, num_points) + vals[0].shape[1:], dtype)
        for i, v in enumerate(vals):
            arr[i, : lengths[i]] = v
            if lengths[i] < num_points:
                arr[i, lengths[i]:] = fill
        batch[key] = arr
    mask = np.zeros((b, num_points), bool)
    for i, n in enumerate(lengths):
        mask[i, :n] = True
    batch["mask"] = mask
    return batch
