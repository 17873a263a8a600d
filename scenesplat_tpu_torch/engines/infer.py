"""Bucketed eval-time feature extraction (counterpart of
``scenesplat_tpu/engines/infer.py``).

Each scene is padded to the smallest bucket of a fixed ladder; scenes above
``chunk_size`` are split into independent chunks. PyTorch runs eagerly, so
buckets here bound the number of distinct shapes the model sees rather than
compiles. The ladder is the JAX one; every bucket is valid for every window
size because the last attention window may be ragged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from scenesplat_tpu_torch.models.structure import PointBatch


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def default_buckets(patch_size: int, lo: Optional[int] = None,
                    hi: int = 524288) -> list:
    """Powers of two plus midpoints (1k, 1.5k, 2k, 3k, ...), each rounded up
    to a ``patch_size`` multiple, starting at max(1024, patch_size)."""
    out = set()
    n = max(1024, patch_size) if lo is None else lo
    while n <= hi:
        for v in (n, n * 3 // 2):
            out.add(_round_up(max(v, patch_size), patch_size))
        n *= 2
    return sorted(out)


def bucket_size(n: int, patch_size: int,
                buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket >= n; above the largest bucket, round up to a
    ``patch_size`` multiple."""
    for b in buckets if buckets is not None else default_buckets(patch_size):
        if n <= b:
            return b
    return max(patch_size, _round_up(n, patch_size))


class FeatureExtractor:
    """Runs ``model`` (a module taking a PointBatch) on one scene at a time
    on ``device``. ``output_fn`` maps the model output to one [B, N, C]
    tensor of per-point outputs, or to a classifier's [B, C] logits (by
    default: a PointBatch's ``feat``, a bare tensor as it is). A
    classifier's logits come back whole, [C]: they have no point axis to
    cut the padding from. A sample that names its dataset's ``condition``
    (Point Prompt Training) or its shape category's ``cls_token`` (part
    segmentation) hands it to the model."""

    def __init__(self, model: torch.nn.Module, patch_size: int = 1024,
                 buckets: Optional[Sequence[int]] = None, chunk_size: int = 524288,
                 output_fn: Optional[Callable] = None, device="cuda"):
        self.model = model
        self.patch_size = patch_size
        self.buckets = sorted(buckets) if buckets else None
        self.chunk_size = chunk_size
        self.output_fn = output_fn or (
            lambda out: out.feat if isinstance(out, PointBatch) else out)
        self.device = torch.device(device)

    def _bucket(self, n: int) -> int:
        if self.buckets:
            for b in self.buckets:
                if n <= b:
                    return b
            return self.buckets[-1]
        return bucket_size(n, self.patch_size)

    def _run_chunk(self, coord, feat, grid_coord, kwargs) -> np.ndarray:
        n = coord.shape[0]
        pad = self._bucket(n) - n
        mask = np.zeros(n + pad, bool)
        mask[:n] = True

        def padded(x):
            x = np.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
            return torch.from_numpy(x)[None].to(self.device)

        point = PointBatch(coord=padded(coord), feat=padded(feat),
                           grid_coord=padded(grid_coord),
                           mask=torch.from_numpy(mask)[None].to(self.device))
        with torch.inference_mode():
            out = self.output_fn(self.model(point, **kwargs))
        out = out[0] if out.dim() == 2 else out[0, :n]  # a classifier's [1, C]: whole
        return out.float().cpu().numpy()

    def __call__(self, sample: Dict[str, np.ndarray]) -> np.ndarray:
        """sample: dict with coord [n, 3], feat [n, C], grid_coord [n, 3].
        Returns [n, C] per-point outputs, or a classifier's [C] logits; a
        classifier's sample above ``chunk_size`` points raises, since the
        chunks' logits would be no one object's."""
        coord = np.asarray(sample["coord"], np.float32)
        feat = np.asarray(sample["feat"], np.float32)
        grid_coord = np.asarray(sample["grid_coord"], np.int64)
        n = coord.shape[0]
        kwargs = {"condition": sample["condition"]} if "condition" in sample else {}
        if sample.get("cls_token") is not None:
            kwargs["cls_token"] = torch.from_numpy(
                np.asarray(sample["cls_token"], np.int64).reshape(1)).to(self.device)
        if n <= self.chunk_size:
            return self._run_chunk(coord, feat, grid_coord, kwargs)
        outs = []
        for start in range(0, n, self.chunk_size):
            sl = slice(start, min(start + self.chunk_size, n))
            gc = grid_coord[sl]
            gc = gc - gc.min(axis=0)  # chunks re-quantize independently
            outs.append(self._run_chunk(coord[sl], feat[sl], gc, kwargs))
            if outs[-1].ndim == 1:
                raise ValueError(f"a classifier's sample of {n} points is above chunk_size "
                                 f"{self.chunk_size}: its chunks' logits are no one object's")
        return np.concatenate(outs, axis=0)
