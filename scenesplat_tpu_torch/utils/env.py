"""Seeding (counterpart of ``scenesplat_tpu/utils/env.py``; reference:
pointcept/utils/env.py)."""

from __future__ import annotations

import os
import random

import numpy as np
import torch


def set_seed(seed: int | None = None) -> int:
    """Seeds Python's and numpy's global generators, torch's (every device)
    and the calling thread's transform RNG (``data/transforms.py``) from
    ``seed`` (from the OS's entropy if None); returns the seed."""
    if seed is None:
        seed = int.from_bytes(os.urandom(4), "little")
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    from scenesplat_tpu_torch.data.transforms import seed_transforms

    seed_transforms(seed)
    return seed
