"""Loss registry and the summing ``Criteria`` (counterpart of
``scenesplat_tpu/models/losses/builder.py``)."""

from __future__ import annotations

from scenesplat_tpu_torch.utils.registry import Registry

LOSSES = Registry("losses")


class Criteria:
    """Sums the configured losses; each loss takes the keyword arguments it
    uses and ignores the rest."""

    def __init__(self, cfg=None):
        self.criteria = [LOSSES.build(dict(c)) for c in (cfg or [])]

    def __call__(self, pred, target, **kwargs):
        if not self.criteria:
            return pred
        total = 0.0
        for crit in self.criteria:
            total = total + crit(pred, target, **kwargs)
        return total


def build_criteria(cfg):
    return Criteria(cfg)
