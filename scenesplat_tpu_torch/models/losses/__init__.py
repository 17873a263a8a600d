from .builder import LOSSES, Criteria, build_criteria
from . import contrastive, lovasz, misc  # noqa: F401 (register the losses)

__all__ = ["LOSSES", "Criteria", "build_criteria"]
