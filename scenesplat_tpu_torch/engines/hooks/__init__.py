from .default import HOOKS, HookBase, build_hooks
from . import evaluator, misc  # noqa: F401 (register the hooks)

__all__ = ["HOOKS", "HookBase", "build_hooks"]
