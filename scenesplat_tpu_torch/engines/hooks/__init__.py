from .default import HOOKS, HookBase, build_hooks
from . import misc  # noqa: F401 (registers the hooks)

__all__ = ["HOOKS", "HookBase", "build_hooks"]
