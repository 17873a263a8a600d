"""Hook base and registry (counterpart of
``scenesplat_tpu/engines/hooks/default.py``). Building a hook type the port
does not have raises ``KeyError``: a configured hook is never skipped."""

from scenesplat_tpu_torch.utils.registry import Registry

HOOKS = Registry("hooks")


class HookBase:
    """Six-phase training hook; the trainer sets ``self.trainer``."""

    trainer = None

    def before_train(self):
        pass

    def before_epoch(self):
        pass

    def before_step(self):
        pass

    def after_step(self):
        pass

    def after_epoch(self):
        pass

    def after_train(self):
        pass

    def _seed(self) -> int:
        """The config's seed, for the per-scene seeding of the transforms."""
        return int(self.trainer.cfg.get("seed", 0))


def build_hooks(cfg_list):
    return [HOOKS.build(dict(c)) for c in (cfg_list or [])]
