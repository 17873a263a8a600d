"""Optimizers and schedules (counterpart of ``scenesplat_tpu/utils/optimizer.py``).

The JAX package rebuilt torch's optimizers and the reference's schedules
on optax; the port uses torch's own where they compute the same thing:
``AdamW``, ``Adam`` and ``SGD`` (momentum, nesterov; weight decay added to
the gradient, as torch and the JAX chain add it), ``OneCycleLR`` (its
momentum cycle, on by default, drives Adam's beta1 or SGD's momentum) and
``CosineAnnealingLR``; ``MultiStepLR`` is torch's over the reference's
float milestones rate * T (torch applies gamma only at an integral
milestone, and the reference and the JAX package keep that). The
reference's own ``PolyLR`` ((1 - s / (T + 1)) ** power), ``ExpLR`` (gamma
** (s / T)) and ``MultiStepWithWarmupLR`` are ``LambdaLR``s of its
formulas. Parameter groups come from ``param_dicts`` by keyword, in the
reference's order: the default group first, then one group per keyword,
each parameter in the group of the first keyword its name contains
(``"block"`` matches ``backbone.enc.enc0.block0...`` as it matches flax's
``enc0_block0``); a keyword group may set its own ``lr``,
``weight_decay`` and (SGD) ``momentum``. A ``max_lr`` list gives each
group its peak, as torch does; the JAX package takes each group's own lr
instead, which equals the list in every config of the repo.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch


def param_groups(model: torch.nn.Module, lr: float, weight_decay: float,
                 param_dicts: Optional[List[Dict[str, Any]]] = None) -> List[dict]:
    """[default group, one group per ``param_dicts`` keyword]; a keyword
    group may set its own ``lr`` and ``weight_decay``."""
    dicts = [dict(d) for d in param_dicts or []]
    groups = [dict(params=[], names=[], lr=lr, weight_decay=weight_decay)]
    for d in dicts:
        groups.append(dict(params=[], names=[], lr=d.get("lr", lr),
                           weight_decay=d.get("weight_decay", weight_decay)))
        if "momentum" in d:
            groups[-1]["momentum"] = d["momentum"]
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        i = next((j + 1 for j, d in enumerate(dicts) if d["keyword"] in name), 0)
        groups[i]["params"].append(p)
        groups[i]["names"].append(name)
    return groups


def build_optimizer(cfg: Dict[str, Any], model: torch.nn.Module,
                    param_dicts: Optional[List[Dict[str, Any]]] = None
                    ) -> torch.optim.Optimizer:
    cfg = dict(cfg)
    kind = cfg.pop("type", "AdamW")
    lr = cfg.pop("lr", 1e-3)
    weight_decay = cfg.pop("weight_decay", 0.0)
    groups = param_groups(model, lr, weight_decay, param_dicts)
    if kind in ("AdamW", "Adam"):
        return getattr(torch.optim, kind)(groups, lr=lr, weight_decay=weight_decay,
                                          betas=tuple(cfg.pop("betas", (0.9, 0.999))),
                                          eps=cfg.pop("eps", 1e-8))
    if kind == "SGD":
        return torch.optim.SGD(groups, lr=lr, weight_decay=weight_decay,
                               momentum=cfg.pop("momentum", 0.9),
                               nesterov=cfg.pop("nesterov", False))
    raise ValueError(f"optimizer {kind} is not ported (AdamW, Adam and SGD are)")


def build_scheduler(cfg: Optional[Dict[str, Any]], optimizer: torch.optim.Optimizer,
                    total_steps: int):
    """The configured schedule over ``total_steps``, stepped once per train
    step; None without a config. OneCycleLR gets the JAX package's guard
    for short runs: at least 2 steps and a warmup of at least one step."""
    if not cfg:
        return None
    cfg = dict(cfg)
    kind = cfg.pop("type")
    sched = torch.optim.lr_scheduler
    if kind == "OneCycleLR":
        total_steps = max(int(total_steps), 2)
        pct_start = max(float(cfg.pop("pct_start", 0.3)), 1.0 / total_steps)
        if pct_start * total_steps - 1.0 < 1e-6:
            # torch divides by the warmup's end step, pct_start * T - 1, which
            # the guard can make 0; a millionth of a step more keeps its formula
            pct_start = (1.0 + 1e-6) / total_steps
        max_lr = cfg.pop("max_lr", [g["lr"] for g in optimizer.param_groups])
        return sched.OneCycleLR(
            optimizer, max_lr=list(max_lr) if isinstance(max_lr, (list, tuple)) else max_lr,
            total_steps=total_steps, pct_start=pct_start, **cfg)
    if kind == "CosineAnnealingLR":
        return sched.CosineAnnealingLR(optimizer, T_max=total_steps,
                                       eta_min=cfg.get("eta_min", 0.0))
    if kind == "MultiStepLR":
        return sched.MultiStepLR(optimizer, gamma=cfg.get("gamma", 0.1), milestones=[
            rate * total_steps for rate in cfg.get("milestones", [])])
    if kind == "PolyLR":
        power = float(cfg.get("power", 0.9))
        return sched.LambdaLR(
            optimizer, lambda s: max(1.0 - s / (total_steps + 1.0), 0.0) ** power)
    if kind == "ExpLR":
        gamma = float(cfg.get("gamma", 0.9))
        return sched.LambdaLR(optimizer, lambda s: gamma ** (s / total_steps))
    if kind == "MultiStepWithWarmupLR":
        milestones = [rate * total_steps for rate in cfg.get("milestones", [])]
        gamma = float(cfg.get("gamma", 0.1))
        warmup_end = float(cfg.get("warmup_rate", 0.05)) * total_steps
        warmup_scale = float(cfg.get("warmup_scale", 1e-6))

        def factor(s):
            decay = gamma ** sum(m <= s for m in milestones)
            if s <= warmup_end:
                return (1.0 - (1.0 - s / max(warmup_end, 1e-9)) * (1.0 - warmup_scale)) * decay
            return decay

        return sched.LambdaLR(optimizer, factor)
    raise ValueError(f"scheduler {kind} is not ported")
