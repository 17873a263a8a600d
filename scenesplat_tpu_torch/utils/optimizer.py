"""Optimizer and schedule (counterpart of ``scenesplat_tpu/utils/optimizer.py``).

The JAX package rebuilt torch's AdamW and OneCycleLR on optax; the port
uses ``torch.optim.AdamW`` and ``torch.optim.lr_scheduler.OneCycleLR`` as
they are, OneCycle's beta1 cycle (``cycle_momentum``, on by default)
included. Parameter groups come from ``param_dicts`` by keyword, in the
reference's order: the default group first, then one group per keyword,
each parameter in the group of the first keyword its name contains
(``"block"`` matches ``backbone.enc.enc0.block0...`` as it matches flax's
``enc0_block0``). A ``max_lr`` list gives each group its peak, as torch
does; the JAX package takes each group's own lr instead, which equals the
list in every config of the repo.
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
    if kind != "AdamW":
        raise ValueError(f"optimizer {kind} is not ported (AdamW is)")
    lr = cfg.pop("lr", 1e-3)
    weight_decay = cfg.pop("weight_decay", 0.0)
    return torch.optim.AdamW(param_groups(model, lr, weight_decay, param_dicts), lr=lr,
                             weight_decay=weight_decay,
                             betas=tuple(cfg.pop("betas", (0.9, 0.999))),
                             eps=cfg.pop("eps", 1e-8))


def build_scheduler(cfg: Optional[Dict[str, Any]], optimizer: torch.optim.Optimizer,
                    total_steps: int):
    """OneCycleLR over ``total_steps``, stepped once per train step; None
    without a config. Short runs get the JAX package's guard: at least 2
    steps and a warmup of at least one step."""
    if not cfg:
        return None
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind != "OneCycleLR":
        raise ValueError(f"scheduler {kind} is not ported (OneCycleLR is)")
    total_steps = max(int(total_steps), 2)
    pct_start = max(float(cfg.pop("pct_start", 0.3)), 1.0 / total_steps)
    if pct_start * total_steps - 1.0 < 1e-6:
        # torch divides by the warmup's end step, pct_start * T - 1, which
        # the guard can make 0; a millionth of a step more keeps its formula
        pct_start = (1.0 + 1e-6) / total_steps
    max_lr = cfg.pop("max_lr", [g["lr"] for g in optimizer.param_groups])
    return torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=list(max_lr) if isinstance(max_lr, (list, tuple)) else max_lr,
        total_steps=total_steps, pct_start=pct_start, **cfg)
