"""Tensor (model) parallel for PT-v3m1 (counterpart of
``scenesplat_tpu/parallel/tp.py``).

Megatron-style sharding of each block's four big matmuls over the layout's
``model`` axis (torch weights are [out, in]):

- ``attn.qkv``  weight [3C, C] and bias: column-parallel. Its rows are laid
  out (3, H, D) (the attention views them as [B, N, 3, C]), and a rank
  takes the q, k and v rows of its H / tp heads, so that K1 and K2 run on
  whole heads at the unchanged head width;
- ``attn.proj`` weight [C, C]: row-parallel, the input columns of the same
  heads;
- ``mlp.0.fc1`` weight [hC, C] and bias: column-parallel, a contiguous block
  of the hidden features;
- ``mlp.0.fc2`` weight [C, hC]: row-parallel; its bias, as proj's, stays
  whole and is added once, after the sum;
- ``attn.rpe.rpe_table`` [rows, H] (``enable_rpe``): the heads' columns.

Everything else (norms, CPE, the pooling and unpooling ``proj``, heads) is
replicated. The JAX package states the same families as GSPMD annotations:
its ``P(None, "model")`` on the flax qkv kernel [C, 3C] cuts the 3C axis
into contiguous blocks and leaves the regrouping by head to the
partitioner; the port cuts by head. The results are equal. Its RPE table
stays replicated there.

This module keeps the name rule and the state dict's shards; a block
knows its own layers (``models/ptv3.py:Block.shard_tp``). The collectives
GSPMD inserts are written out in ``models/ptv3.py:Linear``, over the model
group only: a column layer's input is the identity forward and a sum
backward, a row layer's output a sum forward and the identity backward
(``parallel/dist.py:copy_to_group``, ``reduce_from_group``). A block whose
heads or hidden width the degree does not divide keeps its layers whole:
the shard map records which (the JAX partitioner takes any degree).
Gradients of the sharded parameters are summed over the data ranks only:
``dist.data_parallel`` averages over the layout's points group, and
``engines/train_step.py:apply_gradients`` takes the global norm over the
model group.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .dist import Layout, gather_bitwise, layout, make_layout

# (dim, groups): the axis cut over the model ranks, viewed as [groups,
# degree, rest] (qkv: q, k and v each cut by head) and the rank's index
# taken on the degree axis; None: replicated
Spec = Optional[Tuple[int, int]]

_RULES = (
    ("attn.qkv.weight", (0, 3)), ("attn.qkv.bias", (0, 3)),
    ("attn.proj.weight", (1, 1)),
    ("mlp.0.fc1.weight", (0, 1)), ("mlp.0.fc1.bias", (0, 1)),
    ("mlp.0.fc2.weight", (1, 1)),
    ("attn.rpe.rpe_table", (1, 1)),
)


def tp_groups(data: int, model: int) -> Layout:
    """The (data, model) grid, the model axis minor (rank = d * model + m,
    as ``tp_mesh`` lays its devices out); every process calls it. Raises
    unless the group holds data * model processes."""
    if model < 2:
        raise ValueError(f"tensor parallel over a model axis of {model}")
    return make_layout(data, model=model)


def tp_spec_for_name(name: str, tensor: torch.Tensor) -> Spec:
    """The family rule on a PT-v3m1 state-dict name (counterpart of
    ``tp_spec_for_path``): the sharded axis and its grouping, or None."""
    if getattr(tensor, "ndim", 0) == 0:
        return None
    for suffix, spec in _RULES:
        if name == suffix or name.endswith("." + suffix):
            return spec
    return None


def tp_shard_map(model: torch.nn.Module, degree: int) -> Dict[str, Spec]:
    """Every state-dict name of ``model`` (whole, not yet sharded) with its
    spec at ``degree``: the rule's in a block that ``degree`` cuts
    (``models/ptv3.py:Block.tp_divides``), else None (left replicated)."""
    cut = [name + "." for name, mod in model.named_modules()
           if hasattr(mod, "tp_divides") and mod.tp_divides(degree)]
    return {name: (tp_spec_for_name(name, t)
                   if any(name.startswith(prefix) for prefix in cut) else None)
            for name, t in model.state_dict().items()}


def _grouped(t: torch.Tensor, spec, degree: int) -> torch.Tensor:
    dim, groups = spec
    shape = tuple(t.shape)
    if shape[dim] % (groups * degree):
        raise ValueError(f"axis {dim} of {shape} does not split into {groups} x {degree}")
    return t.reshape(shape[:dim] + (groups, degree, shape[dim] // (groups * degree))
                     + shape[dim + 1:])


def shard_tensor(t: torch.Tensor, spec: Spec, degree: int, index: int) -> torch.Tensor:
    """Model rank ``index``'s share of a whole tensor (itself if ``spec`` is
    None)."""
    if spec is None:
        return t
    dim = spec[0]
    part = _grouped(t, spec, degree).select(dim + 1, index)
    shape = list(t.shape)
    shape[dim] //= degree
    return part.reshape(shape).clone()


def merge_tensors(shares: List[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The whole tensor from every model rank's share, in rank order."""
    if spec is None:
        return shares[0]
    dim, groups = spec
    degree = len(shares)
    parts = [_grouped(s, spec, 1).squeeze(dim + 1) for s in shares]
    stacked = torch.stack(parts, dim + 1)  # [.., groups, degree, rest, ..]
    shape = list(shares[0].shape)
    shape[dim] *= degree
    return stacked.reshape(shape)


def shard_state_dict_tp(state: Dict[str, torch.Tensor], shard_map: Dict[str, Spec],
                        degree: int, index: int) -> Dict[str, torch.Tensor]:
    """Model rank ``index``'s state dict of a whole one (``utils/weights.py:
    state_dict_from_flax``'s, or a checkpoint's)."""
    return {k: shard_tensor(torch.as_tensor(v), shard_map.get(k), degree, index)
            for k, v in state.items()}


def merge_state_dicts_tp(states: List[Dict[str, torch.Tensor]],
                         shard_map: Dict[str, Spec]) -> Dict[str, torch.Tensor]:
    """The whole state dict from every model rank's, in rank order."""
    return {k: merge_tensors([s[k] for s in states], shard_map.get(k)) for k in states[0]}


def shard_model_tp(model: torch.nn.Module) -> torch.nn.Module:
    """Cuts ``model``'s blocks (in place) into this rank's share over the
    layout's model group: the sharded parameters are replaced by their
    shares and marked ``tp_sharded``, each cut block told its share
    (``Block.shard_tp``). Records ``model.tp_shard_map`` and
    ``model.tp_grid``. Raises without a model group of 2 or more."""
    grid = layout()
    if grid.model < 2 or grid.model_group is None:
        raise RuntimeError("tensor parallel needs a layout with a model group of 2 or more "
                           "(tp_groups, then dist.set_layout)")
    degree, index = grid.model, grid.model_rank
    shard_map = tp_shard_map(model, degree)
    params = dict(model.named_parameters())
    for name, spec in shard_map.items():
        if spec is not None:
            p = params[name]
            p.data = shard_tensor(p.data, spec, degree, index)
            p.tp_sharded = True
    for name, mod in model.named_modules():
        if hasattr(mod, "shard_tp") and shard_map.get(name + ".attn.qkv.weight") is not None:
            mod.shard_tp(degree, index, grid.model_group)
    model.tp_shard_map, model.tp_grid = shard_map, grid
    return model


def gather_whole(named: Iterable[Tuple[str, torch.Tensor]],
                 model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The tensors ``named`` (a state dict's items, or gradients by
    parameter name) of a ``shard_model_tp`` model with each share gathered
    whole over its model group, bit for bit (a collective: every rank of
    the group calls it); the others, and all of a model that is not
    sharded, as they are."""
    model = getattr(model, "module", model)  # under DDP, the model itself
    shard_map = getattr(model, "tp_shard_map", None) or {}
    out = {}
    for name, t in named:
        spec = shard_map.get(name)
        if spec is not None:
            grid = model.tp_grid
            shares = gather_bitwise(t, grid.model_rank, grid.model, grid.model_group)
            t = merge_tensors(list(shares.unbind(0)), spec)
        out[name] = t
    return out


def gather_state_dict_tp(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The whole state dict of a ``shard_model_tp`` model on every rank of
    its model group (``gather_whole``); a model that is not sharded gives
    its own. Loads with ``strict=True`` into one process's model."""
    model = getattr(model, "module", model)
    state = model.state_dict()
    if getattr(model, "tp_shard_map", None) is None:
        return state
    return gather_whole(state.items(), model)
