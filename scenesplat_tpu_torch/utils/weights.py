"""Carry the JAX package's PTv3 weights into the port.

The port's own copy of the mapping that
``scenesplat_tpu/utils/ckpt_bridge.py:export_ptv3_lang_checkpoint`` emits:
flax ``params`` and ``batch_stats`` (nested dicts of arrays) become a state
dict in the Pointcept PTv3 key layout, which the port's LangPretrainer or
DefaultSegmentorV2 (prefix ``backbone.``; the segmentor's flax ``seg_head``
becomes ``seg_head.weight`` and ``seg_head.bias``, Pointcept's names) or
PointTransformerV3 (prefix ``""``) takes with
``load_state_dict(strict=True)``. Dense kernels are transposed to
[out, in]; SubMConv kernels [K3, Cin, Cout] are reshaped to spconv's
[k, k, k, Cin, Cout]; every BatchNorm gets a zero ``num_batches_tracked``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch


def _lookup(tree, path):
    node = tree
    for p in path:
        if not isinstance(node, dict) or p not in node:
            return None
        node = node[p]
    return node


def state_dict_from_flax(params, batch_stats, backbone_prefix: str = "backbone.",
                         flax_backbone_key: str = "backbone_module"
                         ) -> Dict[str, np.ndarray]:
    """Flax PTv3 (or LangPretrainer) variables -> Pointcept-layout numpy
    state dict."""
    params = dict(params)
    batch_stats = dict(batch_stats)
    bb_params = params.get(flax_backbone_key, params) if flax_backbone_key else params
    bb_stats = (batch_stats.get(flax_backbone_key, batch_stats)
                if flax_backbone_key else batch_stats)
    out: Dict[str, np.ndarray] = {}

    def get(fpath, stats=False):
        v = _lookup(bb_stats if stats else bb_params, fpath)
        return None if v is None else np.asarray(v)

    def put(tkey, value):
        out[backbone_prefix + tkey] = np.asarray(value)

    def put_dense(tkey, fpath):
        w = get(fpath + ("kernel",))
        if w is None:
            return
        put(tkey + ".weight", w.T)
        b = get(fpath + ("bias",))
        if b is not None:
            put(tkey + ".bias", b)

    def put_ln(tkey, fpath):
        w = get(fpath + ("scale",))
        if w is None:
            return
        put(tkey + ".weight", w)
        b = get(fpath + ("bias",))
        if b is not None:
            put(tkey + ".bias", b)

    def put_bn(tkey, fpath):
        put_ln(tkey, fpath)
        rm = get(fpath + ("mean",), stats=True)
        rv = get(fpath + ("var",), stats=True)
        if rm is not None:
            put(tkey + ".running_mean", rm)
        if rv is not None:
            put(tkey + ".running_var", rv)
        if rm is not None or rv is not None:
            put(tkey + ".num_batches_tracked", np.zeros((), np.int64))

    def put_conv(tkey, fpath):
        w = get(fpath + ("kernel",))
        if w is None:
            return
        k3, cin, cout = w.shape
        k = round(k3 ** (1 / 3))
        if k ** 3 != k3:
            raise ValueError(f"non-cubic conv kernel {w.shape}")
        put(tkey + ".weight", w.reshape(k, k, k, cin, cout))
        b = get(fpath + ("bias",))
        if b is not None:
            put(tkey + ".bias", b)

    put_conv("embedding.stem.conv", ("embedding", "conv"))
    put_bn("embedding.stem.norm", ("embedding", "norm"))
    for name in sorted(bb_params):
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            side, s, i = m.groups()
            t = f"{side}.{side}{s}.block{i}"
            put_conv(f"{t}.cpe.0", (name, "cpe_conv"))
            put_dense(f"{t}.cpe.1", (name, "cpe_linear"))
            put_ln(f"{t}.cpe.2", (name, "cpe_norm"))
            put_ln(f"{t}.norm1.0", (name, "norm1"))
            put_ln(f"{t}.norm2.0", (name, "norm2"))
            put_dense(f"{t}.attn.qkv", (name, "attn", "qkv"))
            put_dense(f"{t}.attn.proj", (name, "attn", "proj"))
            put_dense(f"{t}.mlp.0.fc1", (name, "mlp", "fc1"))
            put_dense(f"{t}.mlp.0.fc2", (name, "mlp", "fc2"))
            continue
        m = re.fullmatch(r"enc(\d+)_down", name)
        if m:
            s = m.group(1)
            put_dense(f"enc.enc{s}.down.proj", (name, "proj"))
            put_bn(f"enc.enc{s}.down.norm.0", (name, "norm"))
            continue
        m = re.fullmatch(r"dec(\d+)_up", name)
        if m:
            s = m.group(1)
            put_dense(f"dec.dec{s}.up.proj.0", (name, "proj"))
            put_bn(f"dec.dec{s}.up.proj.1", (name, "proj_norm"))
            put_dense(f"dec.dec{s}.up.proj_skip.0", (name, "proj_skip"))
            put_bn(f"dec.dec{s}.up.proj_skip.1", (name, "proj_skip_norm"))
    head = params.get("seg_head") if flax_backbone_key else None
    if head is not None:  # DefaultSegmentorV2's linear head, outside the backbone
        out["seg_head.weight"] = np.asarray(head["kernel"]).T
        out["seg_head.bias"] = np.asarray(head["bias"])
    return out


def load_flax_weights(model: torch.nn.Module, params, batch_stats, **kwargs):
    """``state_dict_from_flax`` loaded into ``model`` with strict=True."""
    state = state_dict_from_flax(params, batch_stats, **kwargs)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, strict=True)
    return model
