"""Carry the JAX package's PTv3 and SpUNet weights into the port.

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

A ``SimDINOSSL`` tree (flax ``backbone_module`` with its ``mask_token``,
``dino_head``, ``ibot_head`` and ``mae_*``), with the train state's
``teacher_params`` and ``teacher_batch_stats``, becomes the port's
SimDINOSSL state dict: ``backbone.*`` and ``teacher.*`` in the PTv3 layout
(``mask_token`` reshaped to Pointcept's [1, C], as
``scenesplat_tpu/utils/ckpt_bridge.py`` exports it), the heads'
``{dino,ibot}_head.fc{i}.{weight,bias}`` and
``mae_fc{1,2}.{weight,bias}``, ``mae_norm.{weight,bias}``.

Point Prompt Training (flax ``PPT-v1m1`` / ``PPT-v1m2`` over a PT-v3m1 with
``pdnorm_conditions``): each PDNorm's flax ``norm{c}`` becomes the
reference's ``norm.{c}`` (``norm`` when ``pdnorm_decouple`` is off) and its
``modulation`` ``modulation.1``; ``embedding_table`` becomes
``embedding_table.weight``, ``proj_head`` and ``logit_scale`` keep their
names, the ``constants`` collection's ``class_embedding`` becomes the
buffer of that name and ``seg_head{i}`` ``seg_heads.{i}``. With
``enable_rpe`` each attention's ``rpe_table`` becomes
``attn.rpe.rpe_table``.

SpUNet (a flax tree with ``conv_input``): v1m1, v1m2 and NoSkip in the
reference's spconv_unet_v1m1_base.py names, equal key for key and value for
value to ``scenesplat_tpu/utils/ckpt_bridge.py:export_spunet_checkpoint``
(the 1x1 convs ``final`` and a block's ``proj.0`` as [1, 1, 1, Cin, Cout]);
v1m3 (``pdnorm`` norms) in spconv_unet_v1m3_pdnorm.py's names, the inverse
of that file's ``convert_spunet_v1m3_checkpoint``. PG-v1m1 (the inverse of
``convert_pointgroup_checkpoint``): the backbone under ``backbone.``, flax
``bias_fc1``, ``bias_norm`` and ``bias_fc2`` as ``bias_head.{0,1,3}`` and
``seg_head``. MSC-v1m1/v1m2 (the inverse of ``convert_msc_checkpoint``):
``mask_token`` as [1, Cin], ``color_head`` and ``normal_head``. CAC-v1m1
(the inverse of ``convert_cac_checkpoint``): ``seg_kernel`` / ``seg_bias``
as ``seg_head``, ``proj_fc{1,2}`` and ``apd_fc{1,2}`` as ``proj.{0,2}`` and
``apd_proj.{0,2}``, ``feat_fc1``, ``feat_norm`` and ``feat_fc2`` as
``feat_proj_layer.{0,1,3}``.

Point Transformer V2 (a flax tree with ``patch_embed_proj``: PT-v2m1/m2/m3)
in point_transformer_v2m2_base.py's names, the inverse of
``convert_ptv2_checkpoint`` (m1's ``grouped_weight`` as
``weight_encoding.0.weight`` [1, C]); PT-v2m3's PDNorms (flax ``pdnorm``)
as ``norm.{c}`` (``norm`` undecoupled) and ``modulation.1`` at the place of
the PointBatchNorm. Point Transformer V1 (a tree with ``enc1_down``): Seg
and PartSeg in point_transformer_seg.py's names, the inverse of
``convert_ptv1_checkpoint``; Cls (``cls_fc3``) in point_transformer_cls.py's
(a stage's bottlenecks from ``enc{s}.1``, the head ``cls.{0,1,4,5,8}``).
DefaultSegmentorSkip's head keeps its flax names ``fc{1,2,3}``, ``ln{1,2}``.

The sparse-conv backbones, each the inverse of its converter in
``scenesplat_tpu/utils/ckpt_bridge.py``: MinkUNet (a tree with ``conv0``;
``convert_mink_checkpoint``) in MinkowskiEngine's names, kernels as
Minkowski's [K, Cin, Cout] (``conv0p1s1.kernel``, ``bn0.bn.*``,
``conv{s}p{2^(s-1)}s2``, ``convtr{j}p{2^(8-j)}s2``, ``block{k}.{i}.*``,
``final``); SPVCNN (``point_transform0_fc``; ``convert_spvcnn_checkpoint``)
in ts_spvcnn.py's, torchsparse's ``kernel`` [K, Cin, Cout]; OACNNs
(``stem0_norm``; ``convert_oacnns_checkpoint``) in oacnns_v1m1_base.py's,
spconv's [k, k, k, Cin, Cout] (``final`` as [1, 1, 1, Cin, Cout]);
OctFormer-v1m1 (``embed_proj_conv``; ``convert_octformer_checkpoint``) in
octformer_v1m1_base.py's, ocnn's ``weights`` [taps, Cin, Cout].

The Stratified Transformer (ST-v1m2/v1m1, a tree with ``embed0_kpconv``) in
stratified_transformer_v1m2_refine.py's names, the inverse of
``convert_stratified_checkpoint``: KPConv kernels [P, Cin, Cout] as they
are, with the ``K_points`` buffers the flax tree does not hold (the JAX
module's Fibonacci disposition times ``kp_sigma_radius``), and the
KPConvResBlock's declared, never applied ``point_embed.1.bn.batch_norm``
at its initialization.
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
                         flax_backbone_key: str = "backbone_module",
                         teacher_params=None, teacher_batch_stats=None,
                         constants=None, pdnorm_decouple: bool = True,
                         kp_sigma_radius: float = 0.02) -> Dict[str, np.ndarray]:
    """Flax PTv3 (a ``cls_mode`` one has no ``dec*`` entries, and the
    port's builds no ``dec.*`` module), SpUNet, PTv2, PTv1, MinkUNet,
    SPVCNN, OACNNs or OctFormer (or LangPretrainer, DefaultSegmentorV2,
    DefaultSegmentor, DefaultSegmentorSkip, DefaultPretrainer,
    DefaultClassifier, SimDINOSSL,
    PPT-v1m1, PPT-v1m2, PG-v1m1, MSC-v1m1, MSC-v1m2, CAC-v1m1)
    variables -> Pointcept-layout
    numpy state dict;
    ``teacher_params`` (and its ``teacher_batch_stats``) go under
    ``teacher.``; ``constants`` is PPT-v1m1's collection of that name;
    ``kp_sigma_radius`` is a Stratified Transformer's (its K_points' scale)."""
    params = dict(params)
    batch_stats = dict(batch_stats)
    bb_params = params.get(flax_backbone_key, params) if flax_backbone_key else params
    bb_stats = (batch_stats.get(flax_backbone_key, batch_stats)
                if flax_backbone_key else batch_stats)
    out = _backbone_state(bb_params, bb_stats, backbone_prefix, pdnorm_decouple,
                          kp_sigma_radius)
    if teacher_params is not None:
        out.update(_backbone_state(teacher_params, teacher_batch_stats or {}, "teacher.",
                                   pdnorm_decouple))
    if not flax_backbone_key:
        return out
    head = params.get("seg_head")
    if head is not None:  # DefaultSegmentorV2's linear head, outside the backbone
        _put_dense(out, "seg_head", head)
    if "fc1" in params:  # DefaultSegmentorSkip's head (with ln1, ln2) or DefaultClassifier's
        w = _Writer(out, params, batch_stats, "")
        for name in ("fc1", "fc2", "fc3"):
            w.dense(name, (name,))
        w.ln("ln1", ("ln1",))
        w.ln("ln2", ("ln2",))
    if "bias_fc1" in params or "bias_norm" in batch_stats:  # PG-v1m1's bias head
        w = _Writer(out, params, batch_stats, "")
        w.dense("bias_head.0", ("bias_fc1",))
        w.bn("bias_head.1", ("bias_norm",))
        w.dense("bias_head.3", ("bias_fc2",))
    for name in ("dino_head", "ibot_head"):  # SimDINOSSL's projection heads
        for fc, dense in sorted(params.get(name, {}).items()):
            _put_dense(out, f"{name}.{fc}", dense)
    for name in ("mae_fc1", "mae_fc2"):
        if name in params:
            _put_dense(out, name, params[name])
    if "mae_norm" in params:
        out["mae_norm.weight"] = np.asarray(params["mae_norm"]["scale"])
        out["mae_norm.bias"] = np.asarray(params["mae_norm"]["bias"])
    # Point Prompt Training
    if "embedding_table" in params:
        out["embedding_table.weight"] = np.asarray(params["embedding_table"]["embedding"])
    if "proj_head" in params:
        _put_dense(out, "proj_head", params["proj_head"])
    if "logit_scale" in params:
        out["logit_scale"] = np.asarray(params["logit_scale"])
    for name in params:
        m = re.fullmatch(r"seg_head(\d+)", name)
        if m:
            _put_dense(out, f"seg_heads.{m.group(1)}", params[name])
    if constants and "class_embedding" in constants:
        out["class_embedding"] = np.asarray(constants["class_embedding"])
    w = _Writer(out, params, batch_stats, "")
    # Masked Scene Contrast: the mask token as the reference's [1, Cin]
    if "mask_token" in params:
        out["mask_token"] = np.asarray(params["mask_token"]).reshape(1, -1)
    w.dense("color_head", ("color_head",))
    w.dense("normal_head", ("normal_head",))
    # Context-Aware Classifier
    if "seg_kernel" in params:
        out["seg_head.weight"] = np.asarray(params["seg_kernel"]).T
        out["seg_head.bias"] = np.asarray(params["seg_bias"])
    for flax_name, key in (("proj", "proj"), ("apd", "apd_proj")):
        w.dense(f"{key}.0", (f"{flax_name}_fc1",))
        w.dense(f"{key}.2", (f"{flax_name}_fc2",))
    w.dense("feat_proj_layer.0", ("feat_fc1",))
    w.bn("feat_proj_layer.1", ("feat_norm",))
    w.dense("feat_proj_layer.3", ("feat_fc2",))
    return out


def _put_dense(out: Dict[str, np.ndarray], key: str, dense) -> None:
    out[key + ".weight"] = np.asarray(dense["kernel"]).T
    out[key + ".bias"] = np.asarray(dense["bias"])


class _Writer:
    """Writes one backbone's flax leaves into ``out`` under ``prefix``:
    ``params`` and ``stats`` (batch statistics) may each be empty (a
    gradient tree; statistics alone)."""

    def __init__(self, out: Dict[str, np.ndarray], params, stats, prefix: str):
        self.out, self.params, self.stats, self.prefix = out, params, stats, prefix

    def get(self, fpath, stats=False):
        v = _lookup(self.stats if stats else self.params, fpath)
        return None if v is None else np.asarray(v)

    def node(self, fpath) -> dict:
        return {**(_lookup(self.stats, fpath) or {}), **(_lookup(self.params, fpath) or {})}

    def put(self, tkey, value):
        self.out[self.prefix + tkey] = np.asarray(value)

    def dense(self, tkey, fpath):
        w = self.get(fpath + ("kernel",))
        if w is None:
            return
        self.put(tkey + ".weight", w.T)
        self.bias(tkey, fpath)

    def bias(self, tkey, fpath):
        b = self.get(fpath + ("bias",))
        if b is not None:
            self.put(tkey + ".bias", b)

    def ln(self, tkey, fpath):
        w = self.get(fpath + ("scale",))
        if w is None:
            return
        self.put(tkey + ".weight", w)
        self.bias(tkey, fpath)

    def bn(self, tkey, fpath):
        self.ln(tkey, fpath)
        rm = self.get(fpath + ("mean",), stats=True)
        rv = self.get(fpath + ("var",), stats=True)
        if rm is not None:
            self.put(tkey + ".running_mean", rm)
        if rv is not None:
            self.put(tkey + ".running_var", rv)
        if rm is not None or rv is not None:
            self.put(tkey + ".num_batches_tracked", np.zeros((), np.int64))

    def raw(self, tkey, fpath, leaf="kernel", name="kernel"):
        """A leaf as it is (a Minkowski, torchsparse or ocnn kernel), and
        the bias beside it."""
        w = self.get(fpath + (leaf,))
        if w is None:
            return
        self.put(f"{tkey}.{name}", w)
        self.bias(tkey, fpath)

    def conv(self, tkey, fpath):
        """[K3, Cin, Cout] -> spconv's [k, k, k, Cin, Cout]; a Dense kernel
        [Cin, Cout] (a 1x1 conv) -> [1, 1, 1, Cin, Cout]."""
        w = self.get(fpath + ("kernel",))
        if w is None:
            return
        if w.ndim == 2:
            w = w[None]
        k3, cin, cout = w.shape
        k = round(k3 ** (1 / 3))
        if k ** 3 != k3:
            raise ValueError(f"non-cubic conv kernel {w.shape}")
        self.put(tkey + ".weight", w.reshape(k, k, k, cin, cout))
        self.bias(tkey, fpath)


def _backbone_state(bb_params, bb_stats, backbone_prefix: str,
                    pdnorm_decouple: bool = True,
                    kp_sigma_radius: float = 0.02) -> Dict[str, np.ndarray]:
    """One backbone's (PTv3's or SpUNet's) flax params and batch stats ->
    its state dict entries under ``backbone_prefix``."""
    out: Dict[str, np.ndarray] = {}
    w = _Writer(out, bb_params, bb_stats, backbone_prefix)
    if "embed0_kpconv" in bb_params or "embed0_bn" in bb_stats:
        _stratified_state(w, kp_sigma_radius)
        return out
    if "conv_input" in bb_params or "norm_input" in bb_stats:
        _spunet_state(w, pdnorm_decouple)
        return out
    names = set(bb_params) | set(bb_stats)
    for key, writer in (("bn0", _mink_state), ("point_transform0_norm", _spvcnn_state),
                        ("stem0_norm", _oacnns_state), ("embed_proj_norm", _octformer_state)):
        if key in names:
            writer(w)
            return out
    if "patch_embed_proj" in bb_params or "patch_embed_norm" in bb_stats:
        _ptv2_state(w, pdnorm_decouple)
        return out
    # PTv1: Seg's head stage ``dec5_up``, Cls's third linear or second
    # BatchNorm (a PT-v3m1 tree has ``enc{s}_down`` too, and ``embedding``)
    if {"dec5_up", "cls_fc3", "cls_bn2"} & (set(bb_params) | set(bb_stats)):
        _ptv1_state(w)
        return out

    def put_norm(tkey, fpath, bn):
        """A LayerNorm (a BatchNorm with ``bn``), or the PDNorm at its place:
        flax ``norm{c}`` -> ``norm.{c}`` (``norm`` undecoupled) and its
        ``modulation`` -> ``modulation.1``."""
        node = w.node(fpath)
        if not node:
            return
        if {"scale", "mean"} & set(node):
            (w.bn if bn else w.ln)(tkey, fpath)
            return
        for key in sorted((k for k in node if re.fullmatch(r"norm\d+", k)),
                          key=lambda k: int(k[4:])):
            sub = f"{tkey}.norm.{key[4:]}" if pdnorm_decouple else f"{tkey}.norm"
            (w.bn if bn else w.ln)(sub, fpath + (key,))
        w.dense(f"{tkey}.modulation.1", fpath + ("modulation",))

    w.conv("embedding.stem.conv", ("embedding", "conv"))
    put_norm("embedding.stem.norm", ("embedding", "norm"), bn=True)
    for name in sorted(bb_params):
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            side, s, i = m.groups()
            t = f"{side}.{side}{s}.block{i}"
            w.conv(f"{t}.cpe.0", (name, "cpe_conv"))
            w.dense(f"{t}.cpe.1", (name, "cpe_linear"))
            put_norm(f"{t}.cpe.2", (name, "cpe_norm"), bn=False)
            put_norm(f"{t}.norm1.0", (name, "norm1"), bn=False)
            put_norm(f"{t}.norm2.0", (name, "norm2"), bn=False)
            w.dense(f"{t}.attn.qkv", (name, "attn", "qkv"))
            w.dense(f"{t}.attn.proj", (name, "attn", "proj"))
            rpe = w.get((name, "attn", "rpe_table"))
            if rpe is not None:
                w.put(f"{t}.attn.rpe.rpe_table", rpe)
            w.dense(f"{t}.mlp.0.fc1", (name, "mlp", "fc1"))
            w.dense(f"{t}.mlp.0.fc2", (name, "mlp", "fc2"))
            continue
        m = re.fullmatch(r"enc(\d+)_down", name)
        if m:
            s = m.group(1)
            w.dense(f"enc.enc{s}.down.proj", (name, "proj"))
            put_norm(f"enc.enc{s}.down.norm.0", (name, "norm"), bn=True)
            continue
        m = re.fullmatch(r"dec(\d+)_up", name)
        if m:
            s = m.group(1)
            w.dense(f"dec.dec{s}.up.proj.0", (name, "proj"))
            put_norm(f"dec.dec{s}.up.proj.1", (name, "proj_norm"), bn=True)
            w.dense(f"dec.dec{s}.up.proj_skip.0", (name, "proj_skip"))
            put_norm(f"dec.dec{s}.up.proj_skip.1", (name, "proj_skip_norm"), bn=True)
    mask_token = w.get(("mask_token",))
    if mask_token is not None:
        w.put("mask_token", mask_token.reshape(1, -1))
    return out


def _spunet_state(w: _Writer, pdnorm_decouple: bool = True) -> None:
    """A SpUNet's leaves in the reference's names: v1m1's (the JAX
    package's ``export_spunet_checkpoint``: ``conv_input.{0,1}``,
    ``down.{s}.{0,1}``, ``up.{s}.{0,1}``, blocks' ``proj.{0,1}``), or with
    PDNorm (v1m3, the inverse of ``convert_spunet_v1m3_checkpoint``)
    ``{conv,bn}`` wrappers, ``proj_conv``/``proj_norm`` and each norm's
    ``bns.{c}`` (``bn`` undecoupled) and ``modulation.1``."""
    pd = "pdnorm" in w.node(("norm_input",))
    conv, norm = ("conv", "bn") if pd else ("0", "1")

    def put_norm(tkey, fpath):
        """A CondBatchNorm: flax ``norm``, or ``pdnorm`` with ``norm{c}``
        and ``modulation``."""
        if not pd:
            w.bn(tkey, fpath + ("norm",))
            return
        base = fpath + ("pdnorm",)
        for key in sorted((k for k in w.node(base) if re.fullmatch(r"norm\d+", k)),
                          key=lambda k: int(k[4:])):
            w.bn(f"{tkey}.bns.{key[4:]}" if pdnorm_decouple else f"{tkey}.bn", base + (key,))
        w.dense(f"{tkey}.modulation.1", base + ("modulation",))

    w.conv(f"conv_input.{conv}", ("conv_input",))
    put_norm(f"conv_input.{norm}", ("norm_input",))
    w.conv("final", ("final",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"(down|up)(\d+)", name)
        if m:
            side, s = m.groups()
            w.conv(f"{side}.{s}.{conv}", (name,))
            put_norm(f"{side}.{s}.{norm}", (f"{name}_norm",))
            continue
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            t = "{}.{}.block{}".format(*m.groups())
            w.conv(f"{t}.conv1", (name, "conv1"))
            w.conv(f"{t}.conv2", (name, "conv2"))
            put_norm(f"{t}.bn1", (name, "bn1"))
            put_norm(f"{t}.bn2", (name, "bn2"))
            w.conv(f"{t}.proj_conv" if pd else f"{t}.proj.0", (name, "proj"))
            put_norm(f"{t}.proj_norm" if pd else f"{t}.proj.1", (name, "proj_norm"))


def _ptv2_state(w: _Writer, pdnorm_decouple: bool = True) -> None:
    """A PTv2's leaves in point_transformer_v2m2_base.py's names."""

    def put_norm(tkey, fpath):
        """A PointBN (flax ``norm``) as ``.norm``, or its PDNorm (flax
        ``pdnorm``: ``norm{c}``, ``modulation``)."""
        node = w.node(fpath)
        if "norm" in node:
            w.bn(f"{tkey}.norm", fpath + ("norm",))
            return
        base = fpath + ("pdnorm",)
        for key in sorted((k for k in w.node(base) if re.fullmatch(r"norm\d+", k)),
                          key=lambda k: int(k[4:])):
            w.bn(f"{tkey}.norm.{key[4:]}" if pdnorm_decouple else f"{tkey}.norm", base + (key,))
        w.dense(f"{tkey}.modulation.1", base + ("modulation",))

    def put_block(t, f):
        w.dense(f"{t}.fc1", f + ("fc1",))
        w.dense(f"{t}.fc3", f + ("fc3",))
        for j in (1, 2, 3):
            put_norm(f"{t}.norm{j}", f + (f"norm{j}",))
        a, fa = f"{t}.attn", f + ("attn",)
        for x in ("q", "k"):
            w.dense(f"{a}.linear_{x}.0", fa + (f"linear_{x}",))
            put_norm(f"{a}.linear_{x}.1", fa + (f"bn_{x}",))
        w.dense(f"{a}.linear_v", fa + ("linear_v",))
        for name, flax in (("linear_p_bias", "pe_bias"), ("linear_p_multiplier", "pe_mul")):
            w.dense(f"{a}.{name}.0", fa + (f"{flax}_fc1",))
            put_norm(f"{a}.{name}.1", fa + (f"{flax}_bn",))
            w.dense(f"{a}.{name}.3", fa + (f"{flax}_fc2",))
        grouped = w.get(fa + ("grouped_weight",))
        if grouped is not None:
            w.put(f"{a}.weight_encoding.0.weight", grouped)
        w.dense(f"{a}.weight_encoding.0", fa + ("weight_fc1",))
        put_norm(f"{a}.weight_encoding.1", fa + ("weight_bn",))
        w.dense(f"{a}.weight_encoding.3", fa + ("weight_fc2",))

    w.dense("patch_embed.proj.0", ("patch_embed_proj",))
    put_norm("patch_embed.proj.1", ("patch_embed_norm",))
    w.dense("seg_head.0", ("seg_head_fc1",))
    put_norm("seg_head.1", ("seg_head_norm",))
    w.dense("seg_head.3", ("seg_head_fc2",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"(patch_embed|enc\d+|dec\d+)_blocks", name)
        if m:
            side = m.group(1)
            t = ("patch_embed" if side == "patch_embed"
                 else f"{side[:3]}_stages.{side[3:]}") + ".blocks.blocks"
            for bname in w.node((name,)):
                put_block(f"{t}.{bname[5:]}", (name, bname))
            continue
        m = re.fullmatch(r"enc(\d+)_down", name)
        if m:
            t = f"enc_stages.{m.group(1)}.down"
            w.dense(f"{t}.fc", (name, "fc"))
            put_norm(f"{t}.norm", (name, "norm"))
            continue
        m = re.fullmatch(r"dec(\d+)_up", name)
        if m:
            t = f"dec_stages.{m.group(1)}.up"
            for key in ("proj", "proj_skip"):
                w.dense(f"{t}.{key}.0", (name, key))
                put_norm(f"{t}.{key}.1", (name, f"{key}_norm"))


def _ptv1_state(w: _Writer) -> None:
    """A PTv1's leaves in point_transformer_seg.py's (or _cls.py's) names;
    a flax PointBN's BatchNorm is its ``norm``."""
    cls = "cls_fc3" in w.params or "cls_bn2" in w.stats

    def bn(tkey, fpath):
        w.bn(tkey, fpath + ("norm",))

    def put_bottleneck(t, f):
        w.dense(f"{t}.linear1", f + ("linear1",))
        w.dense(f"{t}.linear3", f + ("linear3",))
        for j in (1, 2, 3):
            bn(f"{t}.bn{j}", f + (f"bn{j}",))
        a, fa = f"{t}.transformer", f + ("transformer",)
        for name in ("linear_q", "linear_k", "linear_v"):
            w.dense(f"{a}.{name}", fa + (name,))
        w.dense(f"{a}.linear_p.0", fa + ("linear_p_fc1",))
        bn(f"{a}.linear_p.1", fa + ("linear_p_bn",))
        w.dense(f"{a}.linear_p.3", fa + ("linear_p_fc2",))
        bn(f"{a}.linear_w.0", fa + ("linear_w_bn1",))
        w.dense(f"{a}.linear_w.2", fa + ("linear_w_fc1",))
        bn(f"{a}.linear_w.3", fa + ("linear_w_bn2",))
        w.dense(f"{a}.linear_w.5", fa + ("linear_w_fc2",))

    if cls:
        for i, (fc, norm) in enumerate((("cls_fc1", "cls_bn1"), ("cls_fc2", "cls_bn2"))):
            w.dense(f"cls.{4 * i}", (fc,))
            w.bn(f"cls.{4 * i + 1}", (norm,))
        w.dense("cls.8", ("cls_fc3",))
    else:
        w.dense("cls.0", ("cls_fc1",))
        bn("cls.1", ("cls_bn",))
        w.dense("cls.3", ("cls_fc2",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"enc(\d+)_down", name)
        if m:
            w.dense(f"enc{m.group(1)}.0.linear", (name, "linear"))
            bn(f"enc{m.group(1)}.0.bn", (name, "bn"))
            continue
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            side, s, i = m.group(1), m.group(2), int(m.group(3))
            put_bottleneck(f"{side}{s}.{i if cls else i + 1}", (name,))
            continue
        m = re.fullmatch(r"dec(\d+)_up", name)
        if m:
            t = f"dec{m.group(1)}.0"
            w.dense(f"{t}.linear1.0", (name, "linear1"))
            bn(f"{t}.linear1.1", (name, "bn1"))
            w.dense(f"{t}.linear2.0", (name, "linear2"))
            bn(f"{t}.linear2.1", (name, "bn2"))
            w.dense(f"{t}.linear3.0", (name, "linear3"))


def _mink_state(w: _Writer) -> None:
    """A MinkUNet's leaves in MinkowskiEngine's names (the inverse of
    ``convert_mink_checkpoint``)."""

    def bn(tkey, fpath):
        w.bn(tkey + ".bn", fpath)

    w.raw("conv0p1s1", ("conv0",))
    bn("bn0", ("bn0",))
    w.raw("final", ("final",))
    for s in range(1, 5):
        w.raw(f"conv{s}p{2 ** (s - 1)}s2", (f"conv{s}_down",))
        bn(f"bn{s}", (f"bn{s}",))
    for j in range(4, 8):
        w.raw(f"convtr{j}p{2 ** (8 - j)}s2", (f"convtr{j}",))
        bn(f"bntr{j}", (f"bntr{j}",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"(enc|dec)(\d+)_block(\d+)", name)
        if m:
            side, s, i = m.group(1), int(m.group(2)), m.group(3)
            t = f"block{s if side == 'enc' else s + 1}.{i}"
            for j in (1, 2, 3):
                w.raw(f"{t}.conv{j}", (name, f"conv{j}"))
                bn(f"{t}.norm{j}", (name, f"norm{j}"))
            w.raw(f"{t}.downsample.0", (name, "downsample"))
            bn(f"{t}.downsample.1", (name, "downsample_norm"))


def _spvcnn_state(w: _Writer) -> None:
    """An SPVCNN's leaves in ts_spvcnn.py's names (the inverse of
    ``convert_spvcnn_checkpoint``)."""

    def res_block(t, f):
        w.raw(f"{t}.net.0", f + ("conv1",))
        w.bn(f"{t}.net.1", f + ("norm1",))
        w.raw(f"{t}.net.3", f + ("conv2",))
        w.bn(f"{t}.net.4", f + ("norm2",))
        w.raw(f"{t}.downsample.0", f + ("downsample",))
        w.bn(f"{t}.downsample.1", f + ("downsample_norm",))

    for i in range(2):
        w.raw(f"stem.{3 * i}", (f"stem{i}", "conv"))
        w.bn(f"stem.{3 * i + 1}", (f"stem{i}", "norm"))
    w.dense("classifier.0", ("classifier",))
    for t in range(3):
        w.dense(f"point_transforms.{t}.0", (f"point_transform{t}_fc",))
        w.bn(f"point_transforms.{t}.1", (f"point_transform{t}_norm",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"(stage|up)(\d+)_(down|deconv)", name)
        if m:
            t = f"{m.group(1)}{m.group(2)}.0.net"
            w.raw(f"{t}.0", (name,))
            w.bn(f"{t}.1", (f"{name}_norm",))
            continue
        m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if m:
            res_block(f"stage{m.group(1)}.{int(m.group(2)) + 1}", (name,))
            continue
        m = re.fullmatch(r"up(\d+)_block(\d+)", name)
        if m:
            res_block(f"up{m.group(1)}.1.{m.group(2)}", (name,))


def _oacnns_state(w: _Writer) -> None:
    """An OACNNs' leaves in oacnns_v1m1_base.py's names (the inverse of
    ``convert_oacnns_checkpoint``)."""

    def lin_bn(t, f):
        w.dense(f"{t}.0", f + ("fc",))
        w.bn(f"{t}.1", f + ("norm",))

    for i in range(3):
        w.conv(f"stem.{3 * i}", (f"stem{i}",))
        w.bn(f"stem.{3 * i + 1}", (f"stem{i}_norm",))
    w.conv("final", ("final",))
    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"enc(\d+)_down", name)
        if m:
            w.conv(f"enc.{m.group(1)}.down.0", (name,))
            w.bn(f"enc.{m.group(1)}.down.1", (f"{name}_norm",))
            continue
        m = re.fullmatch(r"enc(\d+)_block(\d+)", name)
        if m:
            t, f = f"enc.{m.group(1)}.blocks.{m.group(2)}", (name,)
            scales = sorted(int(k[3:]) for k in w.node(f) if re.fullmatch(r"l_w\d+", k))
            for j in scales:
                lin_bn(f"{t}.l_w.{j}", f + (f"l_w{j}",))
                w.dense(f"{t}.weight.{j}", f + (f"weight{j}",))
                lin_bn(f"{t}.proj.{j}", f + (f"proj{j}",))
            lin_bn(f"{t}.proj.{len(scales)}", f + ("proj_last",))
            w.dense(f"{t}.adaptive", f + ("adaptive",))
            lin_bn(f"{t}.fuse", f + ("fuse",))
            w.conv(f"{t}.voxel_block.0", f + ("vconv1",))
            w.bn(f"{t}.voxel_block.1", f + ("vnorm1",))
            w.conv(f"{t}.voxel_block.3", f + ("vconv2",))
            w.bn(f"{t}.voxel_block.4", f + ("vnorm2",))
            continue
        m = re.fullmatch(r"dec(\d+)_up", name)
        if m:
            s = m.group(1)
            w.conv(f"dec.{s}.up.0", (name,))
            w.bn(f"dec.{s}.up.1", (f"{name}_norm",))
            lin_bn(f"dec.{s}.fuse", (f"dec{s}_fuse1",))
            w.dense(f"dec.{s}.fuse.3", (f"dec{s}_fuse2_fc",))
            w.bn(f"dec.{s}.fuse.4", (f"dec{s}_fuse2_norm",))


def _octformer_state(w: _Writer) -> None:
    """An OctFormer-v1m1's leaves in octformer_v1m1_base.py's names (the
    inverse of ``convert_octformer_checkpoint``)."""

    def conv_bn(t, conv, norm, bn="bn"):
        w.raw(f"{t}.conv", (conv,), name="weights")
        w.bn(f"{t}.{bn}", (norm,))

    for name in sorted(set(w.params) | set(w.stats)):
        m = re.fullmatch(r"embed(\d+)_conv", name)
        if m:
            i = m.group(1)
            conv_bn(f"patch_embed.convs.{i}", name, f"embed{i}_norm")
            conv_bn(f"patch_embed.downsamples.{i}", f"embed{i}_down_conv",
                    f"embed{i}_down_norm")
            continue
        m = re.fullmatch(r"stage(\d+)_block(\d+)", name)
        if m:
            t, f = "layers.{}.blocks.{}".format(*m.groups()), (name,)
            cpe = w.get(f + ("cpe_weight",))
            if cpe is not None:
                w.put(f"{t}.cpe.conv.weights", cpe)
            w.bn(f"{t}.cpe.bn", f + ("cpe_norm",))
            w.ln(f"{t}.norm1", f + ("norm1",))
            w.dense(f"{t}.attention.qkv", f + ("attention", "qkv"))
            w.dense(f"{t}.attention.proj", f + ("attention", "proj"))
            rpe = w.get(f + ("attention", "rpe_table"))
            if rpe is not None:
                w.put(f"{t}.attention.rpe.rpe_table", rpe)
            w.ln(f"{t}.norm2", f + ("norm2",))
            w.dense(f"{t}.mlp.fc1", f + ("mlp_fc1",))
            w.dense(f"{t}.mlp.fc2", f + ("mlp_fc2",))
            continue
        m = re.fullmatch(r"down(\d+)_conv", name)
        if m:
            conv_bn(f"downsamples.{m.group(1)}", name, f"down{m.group(1)}_norm", bn="norm")
            continue
        m = re.fullmatch(r"fpn_fc(\d+)", name)
        if m:
            w.dense(f"decoder.conv1x1.{m.group(1)}", (name,))
            continue
        m = re.fullmatch(r"fpn_conv(\d+)_conv", name)
        if m:
            conv_bn(f"decoder.conv3x3.{m.group(1)}", name, f"fpn_conv{m.group(1)}_norm")
            continue
        m = re.fullmatch(r"up_conv(\d+)", name)
        if m:
            w.raw(f"decoder.up_conv.{m.group(1)}.conv", (name,), name="weights")
            w.bn(f"decoder.up_conv.{m.group(1)}.bn", (f"{name}_norm",))
    conv_bn("patch_embed.proj", "embed_proj_conv", "embed_proj_norm")
    w.dense("seg_head.0", ("seg_fc1",))
    w.bn("seg_head.1", ("seg_norm",))
    w.dense("seg_head.3", ("seg_fc2",))


def _stratified_state(w: _Writer, kp_sigma_radius: float) -> None:
    """A Stratified Transformer's leaves in the reference's names (the
    inverse of ``convert_stratified_checkpoint``); a flax PointBN's
    BatchNorm is its ``norm``, the reference's FastBatchNorm1d's
    ``batch_norm``."""
    from scenesplat_tpu_torch.models.stratified import kernel_points

    def bn(tkey, fpath):
        w.bn(f"{tkey}.batch_norm", fpath + ("norm",))

    def kpconv(tkey, fpath):
        kernel = w.get(fpath + ("kernel",))
        if kernel is None:
            return
        w.put(f"{tkey}.weight", kernel)
        w.put(f"{tkey}.K_points",
              kernel_points(kernel.shape[0]) * np.float32(kp_sigma_radius))

    kpconv("point_embed.0.kpconv", ("embed0_kpconv",))
    bn("point_embed.0.bn", ("embed0_bn",))
    if "embed1_kpconv" in w.params or "embed1_bn2" in w.stats:
        w.dense("point_embed.1.unary_1.0", ("embed1_unary1",))
        bn("point_embed.1.unary_1.1", ("embed1_bn1",))
        kpconv("point_embed.1.kpconv", ("embed1_kpconv",))
        w.dense("point_embed.1.unary_2.0", ("embed1_unary2",))
        bn("point_embed.1.unary_2.1", ("embed1_bn2",))
        c0 = w.node(("embed1_bn2", "norm")).get("scale", w.node(("embed1_bn2", "norm")).get(
            "mean")).shape[0]
        dead = "point_embed.1.bn.batch_norm"
        for name, value in (("weight", np.ones(c0, np.float32)),
                            ("bias", np.zeros(c0, np.float32)),
                            ("running_mean", np.zeros(c0, np.float32)),
                            ("running_var", np.ones(c0, np.float32)),
                            ("num_batches_tracked", np.zeros((), np.int64))):
            w.put(f"{dead}.{name}", value)
        w.ln("down.norm", ("stem_down_norm",))
        w.dense("down.linear", ("stem_down_fc",))
    layers = sorted({int(m.group(1)) for m in (re.fullmatch(r"layer(\d+)_block\d+", k)
                                               for k in w.params) if m})
    for name in sorted(w.params):
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m:
            t = f"layers.{m.group(1)}.blocks.{m.group(2)}"
            w.ln(f"{t}.norm1", (name, "norm1"))
            w.ln(f"{t}.norm2", (name, "norm2"))
            w.dense(f"{t}.attn.qkv", (name, "attn", "qkv"))
            w.dense(f"{t}.attn.proj", (name, "attn", "proj"))
            for table in ("query", "key", "value"):
                value = w.get((name, "attn", f"relative_pos_{table}_table"))
                if value is not None:
                    w.put(f"{t}.attn.relative_pos_{table}_table", value)
            w.dense(f"{t}.mlp.fc1", (name, "mlp_fc1"))
            w.dense(f"{t}.mlp.fc2", (name, "mlp_fc2"))
            continue
        m = re.fullmatch(r"layer(\d+)_down_(norm|fc)", name)
        if m:
            t = f"layers.{m.group(1)}.down"
            if m.group(2) == "norm":
                w.ln(f"{t}.norm", (name,))
            else:
                w.dense(f"{t}.linear", (name,))
    # up.{j}: j = 0 the deepest transition (flax up{L-2}), the stem's last
    ups = [f"up{li}" for li in reversed(range(len(layers) - 1))]
    if "up_stem_norm1" in w.params:
        ups.append("up_stem")
    for j, f in enumerate(ups):
        w.ln(f"up.{j}.linear1.0", (f"{f}_norm1",))
        w.dense(f"up.{j}.linear1.1", (f"{f}_fc1",))
        w.ln(f"up.{j}.linear2.0", (f"{f}_norm2",))
        w.dense(f"up.{j}.linear2.1", (f"{f}_fc2",))
    w.dense("proj_out", ("proj_out",))
    w.dense("classifier.0", ("cls_fc1",))
    w.bn("classifier.1", ("cls_bn", "norm"))
    w.dense("classifier.3", ("cls_fc2",))


def load_flax_weights(model: torch.nn.Module, params, batch_stats, **kwargs):
    """``state_dict_from_flax`` loaded into ``model`` with strict=True."""
    state = state_dict_from_flax(params, batch_stats, **kwargs)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in state.items()}, strict=True)
    return model
