"""Port parity, PointGroup instance segmentation: PG-v1m1 over a tiny
SpUNet-v1m1 and ``pointgroup_loss`` against the JAX package (weights carried
by ``utils/weights.py``, loaded with strict=True, and back through the JAX
package's ``convert_pointgroup_checkpoint``); the JAX package's loss fault
without ``criteria``; ``InstanceParser`` and the collation of its keys;
``ops/cluster.py:pointgroup_cluster`` against the JAX package's native op;
``proposals_from_predictions`` and the ScanNet AP code; and two tiny epochs
of a PG config through the port's train entry with ``InsSegEvaluator``.

Tolerances: the model's outputs rtol 1e-4 (atol 1e-4 of their scale), the
loss and its terms 1e-5 relative, each gradient tensor 1e-4 relative L2,
the BatchNorm statistics 1e-5 (tests/test_torch_spunet.py); the loss
without criteria against JAX's with cross-entropy 1e-6 relative; the
transforms, the clusters and the proposals' masks and classes exact, the
proposals' scores and the AP tables 1e-6."""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_torch_semseg import SEMSEG, one_torch_thread  # noqa: E402,F401 (fixture)
from tests.test_torch_spunet import (  # noqa: E402
    RTOL,
    STAT_RTOL,
    TINY,
    _check_grads,
    _fill,
    _jax_point,
    _scene,
    _torch_point,
)

NUM_CLASSES = 6
LOSS_RTOL = 1e-5
SEG_IGNORE = (-1, 0, 1)


def _pg_cfg(**extra):
    return dict(type="PG-v1m1", backbone=dict(TINY, type="SpUNet-v1m1", num_classes=0),
                backbone_out_channels=TINY["channels"][-1], semantic_num_classes=NUM_CLASSES,
                semantic_ignore_index=-1, segment_ignore_index=SEG_IGNORE, **extra)


def _targets(s, seed=0):
    """Per-point segment (0..5, some ignored), instance ids (by 8 cm cell,
    -1 on classes 0 and 1 and on ignored points) and each instance's
    centroid (-1 without one), as InstanceParser gives them."""
    rng = np.random.default_rng(seed)
    b, n = s["mask"].shape
    cell = np.floor(s["coord"] / 0.08).astype(np.int64)
    inst = (cell[..., 0] * 64 + cell[..., 1]) * 64 + cell[..., 2]
    seg = (inst % NUM_CLASSES).astype(np.int64)
    seg[(rng.random((b, n)) < 0.05) | ~s["mask"]] = -1
    inst[np.isin(seg, SEG_IGNORE)] = -1
    centroid = np.full((b, n, 3), -1.0, np.float32)
    for r in range(b):
        for i in np.unique(inst[r][inst[r] >= 0]):
            m = inst[r] == i
            centroid[r, m] = s["coord"][r, m].mean(0)
    return seg, inst, centroid


def test_pg_forward_and_loss_match_jax():
    """The train-mode forward (logits, bias), the loss with CE criteria and
    its terms, every gradient and the statistics after the step; the state
    dict goes back through convert_pointgroup_checkpoint unchanged."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria
    from scenesplat_tpu.models.point_group import pointgroup_loss as jloss
    from scenesplat_tpu.utils.ckpt_bridge import convert_pointgroup_checkpoint
    from scenesplat_tpu_torch.engines.train_step import insseg_loss
    from scenesplat_tpu_torch.models import build_criteria, build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights, state_dict_from_flax

    s = _scene(11)
    seg, inst, centroid = _targets(s)
    crit_cfg = [dict(type="CrossEntropyLoss", loss_weight=1.0, ignore_index=-1)]
    model = jbuild(_pg_cfg())
    point = _jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p, train=False), point)
    v = _fill(shapes, np.random.default_rng(12))
    crit = jcriteria(crit_cfg)

    def loss(params):
        (out, bias), upd = model.apply({**v, "params": params}, point, train=True,
                                       mutable=["batch_stats"])
        total, terms = jloss(out.feat, bias, out.coord, jnp.asarray(seg), jnp.asarray(inst),
                             jnp.asarray(centroid), out.mask, criteria=crit)
        return total, (terms, upd["batch_stats"], out.feat, bias)

    (value, (terms, stats, logits, bias)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(v["params"])

    port = load_flax_weights(build_model(_pg_cfg()), v["params"], v["batch_stats"])
    port.train()
    batch = dict(coord=torch.from_numpy(s["coord"]), feat=torch.from_numpy(s["feat"]),
                 grid_coord=torch.from_numpy(s["grid"]).long(), mask=torch.from_numpy(s["mask"]),
                 segment=torch.from_numpy(seg), instance=torch.from_numpy(inst),
                 instance_centroid=torch.from_numpy(centroid))
    out, got_bias = port(_torch_point(s))
    mask = s["mask"][..., None]
    for got, want in ((out.feat, logits), (got_bias, bias)):
        want = np.where(mask, np.asarray(want), 0.0)
        got = np.where(mask, got.detach().numpy(), 0.0)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    from scenesplat_tpu_torch.models.point_group import pointgroup_loss

    _, got_terms = pointgroup_loss(out.feat, got_bias, out.coord, batch["segment"],
                                   batch["instance"], batch["instance_centroid"], out.mask,
                                   build_criteria(crit_cfg))
    for k, w in terms.items():
        assert abs(got_terms[k].item() - float(w)) <= LOSS_RTOL * abs(float(w)), k

    # the step's loss through the task's function, from the loaded weights
    port = load_flax_weights(build_model(_pg_cfg()), v["params"], v["batch_stats"]).train()
    total, _ = insseg_loss(port, build_criteria(crit_cfg), batch)
    assert abs(total.item() - float(value)) <= LOSS_RTOL * abs(float(value))
    total.backward()
    _check_grads(port, grads, backbone_prefix="backbone.", flax_backbone_key="backbone_module")
    want = state_dict_from_flax({}, stats)
    state = port.state_dict()
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")):
            err = np.abs(state[key].numpy() - np.asarray(w)).max() / np.abs(np.asarray(w)).max()
            assert err <= STAT_RTOL, key

    # the inverse of convert_pointgroup_checkpoint
    exported = state_dict_from_flax(v["params"], v["batch_stats"])
    assert {"bias_head.0.weight", "bias_head.1.running_var", "bias_head.3.bias",
            "seg_head.weight", "backbone.conv_input.0.weight"} <= set(exported)
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, back_stats, report = convert_pointgroup_checkpoint(exported, zeros["params"],
                                                             zeros["batch_stats"])
    assert report["unused_torch_keys"] == []
    assert_same_tree((back, back_stats), (v["params"], v["batch_stats"]))


def assert_same_tree(got, want):
    """Two trees of arrays equal leaf for leaf."""
    got_leaves = jax.tree_util.tree_leaves_with_path(got)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        assert np.array_equal(np.asarray(a), np.asarray(b)), jax.tree_util.keystr(path)


def test_jax_loss_without_criteria_is_not_a_scalar():
    """The JAX package's fault (ROADMAP Queue 3): with no ``criteria`` in
    the model config its Criteria returns the logits, which
    ``pointgroup_loss`` adds as the semantic term, so the loss is [B, N, C]
    and jax.grad refuses it. The port's loss without criteria is the
    reference's CE(ignore_index=-1), equal to JAX's loss given that CE."""
    from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria
    from scenesplat_tpu.models.point_group import pointgroup_loss as jloss
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.models.point_group import pointgroup_loss

    s = _scene(13, rows=2)
    seg, inst, centroid = _targets(s, seed=1)
    rng = np.random.default_rng(14)
    b, n = s["mask"].shape
    logits = rng.normal(size=(b, n, NUM_CLASSES)).astype(np.float32)
    bias = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.05
    args = (s["coord"], seg, inst, centroid, s["mask"])
    jargs = tuple(map(jnp.asarray, args))

    total, _ = jloss(jnp.asarray(logits), jnp.asarray(bias), *jargs, criteria=jcriteria(None))
    assert total.shape == (b, n, NUM_CLASSES)
    with pytest.raises(TypeError, match="scalar"):
        jax.grad(lambda x: jloss(x, jnp.asarray(bias), *jargs, criteria=jcriteria(None))[0])(
            jnp.asarray(logits))

    want, _ = jloss(jnp.asarray(logits), jnp.asarray(bias), *jargs, criteria=jcriteria(
        [dict(type="CrossEntropyLoss", ignore_index=-1)]))
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    got, terms = pointgroup_loss(torch.from_numpy(logits), torch.from_numpy(bias), *targs,
                                 criteria=build_criteria(None))
    assert got.dim() == 0
    assert abs(got.item() - float(want)) <= 1e-6 * abs(float(want))
    assert terms["seg_loss"].item() > 0


# ---- data -----------------------------------------------------------------------------

def _raw_sample(seed, n=400):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    segment = rng.integers(-1, 8, n).astype(np.int32)
    instance = rng.integers(-1, 12, n).astype(np.int32) * 3  # not compact
    return dict(coord=coord, segment=segment, instance=instance,
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32))


def test_instance_parser_and_collate_match_jax():
    """The parsed instance, centroid and bbox equal JAX's; collation pads
    ``instance`` with -1 and ``instance_centroid`` with 0 as point arrays
    and drops ``bbox`` (one row an instance), as the JAX collate does, even
    when a sample has as many instances as points."""
    from scenesplat_tpu.data.collate import collate_padded as jcollate
    from scenesplat_tpu.data.transforms import InstanceParser as JParser
    from scenesplat_tpu_torch.data.collate import collate_padded
    from scenesplat_tpu_torch.data.transforms import InstanceParser

    samples = []
    for seed in (1, 2):
        got = InstanceParser(SEG_IGNORE, -1)(_raw_sample(seed))
        want = JParser(SEG_IGNORE, -1)(_raw_sample(seed))
        for key in ("instance", "instance_centroid", "bbox"):
            assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
        samples.append(got)
    batch = collate_padded([dict(x) for x in samples], 512)
    ref = jcollate([dict(x) for x in samples], 512)
    assert "bbox" not in batch and "bbox" not in ref
    for key in ("instance", "instance_centroid"):
        assert batch[key].dtype == ref[key].dtype and np.array_equal(batch[key], ref[key]), key
    assert (batch["instance"][~batch["mask"]] == -1).all()
    # as many instances as points: still not a point array
    one = InstanceParser((-1,), -1)(dict(coord=np.eye(3, dtype=np.float32),
                                         segment=np.array([2, 3, 4], np.int32),
                                         instance=np.array([5, 6, 7], np.int32)))
    assert one["bbox"].shape == (3, 8)
    assert "bbox" not in collate_padded([one, dict(one)], 4, mix_prob=0.0)


def test_grid_sample_carries_instance():
    from scenesplat_tpu_torch.data.transforms import GridSample

    sample = _raw_sample(3)
    out = GridSample(grid_size=0.1, keys=("coord", "segment", "instance"),
                     return_grid_coord=True)(dict(sample))
    assert out["instance"].shape == out["coord"].shape[:1]
    picked = {tuple(c): i for c, i in zip(sample["coord"], sample["instance"])}
    assert all(picked[tuple(c)] == i for c, i in zip(out["coord"], out["instance"]))


# ---- clustering -----------------------------------------------------------------------

def _cluster_case(kind, seed):
    """Centres in voxel units and labels: ``random`` (uniform, 3 labels),
    ``piled`` (piles of 48 to 52 points inside one cell, the sizes around
    min_points = 50, and a 600-point pile), ``mixed`` (piles of two
    interleaved labels, chains across cells, scattered points)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        coord = rng.uniform(0, 12, (1500, 3))
        labels = rng.integers(0, 3, 1500)
    elif kind == "piled":
        parts, labs = [], []
        for i, size in enumerate((48, 49, 50, 51, 52, 600)):
            parts.append(rng.uniform(0, 10, 3) + 0.2 * rng.random((size, 3)))
            labs.append(np.full(size, i % 2))
        coord, labels = np.concatenate(parts), np.concatenate(labs)
    else:
        parts, labs = [], []
        for i in range(8):
            size = int(rng.integers(30, 120))
            parts.append(rng.uniform(0, 8, 3) + 0.6 * rng.random((size, 3)))
            labs.append(rng.integers(0, 2, size))
        t = np.linspace(0, 20, 200)[:, None]
        parts.append(np.concatenate([t, 0.1 * t, np.zeros_like(t)], 1))  # a chain
        labs.append(np.full(200, 1))
        parts.append(rng.uniform(0, 20, (300, 3)))
        labs.append(rng.integers(0, 3, 300))
        coord, labels = np.concatenate(parts), np.concatenate(labs)
    order = rng.permutation(len(coord))
    return coord[order].astype(np.float32), labels[order].astype(np.int32)


@pytest.mark.parametrize("chunk", [1 << 23, 97], ids=["one_chunk", "many_chunks"])
@pytest.mark.parametrize("kind", ["random", "piled", "mixed"])
def test_pointgroup_cluster_equals_native(kind, chunk, monkeypatch):
    """Cluster ids and count equal the JAX package's native op, at min
    points 50 and 1; enumerated in chunks of 97 pairs, the same."""
    from scenesplat_tpu import native
    from scenesplat_tpu_torch.ops import cluster

    monkeypatch.setattr(cluster, "PAIRS_PER_CHUNK", chunk)
    coord, labels = _cluster_case(kind, seed=len(kind))
    for min_points in (50, 1):
        want, n_want = native.pointgroup_cluster(coord, labels, radius=1.5,
                                                 min_points=min_points)
        got, n_got = cluster.pointgroup_cluster(torch.from_numpy(coord),
                                                torch.from_numpy(labels), 1.5, min_points)
        assert n_got == n_want and np.array_equal(got.numpy(), want), (kind, min_points)
    assert n_want > 3


# ---- proposals and AP -----------------------------------------------------------------

def _pred_scene(seed):
    """One scene of instances (classes 2..5, 120 to 300 points each, and
    walls and floor of classes 0 and 1) with noisy logits and biases:
    coord [N, 3], logits [N, C], bias [N, 3], segment [N], instance [N]."""
    rng = np.random.default_rng(seed)
    coords, segs, insts = [rng.uniform(0, 3, (800, 3))], [rng.integers(0, 2, 800)], [
        np.full(800, -1)]
    for i in range(7):
        size = int(rng.integers(120, 300))
        coords.append(rng.uniform(0.2, 2.8, 3) + 0.15 * rng.normal(size=(size, 3)))
        segs.append(np.full(size, 2 + i % 4))
        insts.append(np.full(size, i))
    coord = np.concatenate(coords).astype(np.float32)
    seg, inst = np.concatenate(segs), np.concatenate(insts)
    centroid = coord.copy()
    for i in range(7):
        centroid[inst == i] = coord[inst == i].mean(0)
    logits = (3.0 * np.eye(NUM_CLASSES)[seg] + rng.normal(size=(len(seg), NUM_CLASSES)))
    bias = (centroid - coord) + 0.01 * rng.normal(size=coord.shape)
    return (coord, logits.astype(np.float32), bias.astype(np.float32), seg.astype(np.int32),
            inst.astype(np.int32))


def test_proposals_and_ap_match_jax():
    """Proposals (masks, classes exactly; scores 1e-6) and the AP tables of
    three scenes equal JAX's."""
    from scenesplat_tpu.models.point_group import proposals_from_predictions as jprop
    from scenesplat_tpu.utils import insseg_eval as jeval
    from scenesplat_tpu_torch.models.point_group import proposals_from_predictions
    from scenesplat_tpu_torch.utils import insseg_eval

    names = [str(i) for i in range(NUM_CLASSES)]
    records, jrecords = [], []
    for seed in (21, 22, 23):
        coord, logits, bias, seg, inst = _pred_scene(seed)
        want = jprop(coord, logits, bias, segment_ignore_index=SEG_IGNORE)
        got = proposals_from_predictions(torch.from_numpy(coord), torch.from_numpy(logits),
                                         torch.from_numpy(bias), segment_ignore_index=SEG_IGNORE)
        assert len(want["pred_classes"]) >= 4
        assert np.array_equal(got["pred_masks"], want["pred_masks"])
        assert np.array_equal(got["pred_classes"], want["pred_classes"])
        np.testing.assert_allclose(got["pred_scores"], want["pred_scores"], rtol=1e-6)
        records.append(insseg_eval.associate_instances(
            got["pred_masks"], got["pred_classes"], got["pred_scores"], seg, inst, NUM_CLASSES,
            segment_ignore_index=SEG_IGNORE))
        jrecords.append(jeval.associate_instances(
            want["pred_masks"], want["pred_classes"], want["pred_scores"], seg, inst,
            NUM_CLASSES, segment_ignore_index=SEG_IGNORE))
    got = insseg_eval.evaluate_matches(records, NUM_CLASSES, names, segment_ignore_index=SEG_IGNORE)
    want = jeval.evaluate_matches(jrecords, NUM_CLASSES, names, segment_ignore_index=SEG_IGNORE)
    for key in ("all_ap", "all_ap_50%", "all_ap_25%"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    assert got["all_ap_50%"] > 0.5
    for name, row in want["classes"].items():
        for key, value in row.items():
            np.testing.assert_allclose(got["classes"][name][key], value, rtol=1e-6)


def test_proposals_of_the_ignored_classes_only_are_empty():
    from scenesplat_tpu_torch.models.point_group import proposals_from_predictions

    coord, logits, bias, _, _ = _pred_scene(24)
    logits[:, 2:] = -10.0  # every point wall or floor
    got = proposals_from_predictions(coord, logits, bias, segment_ignore_index=SEG_IGNORE)
    assert got["pred_masks"].shape == (0, len(coord)) and got["pred_scores"].shape == (0,)


# ---- the train entry --------------------------------------------------------------------

def write_insseg_scenes(root, split, count, seed):
    """root/<split>/scene<i>/<asset>.npy: a 0.6 m room at one point a 2 cm
    voxel, a floor (class 1) and a wall (class 0), three solid 12 cm blocks
    (216 points each) of classes 2..5, Gaussian features, normals and
    ``instance`` ids."""
    rng = np.random.default_rng(seed)
    for i in range(count):
        g = np.stack(np.meshgrid(np.arange(30), np.arange(30), indexing="ij"), -1).reshape(-1, 2)
        floor = np.concatenate([g, np.zeros((len(g), 1))], 1)  # z = 0
        wall = np.concatenate([np.zeros((len(g), 1)), g[:, :1], g[:, 1:] + 1], 1)  # x = 0
        parts, segs, insts = [floor, wall], [np.full(900, 1), np.full(900, 0)], [
            np.full(900, 0), np.full(900, 1)]
        cube = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
        for k, corner in enumerate(((3, 3, 1), (15, 6, 1), (8, 18, 1))):
            parts.append(cube + corner)
            segs.append(np.full(216, 2 + int(rng.integers(0, NUM_CLASSES - 2))))
            insts.append(np.full(216, 2 + k))
        grid = np.concatenate(parts)
        keep = np.unique(grid, axis=0, return_index=True)[1]
        grid = grid[keep]
        n = len(grid)
        coord = ((grid + 0.5) * 0.02).astype(np.float32)
        normal = rng.normal(size=(n, 3))
        scene = root / split / f"scene{i:04d}_00"
        scene.mkdir(parents=True)
        for key, value in dict(
                coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                quat=rng.normal(size=(n, 4)).astype(np.float32),
                scale=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                opacity=rng.uniform(0, 1, (n,)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32),
                segment20=np.concatenate(segs)[keep].astype(np.int16),
                instance=np.concatenate(insts)[keep].astype(np.int32)).items():
            np.save(scene / f"{key}.npy", value)


def insseg_config(cfg, backbone=None, backbone_out_channels=96, num_classes=20):
    """The ScanNet-20 semseg file made a PointGroup one, as Pointcept's
    insseg-pointgroup-v1m1-0-spunet-base.py sets it: ``instance`` through
    GridSample and Collect, InstanceParser after NormalizeColor,
    ``instance_centroid`` and ``bbox`` collected, PG-v1m1 over SpUNet-v1m1
    (its published widths unless ``backbone`` says otherwise; 14 input
    channels), SGD with nesterov and PolyLR, and the hooks ending in
    InsSegEvaluator and the saver."""
    def edit(transforms):
        out = []
        for t in transforms:
            t = dict(t)
            if t["type"] == "GridSample":
                t["keys"] = tuple(t["keys"]) + ("instance",)
            if t["type"] == "Collect":
                t["keys"] = tuple(t["keys"]) + ("instance", "instance_centroid", "bbox")
            out.append(t)
            if t["type"] == "NormalizeColor":
                out.append(dict(type="InstanceParser", segment_ignore_index=SEG_IGNORE,
                                instance_ignore_index=-1))
        return out

    cfg.data.train.transform = edit(cfg.data.train.transform)
    cfg.data.val.transform = edit(cfg.data.val.transform)
    cfg.model = dict(
        type="PG-v1m1",
        backbone=backbone or dict(type="SpUNet-v1m1", in_channels=14, num_classes=0,
                                  channels=(32, 64, 128, 256, 256, 128, 96, 96),
                                  layers=(2, 3, 4, 6, 2, 2, 2, 2)),
        backbone_out_channels=backbone_out_channels, semantic_num_classes=num_classes,
        semantic_ignore_index=-1, segment_ignore_index=SEG_IGNORE, instance_ignore_index=-1,
        cluster_thresh=1.5, cluster_closed_points=300, cluster_propose_points=100,
        cluster_min_points=50)
    cfg.optimizer = dict(type="SGD", lr=0.1, momentum=0.9, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="PolyLR")
    cfg.param_dicts = None
    cfg.hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                 dict(type="InformationWriter"),
                 dict(type="InsSegEvaluator", segment_ignore_index=SEG_IGNORE,
                      instance_ignore_index=-1),
                 dict(type="CheckpointSaver", save_freq=None)]
    return cfg


def test_insseg_train_entry_with_evaluator(tmp_path):
    """Two tiny epochs of the PG config through ``python -m
    scenesplat_tpu_torch.train``: finite losses with the reference's CE (the
    config sets no criteria), the evaluator's val/mAP, AP50 and AP25 each
    epoch, AP50 the checkpoint metric, and model_best.pth that loads
    strictly into a fresh PG."""
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.models import build_model

    for split, count, seed in (("train", 2, 31), ("val", 1, 32)):
        write_insseg_scenes(tmp_path / "data", split, count, seed)
    exp = tmp_path / "exp"
    cfg = Config.fromfile(SEMSEG)
    cfg.merge_from_options(dict(save_path=str(exp), epoch=2, eval_epoch=2, batch_size=1,
                                num_worker=2))
    cfg.data.train.data_root = cfg.data.val.data_root = str(tmp_path / "data")
    cfg.data.num_points = 4096
    cfg.data.num_classes = NUM_CLASSES
    tiny = dict(TINY, type="SpUNet-v1m1", in_channels=14, num_classes=0)
    cfg = insseg_config(cfg, backbone=tiny, backbone_out_channels=TINY["channels"][-1],
                        num_classes=NUM_CLASSES)
    cfg.hooks[2]["log_interval"] = 1
    assert "criteria" not in cfg.model
    cfg_file = tmp_path / "tiny_insseg.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0

    with open(exp / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) >= 4 and np.isfinite(losses).all()
    for key in ("val/mAP", "val/AP50", "val/AP25"):
        logged = [r[key] for r in records if key in r]
        assert len(logged) == 2 and all(0.0 <= x <= 1.0 for x in logged), key
    best = exp / "model" / "model_best.pth"
    assert best.exists()
    state = torch.load(best, weights_only=False)["state_dict"]
    fresh = build_model(copy.deepcopy(cfg.model))
    fresh.load_state_dict(state, strict=True)
    with open(exp / "train.log") as f:
        assert "new best AP50" in f.read()
