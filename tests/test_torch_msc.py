"""Port parity, Masked Scene Contrast's data path and random path:
ContrastiveViewsGenerator and the three transforms of MSC's view pipeline
(RandomColorDrop, HueSaturationTranslation, ShufflePoint) and
collate_two_view bit-equal to the JAX package at one seed; MSC-v1m2's
partitioned InfoNCE (loss, monitors and the gradients of the pair
features) against JAX's; the random path's properties (disjoint masks at
about ``mask_rate``, pairs inside the radius, at most
``matching_max_pair``); and the train entry point on an MSC config.

Two places where the JAX package departs from the reference, each shown
beside what the port does: the JAX MSC refuses the reference's
``view1_mix_prob`` / ``view2_mix_prob`` (the port mixes views, see
tests/test_torch_msc_loss.py), and the JAX transforms leave a view's
``origin_coord`` behind its shuffled points.

MSC-v1m1's full model against JAX is in tests/test_torch_msc_loss.py.
Tolerances: the InfoNCE terms rtol 1e-5 and its feature gradients 1e-5
relative L2 (fp32, no backbone in between)."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_torch_msc_loss import MSC, two_view_batch  # noqa: E402
from tests.test_torch_semseg import SEMSEG, gs_root, one_torch_thread  # noqa: E402,F401

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-5


def _scene(seed, n=400):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(n, 3))
    return dict(coord=rng.uniform(0, 2, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(
                    np.float32))


def _both(cfg, sample, seed):
    """The JAX and the port's transform ``cfg`` on copies of ``sample``,
    each side's generator seeded with ``seed``."""
    out = []
    for tf in (jtf, ttf):
        tf.seed_transforms(seed)
        out.append(tf.TRANSFORMS.build(copy.deepcopy(cfg))(copy.deepcopy(sample)))
    return out


def _assert_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)
        assert np.asarray(got[key]).dtype == np.asarray(value).dtype, key


@pytest.mark.parametrize("cfg", [
    dict(type="RandomColorDrop", p=0.5, color_augment=0.25),
    dict(type="HueSaturationTranslation", hue_max=0.5, saturation_max=0.2),
    dict(type="ShufflePoint"),
], ids=lambda c: c["type"])
def test_view_transforms_match_jax(cfg):
    """Each transform at three seeds (RandomColorDrop both fires and not)."""
    for seed in (1, 2, 3):
        want, got = _both(cfg, _scene(seed), seed)
        _assert_equal(got, want)


VIEW_PIPELINE = [
    dict(type="CenterShift", apply_z=True),
    dict(type="RandomRotate", angle=[-1, 1], axis="z", center=[0, 0, 0], p=1),
    dict(type="RandomScale", scale=[0.9, 1.1]),
    dict(type="RandomFlip", p=0.5),
    dict(type="RandomColorDrop", p=0.5, color_augment=0.0),
    dict(type="HueSaturationTranslation", hue_max=0.5, saturation_max=0.2),
    dict(type="ChromaticTranslation", p=0.95, ratio=0.1),
    dict(type="NormalizeColor"),
]


def test_contrastive_views_generator_matches_jax():
    """Two views of the same scene, view 1's draws first, prefixed keys;
    the views differ from each other."""
    sample = _scene(4)
    sample["origin_coord"] = sample["coord"].copy()
    cfg = dict(type="ContrastiveViewsGenerator",
               view_keys=("coord", "color", "normal", "origin_coord"),
               view_trans_cfg=VIEW_PIPELINE)
    want, got = _both(cfg, sample, 5)
    _assert_equal(got, want)
    assert not np.allclose(got["view1_coord"], got["view2_coord"])
    np.testing.assert_array_equal(got["view1_origin_coord"], sample["coord"])


def test_jax_view_shuffle_leaves_origin_coord_behind():
    """A view pipeline ending in ShufflePoint (as MSC's does): in the port a
    view's origin_coord follows its points; the JAX transform shuffles the
    points and leaves origin_coord in the scene's order, so each point is
    paired with another point's origin."""
    sample = _scene(6)
    sample["origin_coord"] = sample["coord"].copy()
    cfg = dict(type="ContrastiveViewsGenerator", view_keys=("coord", "origin_coord"),
               view_trans_cfg=[dict(type="ShufflePoint")])
    want, got = _both(cfg, sample, 7)
    for view in ("view1", "view2"):
        np.testing.assert_array_equal(got[f"{view}_coord"], want[f"{view}_coord"])
        np.testing.assert_array_equal(got[f"{view}_origin_coord"], got[f"{view}_coord"])
        np.testing.assert_array_equal(want[f"{view}_origin_coord"], sample["coord"])
        assert not np.array_equal(want[f"{view}_origin_coord"], want[f"{view}_coord"])


def test_collate_two_view_matches_jax():
    """Three samples of views of other lengths, one view above the slots
    (randomly cut, the same points on both sides), ``origin_coord`` per
    point and padded like ``coord``; integer keys int32."""
    from scenesplat_tpu.data.collate import collate_two_view as jcollate
    from scenesplat_tpu_torch.data.collate import collate_two_view

    rng = np.random.default_rng(8)
    samples = []
    for n1, n2 in ((100, 90), (140, 120), (60, 130)):
        s = {}
        for view, n in (("view1", n1), ("view2", n2)):
            s[f"{view}_coord"] = rng.normal(size=(n, 3)).astype(np.float32)
            s[f"{view}_origin_coord"] = rng.normal(size=(n, 3)).astype(np.float32)
            s[f"{view}_grid_coord"] = rng.integers(0, 50, (n, 3))
            s[f"{view}_feat"] = rng.normal(size=(n, 6)).astype(np.float64)
        samples.append(s)
    jtf.seed_transforms(9)
    want = jcollate(copy.deepcopy(samples), 128)
    ttf.seed_transforms(9)
    got = collate_two_view(copy.deepcopy(samples), 128)
    _assert_equal(got, want)
    assert got["view1_mask"].sum() == 100 + 128 + 60
    assert got["view2_grid_coord"].dtype == np.int32


# ---- MSC-v1m2's InfoNCE -------------------------------------------------------

def test_csc_contrastive_matches_jax():
    """MSC-v1m2's partitioned InfoNCE on fixed features, origin coordinates
    and pairs (some invalid, most of one scene's): the loss, both
    monitors and the gradients of both views' features."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu_torch.models import build_model

    batch = two_view_batch(2)
    batch["match_valid"][batch["match_scene"] == 1] &= np.arange(len(batch["match_valid"]))[
        batch["match_scene"] == 1] % 3 == 0
    rng = np.random.default_rng(10)
    f1, f2 = (rng.normal(size=batch[f"view{v}_mask"].shape + (8,)).astype(np.float32)
              for v in (1, 2))
    cfg = dict(MSC, type="MSC-v1m2", partitions=4, r1=0.1, r2=0.5)
    args = [batch[k] for k in ("view1_origin_coord", "view2_origin_coord", "match_scene",
                               "match_i1", "match_i2", "match_valid")]

    jmodel = jbuild(copy.deepcopy(cfg))
    jargs = [jnp.asarray(a) for a in args]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(f1), jnp.asarray(f2), *jargs,
                            method=jmodel._contrastive)

    def jloss(a, b):
        loss, pos, neg = jmodel.apply(variables, a, b, *jargs, method=jmodel._contrastive)
        return loss, (pos, neg)

    (want, (pos, neg)), grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(f1), jnp.asarray(f2))

    model = build_model(copy.deepcopy(cfg))
    t1, t2 = (torch.from_numpy(f).requires_grad_() for f in (f1, f2))
    targs = [torch.from_numpy(a) for a in args]
    loss, tpos, tneg = model._contrastive(t1, t2, *targs)
    loss.backward()
    for got, ref in ((loss, want), (tpos, pos), (tneg, neg)):
        assert abs(got.item() - float(ref)) <= LOSS_RTOL * abs(float(ref))
    for got, ref in ((t1.grad, grads[0]), (t2.grad, grads[1])):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.numpy() - ref) <= GRAD_RTOL * np.linalg.norm(ref)


# ---- the random path ----------------------------------------------------------------

def _shared_views(seed, n=(400, 350), slots=420):
    """Two views whose rows hold the same points in the same order (equal
    origin coordinates, coordinates moved by 1 cm)."""
    batch = two_view_batch(seed, n=n, slots=slots)
    for key in ("origin_coord", "grid_coord", "mask", "feat", "color", "normal"):
        batch[f"view2_{key}"] = batch[f"view1_{key}"].copy()
    rng = np.random.default_rng(seed)
    batch["view2_coord"] = (batch["view1_coord"] + rng.normal(
        0, 0.01, batch["view1_coord"].shape)).astype(np.float32)
    return {k: v for k, v in batch.items() if not k.startswith(("match_", "view1_point",
                                                                "view2_point"))}


def test_random_masks_and_pairs():
    """The draws of one step: a point masked in view 1 is never masked in
    view 2 (its patch has one tag), each view's share near ``mask_rate``,
    every valid pair's origins closer than the radius and in one scene, at
    most ``matching_max_pair`` pairs, all of them here (every point has
    its own origin within the radius); the same generator seed draws the
    same step."""
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_msc_loss import torch_batch

    batch = torch_batch(_shared_views(3))
    model = build_model(dict(MSC, type="MSC-v1m1", mask_grid_size=0.1, matching_max_pair=256))
    oc1, m1 = batch["view1_origin_coord"], batch["view1_mask"]
    gen = torch.Generator().manual_seed(4)
    pm1, pm2 = model.generate_cross_masks(oc1, m1, batch["view2_origin_coord"],
                                          batch["view2_mask"], gen)
    assert not (pm1 & pm2).any() and not (pm1 & ~m1).any()
    for pm in (pm1, pm2):
        share = pm.sum().item() / m1.sum().item()
        assert 0.25 < share < 0.55, share
    scene, i1, i2, valid = model.match_contrastive_pair(oc1, m1, batch["view2_origin_coord"],
                                                        batch["view2_mask"], gen)
    assert len(valid) == 256 and valid.all()
    d = (oc1[scene, i1] - batch["view2_origin_coord"][scene, i2]).norm(dim=-1)
    assert (d < MSC["matching_max_radius"]).all() and m1[scene, i1].all()
    assert len(set(zip(scene.tolist(), i1.tolist()))) == 256  # distinct rows
    model.train()
    outs = [model(batch, generator=torch.Generator().manual_seed(5)) for _ in range(2)]
    assert outs[0]["pairs"].item() == 256
    for key, value in outs[0].items():
        assert torch.equal(value, outs[1][key]), key


def test_jax_msc_refuses_view_mix_keys():
    """The reference's MSC takes view1_mix_prob / view2_mix_prob (its
    published file sets 0.8 and 0); the JAX module refuses them, and its
    loader's Mix3D (mix_prob) doubles the samples a batch instead of mixing
    views. The port takes both keys (tests/test_torch_msc_loss.py)."""
    from scenesplat_tpu.data.loader import Loader as JLoader
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu_torch.models import build_model

    cfg = dict(MSC, type="MSC-v1m1", view1_mix_prob=0.8, view2_mix_prob=0)
    with pytest.raises(TypeError, match="view1_mix_prob"):
        jbuild(copy.deepcopy(cfg))
    assert build_model(copy.deepcopy(cfg)).mix_prob == (0.8, 0)
    loader = JLoader(list(range(8)), batch_size=2, num_points=64, mix_prob=0.8,
                     collate_fn=lambda samples: samples)
    assert loader.samples_per_batch == 4


# ---- the entry point ------------------------------------------------------------------

def msc_config(cfg, backbone=None):
    """The ScanNet-20 semseg file made an MSC-v1m1 pretraining config as
    Pointcept's pretrain-msc-v1m1-0-spunet-base.py sets it, as far as the
    GS data allows: the file's train augmentations as each view's
    pipeline (GridSample carrying ``origin_coord``) ending in ShufflePoint,
    colour and normal as the 6 input channels, MSC-v1m1 over SpUNet-v1m1
    (its published widths unless ``backbone`` says otherwise) with the
    published mask, mix, matching and loss settings, SGD (lr 0.1, momentum
    0.8, nesterov) with OneCycleLR, no Mix3D and no evaluator."""
    views = []
    for t in cfg.data.train.transform[:-2]:  # ToTensor and Collect go
        t = dict(t)
        if t["type"] == "GridSample":
            t["keys"] = ("origin_coord", "coord", "color", "normal")
        views.append(t)
    views.append(dict(type="ShufflePoint"))
    keys = ("origin_coord", "grid_coord", "coord", "color", "normal")
    cfg.data.train.transform = [
        dict(type="Copy", keys_dict={"coord": "origin_coord"}),
        dict(type="ContrastiveViewsGenerator",
             view_keys=("coord", "color", "normal", "origin_coord"), view_trans_cfg=views),
        dict(type="ToTensor"),
        dict(type="Collect", keys=tuple(f"view{v}_{k}" for v in (1, 2) for k in keys),
             view1_feat_keys=("view1_color", "view1_normal"),
             view2_feat_keys=("view2_color", "view2_normal"))]
    cfg.model = dict(
        type="MSC-v1m1",
        backbone=backbone or dict(type="SpUNet-v1m1", in_channels=6, num_classes=0,
                                  channels=(32, 64, 128, 256, 256, 128, 96, 96),
                                  layers=(2, 3, 4, 6, 2, 2, 2, 2)),
        backbone_in_channels=6, backbone_out_channels=96, mask_grid_size=0.1, mask_rate=0.4,
        view1_mix_prob=0.8, view2_mix_prob=0, matching_max_k=8, matching_max_radius=0.03,
        matching_max_pair=8192, nce_t=0.4, contrast_weight=1, reconstruct_weight=1,
        reconstruct_color=True, reconstruct_normal=True)
    cfg.mix_prob = 0.0
    cfg.optimizer = dict(type="SGD", lr=0.1, momentum=0.8, weight_decay=0.0001, nesterov=True)
    cfg.scheduler = dict(type="OneCycleLR", max_lr=0.1, pct_start=0.01, anneal_strategy="cos",
                         div_factor=10.0, final_div_factor=10000.0)
    cfg.param_dicts = None
    cfg.hooks = [dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
                 dict(type="InformationWriter"), dict(type="CheckpointSaver", save_freq=None)]
    for key in ("val", "test"):
        cfg.data.pop(key, None)
    cfg.pop("test", None)
    return cfg


def test_msc_train_entry(gs_root, tmp_path):
    """Two tiny epochs of an MSC config through ``python -m
    scenesplat_tpu_torch.train``: one sample a batch row (no Mix3D
    doubling), every loss term in metrics.json each step, and
    model_last.pth that loads strictly into a fresh MSC."""
    import json

    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_msc_loss import BACKBONE

    exp = tmp_path / "exp"
    cfg = Config.fromfile(SEMSEG)
    cfg.merge_from_options(dict(save_path=str(exp), epoch=2, eval_epoch=2, batch_size=2,
                                num_worker=2))
    cfg.data.train.data_root = gs_root
    cfg.data.num_points = 640
    for t in cfg.data.train.transform:
        if t["type"] == "GridSample":
            t["grid_size"] = 0.05
    cfg = msc_config(cfg, backbone=BACKBONE)
    cfg.model.update(backbone_out_channels=8, mask_grid_size=0.2, matching_max_radius=0.1,
                     matching_max_pair=128)
    cfg.hooks[2]["log_interval"] = 1
    cfg_file = tmp_path / "tiny_msc.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0
    with open(exp / "metrics.json") as f:  # a step's line, and again at an epoch's end
        lines = {r["iteration"]: r for r in map(json.loads, f)}
    records = [lines[i] for i in range(4)]  # 4 scenes, batch 2, 2 epochs
    for key in ("loss", "nce_loss", "color_loss", "normal_loss", "pos_sim", "pairs"):
        assert all(np.isfinite(r[key]) for r in records), key
    assert all(r["pairs"] > 0 for r in records)
    state = torch.load(exp / "model" / "model_last.pth", weights_only=False)["state_dict"]
    build_model(dict(cfg.model)).load_state_dict(state, strict=True)


def test_trainers_log_into_their_own_files(tmp_path):
    """Two trainers of one process (as the entry tests of one pytest worker
    start them): each one's log lines reach its own ``train.log``, not the
    file the first one named."""
    from scenesplat_tpu_torch.utils.logger import get_root_logger

    for name in ("first", "second"):
        get_root_logger(log_file=str(tmp_path / name / "train.log")).info(f"{name} trainer")
    assert "second trainer" in (tmp_path / "second" / "train.log").read_text()
    assert "second trainer" not in (tmp_path / "first" / "train.log").read_text()


def test_msc_state_dict_is_the_inverse_of_convert_msc_checkpoint():
    """The reference's names (``mask_token`` [1, Cin], ``color_head``,
    ``normal_head``, ``backbone.*``) load strictly into the port's MSC and
    go back through the JAX package's converter to the same flax
    variables."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu.utils.ckpt_bridge import convert_msc_checkpoint
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_insseg import assert_same_tree
    from tests.test_torch_msc_loss import _fill

    cfg = dict(MSC, type="MSC-v1m1")
    batch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
             for k, v in two_view_batch(4).items()}
    jmodel = jbuild(copy.deepcopy(dict(cfg, knn_tile=64)))
    rngs = {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)}
    shapes = dict(jax.eval_shape(lambda b: jmodel.init(rngs, b, train=False), batch))
    shapes["params"] = dict(shapes["params"])
    v = _fill(shapes, np.random.default_rng(1))
    state = state_dict_from_flax(v["params"], v["batch_stats"])
    assert state["mask_token"].shape == (1, 6) and "color_head.weight" in state
    build_model(copy.deepcopy(cfg)).load_state_dict(
        {k: torch.from_numpy(np.array(x)) for k, x in state.items()}, strict=True)
    zeros = jax.tree_util.tree_map(np.zeros_like, v)
    back, back_stats, report = convert_msc_checkpoint(state, zeros["params"],
                                                      zeros["batch_stats"])
    assert report["unused_torch_keys"] == []
    assert_same_tree((back, back_stats), (v["params"], v["batch_stats"]))
