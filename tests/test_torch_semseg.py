"""Port parity, semantic segmentation: the losses (CrossEntropyLoss,
LovaszLoss), one train step of DefaultSegmentorV2 and the data path of the
shipped semseg config files, each against the JAX package on the same
numpy inputs; the weights travel through
``scenesplat_tpu_torch/utils/weights.py``. Also: every shipped semseg and
lang-pretrain config file builds in the port, ``HoliCityGSDataset`` and
``BeginningEvaluator`` against the JAX package, and the train entry point
on the semseg config file at a tiny size. One train step is in
tests/test_torch_semseg_step.py; the logits, the evaluator and the tester
are in tests/test_torch_semseg_eval.py.

The backbone is tiny (one block a stage, widths 16 and 32) with the semseg
files' 5 stages, 4 curves and ``in_channels = 14``. Tolerances: losses
1e-5 relative and gradients 1e-6 absolute (fp32, other summation orders).
The JAX GridSample takes its numpy path, as in tests/test_torch_test.py."""

import copy
import glob
import importlib.util
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu.models.losses.builder import build_criteria as jcriteria  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402
from scenesplat_tpu_torch.models import build_criteria as tcriteria  # noqa: E402
from scenesplat_tpu_torch.ops import bitonic_sort as tsort  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_full_model_golden import _make_scene  # noqa: E402
from tests.test_torch_model import _numpy_variables  # noqa: E402
from tests.test_torch_test import _assert_same, one_torch_thread  # noqa: E402,F401 (fixture)

SEMSEG = "configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py"
SEMSEG_FILES = (SEMSEG, "configs/scannet/semseg-gs-scannet200-all-w-normal-fixed-xyz.py",
                "configs/scannetpp/semseg-gs-scannetpp-all-w-normal-fixed-xyz.py")
LANG_FILES = tuple(f"configs/{name}-contrastive.py" for name in (
    "concat_dataset/lang-pretrain-concat-gs",
    "concat_dataset/lang-pretrain-concat-scan-ppv2-matt-mcmc-wo-normal",
    "concat_dataset/lang-pretrain-concat-scan-ppv2-mcmc-wo-normal",
    "holicity/lang-pretrain-holicity-mcmc-wo-normal",
    "matterport3d/lang-pretrain-matt-mcmc-wo-normal",
    "scannet/lang-pretrain-scannet-mcmc-wo-normal",
    "scannetpp/lang-pretrain-ppv2-mcmc-wo-normal"))
FEAT_KEYS = ("color", "opacity", "quat", "scale", "normal")
GS_KEYS = ("coord", "color", "opacity", "quat", "scale", "segment", "normal")
NUM_CLASSES = 8
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-6
TINY = dict(
    in_channels=14, order=("z", "z-trans", "hilbert", "hilbert-trans"), stride=(2, 2, 2, 2),
    enc_depths=(1, 1, 1, 1, 1), enc_channels=(16, 16, 32, 32, 32), enc_num_head=(1, 1, 2, 2, 2),
    enc_patch_size=(16,) * 5, dec_depths=(1, 1, 1, 1), dec_channels=(16, 16, 32, 32),
    dec_num_head=(1, 1, 2, 2), dec_patch_size=(16,) * 4, mlp_ratio=2, qkv_bias=True,
    drop_path=0.0, shuffle_orders=True, pre_norm=True, serialization_depth=10,
    stage_capacity=(0.5, 0.25, 0.125, 0.0625))


def _criteria_cfg():
    return copy.deepcopy(Config.fromfile(SEMSEG).model.criteria)


def _pipelines():
    spec = importlib.util.spec_from_file_location("gs_pipelines",
                                                  "configs/_base_/gs_pipelines.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True)
def _jax_numpy_grid_sample(monkeypatch):
    from scenesplat_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


# ---- losses -----------------------------------------------------------------

def _loss_inputs(case, seed=0, b=2, n=600, c=NUM_CLASSES):
    """Logits [b, n, c], labels with ignored points and two absent classes,
    a padding tail. ``ties``: a third of the points share one logit row, so
    their errors tie; ``all_ignored``: the second row is ignored throughout;
    ``none_valid``: nothing is valid."""
    rng = np.random.default_rng(seed)
    pred = (2 * rng.normal(size=(b, n, c))).astype(np.float32)
    target = rng.integers(0, c - 2, (b, n)).astype(np.int32)
    target[rng.random((b, n)) < 0.1] = -1
    mask = np.ones((b, n), bool)
    mask[1, n - 70:] = False
    if case == "ties":
        pred[:, : n // 3] = pred[0, 0]
        pred[:, n // 3: n // 2] = np.round(pred[:, n // 3: n // 2])
    elif case == "all_ignored":
        target[1] = -1
    elif case == "none_valid":
        target[:] = -1
    return pred, target, mask


def _jax_loss(cfg, pred, target, mask):
    crit = jcriteria(cfg)
    val, grad = jax.value_and_grad(
        lambda p: crit(p, jnp.asarray(target), mask=jnp.asarray(mask)))(jnp.asarray(pred))
    return float(val), np.asarray(grad)


def _torch_loss(cfg, pred, target, mask):
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = tcriteria(cfg)(p, torch.from_numpy(target).long(), mask=torch.from_numpy(mask))
    loss.backward()
    return loss.item(), p.grad.numpy()


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(reduction="sum"),
    dict(label_smoothing=0.1),
    dict(weight=[0.5, 1.0, 2.0, 1.5, 1.0, 0.25, 3.0, 1.0]),
    dict(weight=[0.5, 1.0, 2.0, 1.5, 1.0, 0.25, 3.0, 1.0], label_smoothing=0.2),
])
@pytest.mark.parametrize("case", ["plain", "all_ignored"])
def test_cross_entropy_matches_jax(cfg, case):
    pred, target, mask = _loss_inputs(case, seed=1)
    crit = [dict(type="CrossEntropyLoss", loss_weight=0.7, ignore_index=-1, **cfg)]
    ref, ref_grad = _jax_loss(crit, pred, target, mask)
    got, grad = _torch_loss(crit, pred, target, mask)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL)
    assert np.abs(grad[~mask]).max() == 0 and np.abs(grad[target == -1]).max() == 0


@pytest.mark.parametrize("case", ["plain", "ties", "all_ignored", "none_valid"])
def test_lovasz_matches_jax(case):
    """Values and gradients; with ties the stable descending sort must give
    the gradient to the same points as ``jnp.argsort(-errors)``."""
    pred, target, mask = _loss_inputs(case, seed=2)
    crit = [dict(type="LovaszLoss", mode="multiclass", loss_weight=1.3, ignore_index=-1)]
    ref, ref_grad = _jax_loss(crit, pred, target, mask)
    got, grad = _torch_loss(crit, pred, target, mask)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL, atol=1e-7)
    np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL)
    if case == "none_valid":
        assert got == 0.0 and not grad.any()
    else:
        assert got > 0 and np.abs(grad).max() > 1e-4


def test_semseg_criteria_match_jax():
    """The semseg files' own criteria (CE + Lovasz, summed)."""
    pred, target, mask = _loss_inputs("ties", seed=3)
    ref, ref_grad = _jax_loss(_criteria_cfg(), pred, target, mask)
    got, grad = _torch_loss(_criteria_cfg(), pred, target, mask)
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL)


# ---- the model and one train step ---------------------------------------------

def _jax_segmentor(num_classes=NUM_CLASSES, **extra):
    from scenesplat_tpu.models import build_model

    return build_model(dict(type="DefaultSegmentorV2", num_classes=num_classes,
                            backbone_out_channels=TINY["dec_channels"][0],
                            backbone=dict(type="PT-v3m1", **TINY, use_pallas=False, **extra)))


def _torch_segmentor(params, stats, num_classes=NUM_CLASSES, **extra):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    model = build_model(dict(type="DefaultSegmentorV2", num_classes=num_classes,
                             backbone_out_channels=TINY["dec_channels"][0],
                             backbone=dict(type="PT-v3m1", **TINY, **extra)))
    return load_flax_weights(model, params, stats)


@pytest.fixture(scope="module")
def seg_case():
    """A scene whose pooled counts halve exactly at each of the 4 poolings
    (512 points), a padding tail, 14 input channels, labels with ignored
    points and numpy-made weights of the JAX segmentor."""
    from scenesplat_tpu.models import PointBatch

    rng = np.random.default_rng(31)
    coord, grid, _ = _make_scene(rng, n_parents=32, levels=4)
    n, pad = len(grid), 16
    feat = rng.normal(size=(n, TINY["in_channels"])).astype(np.float32)
    coord = np.concatenate([coord, np.zeros((pad, 3), np.float32)])
    grid = np.concatenate([grid, np.zeros((pad, 3), np.int32)])
    feat = np.concatenate([feat, np.zeros((pad, feat.shape[1]), np.float32)])
    mask = np.arange(n + pad) < n
    segment = rng.integers(0, NUM_CLASSES - 2, n + pad).astype(np.int32)
    segment[(rng.random(n + pad) < 0.1) | ~mask] = -1
    point = PointBatch(coord=jnp.asarray(coord)[None], feat=jnp.asarray(feat)[None],
                       grid_coord=jnp.asarray(grid)[None], mask=jnp.asarray(mask)[None])
    model = _jax_segmentor()
    params, stats = _numpy_variables(model, point, rng)
    return dict(coord=coord, grid=grid, feat=feat, mask=mask, segment=segment, point=point,
                model=model, params=params, stats=stats)


def _torch_point(case):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(**{k: torch.from_numpy(case[v])[None] for k, v in (
        ("coord", "coord"), ("feat", "feat"), ("grid_coord", "grid"), ("mask", "mask"))})


# ---- the data path ---------------------------------------------------

@pytest.fixture(scope="module")
def gs_root(tmp_path_factory):
    """root/{train,val}/scene<i>/<asset>.npy in a 1 m cube with normals and
    labels stored as ``segment20`` (ScanNet) and ``segment`` (ScanNet++)."""
    root = tmp_path_factory.mktemp("port_semseg_gs")
    rng = np.random.default_rng(17)
    for split, count in (("train", 4), ("val", 2)):
        for i in range(count):
            scene = root / split / f"scene{i:04d}_00"
            scene.mkdir(parents=True)
            n = int(rng.integers(520, 640))
            coord = rng.uniform(0, 1, (n, 3)).astype(np.float32)
            seg = (np.floor(coord[:, 0] * 3).astype(np.int16) * 2
                   + (coord[:, 2] > 0.5)).clip(0, NUM_CLASSES - 3)
            seg[rng.random(n) < 0.05] = -1
            normal = rng.normal(size=(n, 3))
            assets = dict(
                coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                quat=rng.normal(size=(n, 4)).astype(np.float32),
                scale=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                opacity=rng.uniform(0, 1, (n,)).astype(np.float32),
                normal=(normal / np.linalg.norm(normal, axis=1, keepdims=True)).astype(np.float32),
                segment20=seg, segment=seg)
            for key, value in assets.items():
                np.save(scene / f"{key}.npy", value)
    return str(root)


def _val_cfg(root, dataset="ScanNetGSDataset"):
    transform = _pipelines().semseg_val_transform(GS_KEYS, FEAT_KEYS, grid_size=0.05)
    return dict(type=dataset, split="val", data_root=root, transform=transform,
                test_mode=False)


def _test_data_cfg(root, dataset="ScanNetGSDataset"):
    """The semseg files' test pipeline (1 cm dedup, the 9 test-time
    augmentations) with a 5 cm test voxel."""
    transform, test_cfg = _pipelines().semseg_test_transform_and_cfg(GS_KEYS, FEAT_KEYS)
    test_cfg["voxelize"]["grid_size"] = 0.05
    return dict(type=dataset, split="val", data_root=root, transform=transform,
                test_mode=True, test_cfg=test_cfg)


def test_semseg_data_path_equals_jax(gs_root):
    """The semseg files' train and test pipelines: equal to the JAX
    package's for the same seeds, normals loaded and collected (14
    channels), ``origin_segment`` through the inverse map, and the 9
    test-time augmentations each giving their own fragments that cover
    every point."""
    pipes = _pipelines()
    train = dict(type="ScanNetGSDataset", split="train", data_root=gs_root, test_mode=False,
                 transform=pipes.semseg_train_transform(GS_KEYS, FEAT_KEYS, point_max=400))
    for cfg in (train, _test_data_cfg(gs_root)):
        tds, jds = tdata.build_dataset(copy.deepcopy(cfg)), jdata.build_dataset(copy.deepcopy(cfg))
        for idx in range(2):
            ttf.seed_transforms((0, idx))
            got = tds[idx]
            jtf.seed_transforms((0, idx))
            _assert_same(got, jds[idx])
            raw = tds.get_data(idx)
            assert "normal" in raw and raw["segment"].max() >= 0
            if not cfg["test_mode"]:
                assert got["feat"].shape[1] == 14 and set(got) == {
                    "coord", "grid_coord", "segment", "feat"}
                continue
            n = len(got["segment"])
            np.testing.assert_array_equal(got["origin_segment"], raw["segment"])
            np.testing.assert_array_equal(got["segment"][got["inverse"]], raw["segment"])
            frags = got["fragment_list"]
            assert all(f["feat"].shape[1] == 14 for f in frags)
            # each of the 9 views' fragments cover every point at least once
            covered = np.zeros(n, int)
            for f in frags:
                covered[f["index"]] += 1
            assert covered.min() >= 9 and len(frags) > 9


# ---- building the shipped files, and the tiny train entry -------------------------

@pytest.mark.parametrize("path", SEMSEG_FILES + LANG_FILES)
def test_shipped_config_builds_in_the_port(path):
    """The model (at its shipped widths), criteria, optimizer, schedule,
    datasets with their transforms, hooks, trainer and tester types of
    every shipped semseg and lang-pretrain file build with the port's
    registries (the data roots hold no scenes here)."""
    from scenesplat_tpu_torch.engines.hooks import build_hooks
    from scenesplat_tpu_torch.engines.test import TESTERS
    from scenesplat_tpu_torch.engines.train import TRAINERS, Trainer
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.optimizer import build_optimizer, build_scheduler

    cfg = Config.fromfile(path)
    model_cfg = dict(cfg.model)
    criteria = tcriteria(model_cfg.pop("criteria", None))
    assert model_cfg["type"] in Trainer.TASKS and criteria.criteria
    model = build_model(model_cfg)
    optimizer = build_optimizer(dict(cfg.optimizer), model,
                                param_dicts=[dict(p) for p in cfg.get("param_dicts") or []])
    build_scheduler(cfg.get("scheduler"), optimizer, 100)
    for key in ("train", "val", "test"):
        sets = cfg.data.get(key) or []
        for ds in (sets if isinstance(sets, list) else [sets]):
            tdata.build_dataset(dict(ds))
    assert len(build_hooks(cfg.hooks)) == len(cfg.hooks)
    assert TRAINERS.get(cfg.get("train", {}).get("type", "DefaultTrainer")) is not None
    tests = cfg.get("test") or []
    for test in (tests if isinstance(tests, list) else [tests]):
        assert TESTERS.get(test["type"]) is not None
    if path in SEMSEG_FILES:
        bb = model_cfg["backbone"]
        assert bb["in_channels"] == 14 and len(bb["enc_depths"]) == 5
        assert model.seg_head.weight.shape == (cfg.model.num_classes, 64)


def _tiny_semseg(root, save_path):
    """The ScanNet-20 semseg file with tiny widths and data: its criteria,
    optimizer, schedule, param groups, Mix3D, transforms and hooks kept;
    the validation and test pipelines at a 5 cm voxel."""
    cfg = Config.fromfile(SEMSEG)
    cfg.merge_from_options(dict(save_path=save_path, epoch=2, eval_epoch=2, batch_size=1,
                                num_worker=2, batch_size_val=1, batch_size_test=1))
    cfg.hooks[2]["log_interval"] = 1
    cfg.data.num_points = 1024
    cfg.data.num_classes = cfg.model.num_classes = cfg.test.num_classes = NUM_CLASSES
    cfg.model.backbone.update({k: v for k, v in TINY.items() if k != "drop_path"})
    cfg.model.backbone_out_channels = TINY["dec_channels"][0]
    cfg.data.train.data_root = root
    cfg.data.val = _val_cfg(root)
    cfg.data.test = _test_data_cfg(root)
    for t in cfg.data.train.transform:
        if t["type"] == "SphereCrop":
            t["point_max"] = 500
        if t["type"] == "GridSample":
            t["grid_size"] = 0.05
    return cfg


def test_semseg_train_entry_with_its_hooks(gs_root, tmp_path, monkeypatch):
    """Two tiny epochs of the semseg file with its own hooks: the evaluator
    logs val/mIoU, the saver writes model_best.pth, PreciseEvaluator runs
    the SemSegTester on it, and the test entry point gives the same mIoU
    on that checkpoint."""
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    exp = tmp_path / "exp"
    cfg = _tiny_semseg(gs_root, str(exp))
    assert [h["type"] for h in cfg.hooks] == [
        "CheckpointLoader", "IterationTimer", "InformationWriter", "SemSegEvaluator",
        "CheckpointSaver", "PreciseEvaluator"]
    cfg_file = tmp_path / "tiny_semseg.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0

    with open(exp / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) >= 4 and np.isfinite(losses).all()
    logged = [r["val/mIoU"] for r in records if "val/mIoU" in r]
    assert logged and all(0.0 <= v <= 1.0 for v in logged)
    best = exp / "model" / "model_best.pth"
    assert best.exists() and (exp / "model" / "model_last.pth").exists()
    ckpt = torch.load(best, weights_only=False)
    assert "seg_head.weight" in ckpt["state_dict"]

    (res,) = test_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                              f"weight={best}", f"test.save_path={tmp_path / 'again'}"])
    assert 0.0 <= res["mIoU"] <= 1.0 and res["iou_per_class"].shape == (NUM_CLASSES,)
    assert len(glob.glob(str(tmp_path / "again" / "*_pred.npy"))) == 2


# ---- Queue 1 item 2: HoliCityGSDataset and BeginningEvaluator ----------------------

def test_holicity_dataset_equals_jax(tmp_path):
    """Only HoliCity's assets load (no normal, no instance), standardized as
    the JAX package does."""
    rng = np.random.default_rng(8)
    scene = tmp_path / "train" / "block0"
    scene.mkdir(parents=True)
    n = 300
    for key, value in dict(
            coord=rng.normal(size=(n, 3)), color=rng.uniform(0, 255, (n, 3)),
            quat=rng.normal(size=(n, 4)), scale=rng.uniform(0, 2, (n, 3)),
            opacity=rng.uniform(0, 1, n), segment=rng.integers(-1, 9, n).astype(np.int16),
            normal=rng.normal(size=(n, 3)), instance=rng.integers(0, 4, n),
            lang_feat=rng.normal(size=(n, 8)), valid_feat_mask=rng.random(n) > 0.3).items():
        np.save(scene / f"{key}.npy", value)
    cfg = dict(type="HoliCityGSDataset", split="train", data_root=str(tmp_path), transform=None)
    got = tdata.build_dataset(dict(cfg)).get_data(0)
    ref = jdata.build_dataset(dict(cfg)).get_data(0)
    _assert_same(got, ref)
    assert "normal" not in got and (got["instance"] == -1).all()


def test_beginning_evaluator_matches_jax():
    """Each evaluator hook runs once before training at epoch -1, the others
    not at all, and the epoch is put back; the shipped files' ``test_last``
    builds in the port (the JAX hook takes no argument)."""
    from types import SimpleNamespace

    from scenesplat_tpu.engines.hooks import build_hooks as jhooks
    from scenesplat_tpu.engines.hooks.default import HookBase as JBase
    from scenesplat_tpu_torch.engines.hooks import build_hooks as thooks
    from scenesplat_tpu_torch.engines.hooks.default import HookBase as TBase

    calls = []
    for base, build, kwargs in ((JBase, jhooks, {}), (TBase, thooks, dict(test_last=True))):
        class FakeEvaluator(base):
            def after_epoch(self):
                calls.append((base, "eval", self.trainer.epoch))

        class Other(base):
            def after_epoch(self):
                calls.append((base, "other", self.trainer.epoch))

        trainer = SimpleNamespace(epoch=0, start_epoch=3)
        hooks = [FakeEvaluator(), Other()] + build([dict(type="BeginningEvaluator", **kwargs)])
        trainer.hooks = hooks
        for h in hooks:
            h.trainer = trainer
        for h in hooks:
            h.before_train()
        assert trainer.epoch == 3
    assert calls == [(JBase, "eval", -1), (TBase, "eval", -1)]


def test_beginning_evaluator_refuses_test_last_false():
    """The hook scores the weights the trainer holds (``test_last=True``,
    the default); asking it for model_best.pth raises rather than scoring
    something else."""
    from scenesplat_tpu_torch.engines.hooks import build_hooks

    (hook,) = build_hooks([dict(type="BeginningEvaluator")])
    assert type(hook).__name__ == "BeginningEvaluator"
    with pytest.raises(ValueError, match="test_last"):
        build_hooks([dict(type="BeginningEvaluator", test_last=False)])
