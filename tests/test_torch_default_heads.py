"""Port parity, the v1 task heads over PT-v2m2: DefaultSegmentor (the
backbone emits the logits), DefaultSegmentorSkip (fc-LN-ReLU twice, then
fc) and DefaultPretrainer (the backbone's features) against the JAX
package's on tests/test_torch_ptv2.py's MINI backbone and cloud, the
weights carried by ``utils/weights.py:state_dict_from_flax`` (prefix
``backbone.``) and loaded with strict=True: the eval forward to 1e-5 of
the output's scale (one JAX jit a head, about 8 s). Then the trainer's
``task`` key: a DefaultSegmentor config with task="semseg" trains through
``python -m scenesplat_tpu_torch.train`` (the semseg file cut to a tiny
PT-v2m2), and without the key it raises, as the port always has for a type
outside its table (the JAX trainer falls back to "lang"); two Trainer
steps of a DefaultSegmentor over a narrow MinkUNet14; and the train and
test entry points over a narrow ST-v1m2."""

import copy
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402

from tests.test_torch_ptv2 import MINI, close, cloud, fill, jax_point, torch_point  # noqa: E402
from tests.test_torch_semseg import _tiny_semseg, gs_root  # noqa: E402,F401
from tests.test_torch_test import one_torch_thread  # noqa: E402,F401

HEADS = {
    "DefaultSegmentor": dict(type="DefaultSegmentor", backbone=dict(MINI, type="PT-v2m2")),
    "DefaultSegmentorSkip": dict(type="DefaultSegmentorSkip", num_classes=6,
                                 backbone_out_channels=MINI["dec_channels"][0],
                                 backbone=dict(MINI, type="PT-v2m2", num_classes=0)),
    "DefaultPretrainer": dict(type="DefaultPretrainer",
                              backbone=dict(MINI, type="PT-v2m2", num_classes=0)),
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_head_matches_jax(head):
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    cfg = HEADS[head]
    s = cloud(1)
    model = jbuild(copy.deepcopy(cfg))
    point = jax_point(s)
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p), point)
    variables = fill(shapes, np.random.default_rng(2))
    want = np.asarray(jax.jit(lambda v: model.apply(v, point).feat)(variables))
    port = load_flax_weights(build_model(copy.deepcopy(cfg)), variables["params"],
                             variables["batch_stats"]).eval()
    assert all(k.startswith("backbone.") for k in port.state_dict()) == (head != "DefaultSegmentorSkip")
    with torch.no_grad():
        got = port(torch_point(s)).feat.numpy()
    keep = s["mask"][..., None]
    close(np.where(keep, got, 0), np.where(keep, want, 0), f"{head} forward")


def _ptv2_semseg(root, save_path, task="semseg"):
    """The semseg file cut as tests/test_torch_semseg.py cuts it, its model
    a DefaultSegmentor over a tiny PT-v2m2 (14 channels in)."""
    from tests.test_torch_semseg import NUM_CLASSES

    cfg = _tiny_semseg(root, save_path)
    cfg.model = dict(type="DefaultSegmentor", criteria=cfg.model.criteria,
                     backbone=dict(MINI, type="PT-v2m2", in_channels=14,
                                   num_classes=NUM_CLASSES, drop_path_rate=0.3))
    if task:
        cfg.task = task
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    return cfg


def test_task_key_trains_a_v1_segmentor(gs_root, tmp_path):  # noqa: F811
    """task="semseg" trains DefaultSegmentor over PT-v2m2 through the entry
    point (finite losses, val mIoU, a checkpoint the model takes strictly);
    without the key the trainer raises."""
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.models import build_model

    exp = tmp_path / "exp"
    cfg = _ptv2_semseg(gs_root, str(exp))
    cfg_file = tmp_path / "ptv2_semseg.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0
    with open(exp / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    losses = [r["loss"] for r in records if "loss" in r]
    assert len(losses) >= 4 and np.isfinite(losses).all()
    assert any("val/mIoU" in r for r in records)
    state = torch.load(exp / "model" / "model_last.pth", weights_only=False)["state_dict"]
    model_cfg = {k: v for k, v in dict(cfg.model).items() if k != "criteria"}
    build_model(model_cfg).load_state_dict(state, strict=True)

    with pytest.raises(NotImplementedError, match="task"):
        build_trainer(_ptv2_semseg(gs_root, str(tmp_path / "none"), task=None), device="cpu")


def test_trainer_takes_two_minkunet_steps(gs_root, tmp_path):  # noqa: F811
    """DefaultSegmentor over a narrow MinkUNet14 with task="semseg": one
    epoch of the port's Trainer on the CPU over the 4 training rooms at
    batch 1 (the file's Mix3D merges them in pairs: two steps), finite
    losses and gradient norms, the BatchNorm statistics moved."""
    from tests.test_torch_semseg import NUM_CLASSES
    from scenesplat_tpu_torch.engines.train import build_trainer

    cfg = _tiny_semseg(gs_root, str(tmp_path / "exp"))
    cfg.merge_from_options(dict(epoch=1, eval_epoch=1, batch_size=1))
    cfg.model = dict(type="DefaultSegmentor", criteria=cfg.model.criteria,
                     backbone=dict(type="MinkUNet14", in_channels=14, out_channels=NUM_CLASSES,
                                   init_dim=8, planes=(8, 16, 16, 16, 16, 16, 8, 8)))
    cfg.task = "semseg"
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    trainer = build_trainer(cfg, device="cpu")
    assert trainer.task == "semseg"
    before = trainer.model.state_dict()["backbone.bn0.bn.running_mean"].clone()
    trainer.train()
    losses = trainer.storage.history("loss").values()
    assert len(losses) == 2 and np.isfinite(losses + trainer.storage.history(
        "grad_norm").values()).all()
    assert not torch.equal(trainer.model.state_dict()["backbone.bn0.bn.running_mean"], before)


def test_semseg_file_trains_and_tests_st(gs_root, tmp_path):  # noqa: F811
    """The semseg file (tests/test_torch_semseg.py's tiny cut) with its
    model a DefaultSegmentor over a narrow ST-v1m2 and task="semseg":
    ``python -m scenesplat_tpu_torch.train`` (finite losses, val mIoU, a
    best checkpoint the model takes strictly), then ``.test`` on it
    (SemSegTester: finite mIoU, a prediction a point)."""
    from tests.test_torch_semseg import NUM_CLASSES
    from tests.test_torch_stratified import SMALL
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.models import build_model

    exp = tmp_path / "exp"
    cfg = _tiny_semseg(gs_root, str(exp))
    cfg.merge_from_options(dict(epoch=1, eval_epoch=1))
    backbone = {k: v for k, v in SMALL.items() if k not in ("type", "in_channels", "num_classes")}
    cfg.model = dict(type="DefaultSegmentor", criteria=cfg.model.criteria,
                     backbone=dict(backbone, type="ST-v1m2", in_channels=14,
                                   num_classes=NUM_CLASSES, drop_path_rate=0.2))
    cfg.task = "semseg"
    cfg.hooks = [h for h in cfg.hooks if h["type"] != "PreciseEvaluator"]
    cfg_file = tmp_path / "st_semseg.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0
    losses = [r["loss"] for r in map(json.loads, open(exp / "metrics.json")) if "loss" in r]
    assert len(losses) >= 2 and np.isfinite(losses).all()
    best = exp / "model" / "model_best.pth"
    state = torch.load(best, weights_only=False)["state_dict"]
    build_model({k: v for k, v in dict(cfg.model).items() if k != "criteria"}).load_state_dict(
        state, strict=True)
    (res,) = test_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                              f"weight={best}", f"test.save_path={tmp_path / 'test'}"])
    assert np.isfinite(res["mIoU"])
    assert all(np.load(p).ndim == 1 for p in (tmp_path / "test").glob("*_pred.npy"))
