"""Port parity, semantic segmentation at evaluation: DefaultSegmentorV2's
logits and their dtype, the SemSegEvaluator hook and the SemSegTester
(through ``python -m scenesplat_tpu_torch.test``, argmax and the ScanNet++
top-3 protocol) against the JAX package, with the tiny 5-stage backbone,
weights and scenes of tests/test_torch_semseg.py.

Every JAX forward runs through one ``FeatureExtractor`` (bucket 1024), so
the JAX forward compiles once for the whole file. Tolerances: logits
1e-4 / 2e-4 (the model tests' bar); the evaluator's and the tester's
predictions equal on 99.5% of the points and their mIoU within 0.005 (the
zero-shot tester's bar: near-tied logits may flip an argmax)."""

import copy
import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu_torch.ops import bitonic_sort as tsort  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_torch_semseg import (  # noqa: E402,F401 (fixtures)
    NUM_CLASSES,
    TINY,
    _jax_numpy_grid_sample,
    _jax_segmentor,
    _test_data_cfg,
    _torch_point,
    _torch_segmentor,
    one_torch_thread,
    _val_cfg,
    gs_root,
    seg_case,
)

LOGIT_RTOL, LOGIT_ATOL = 1e-4, 2e-4
PRED_AGREEMENT, METRIC_ATOL = 0.995, 0.005
PATCH = max(TINY["enc_patch_size"])


@pytest.fixture(scope="module")
def jax_extractor(seg_case):
    """The JAX FeatureExtractor and variables every JAX forward of this
    file goes through."""
    from scenesplat_tpu.engines.infer import FeatureExtractor

    return (FeatureExtractor(seg_case["model"], patch_size=PATCH),
            {"params": seg_case["params"], "batch_stats": seg_case["stats"]})


def test_segmentor_logits_and_dtype_match_jax(seg_case, jax_extractor):
    from scenesplat_tpu_torch.engines.infer import FeatureExtractor

    case = seg_case
    m = case["mask"]
    sample = dict(coord=case["coord"][m], feat=case["feat"][m], grid_coord=case["grid"][m])
    extractor, variables = jax_extractor
    ref = extractor(variables, sample)
    model = _torch_segmentor(case["params"], case["stats"]).eval()
    got = FeatureExtractor(model, patch_size=PATCH, device="cpu")(sample)
    assert ref.dtype == got.dtype == np.float32 and got.shape == (m.sum(), NUM_CLASSES)
    np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=LOGIT_ATOL)
    with torch.inference_mode():
        out = model(_torch_point(case)).feat
    assert out.dtype == torch.float32 and out.shape == (1, len(m), NUM_CLASSES)

    # a bf16 backbone: flax promotes the head's bf16 input with its fp32
    # parameters, so the logits stay fp32; the port's head computes in fp32
    jbf = _jax_segmentor(dtype="bfloat16")
    shape = jax.eval_shape(lambda v, p: jbf.apply(v, p, train=False).feat, variables,
                           case["point"])
    tbf = _torch_segmentor(case["params"], case["stats"], dtype="bfloat16").eval()
    with torch.inference_mode():
        logits = tbf(_torch_point(case)).feat
    assert shape.dtype == jnp.float32 and logits.dtype == torch.float32
    assert (logits[0, m].argmax(-1).numpy() == ref.argmax(-1)).mean() > 0.9

    # num_classes <= 0: the backbone's features, no head
    jfeat = _jax_segmentor(num_classes=0)
    bb = {k: v for k, v in case["params"].items() if k != "seg_head"}
    shape = jax.eval_shape(lambda v, p: jfeat.apply(v, p, train=False).feat,
                           {"params": bb, "batch_stats": case["stats"]}, case["point"])
    tfeat = _torch_segmentor(bb, case["stats"], num_classes=0).eval()
    assert not any(k.startswith("seg_head") for k in tfeat.state_dict())
    with torch.inference_mode():
        feat = tfeat(_torch_point(case)).feat
    assert tuple(feat.shape) == shape.shape == (1, len(m), TINY["dec_channels"][0])


class _Storage:
    def __init__(self):
        self.scalars = {}

    def put_scalar(self, key, value):
        self.scalars[key] = value


def test_semseg_evaluator_matches_jax(gs_root, seg_case, jax_extractor):
    """Both hooks over the same validation set with the same weights."""
    from scenesplat_tpu.engines.hooks.evaluator import SemSegEvaluator as JEval
    from scenesplat_tpu.utils.config import Config as JConfig
    from scenesplat_tpu_torch.engines.hooks.evaluator import SemSegEvaluator as TEval

    case = seg_case
    cfg = dict(seed=0, model=dict(backbone=dict(TINY)),
               data=dict(num_classes=NUM_CLASSES, val=_val_cfg(gs_root)))
    results = []
    for hook, trainer in (
            (JEval(ignore_index=-1), SimpleNamespace(
                cfg=JConfig(copy.deepcopy(cfg)), model=case["model"],
                state=SimpleNamespace(params=case["params"], batch_stats=case["stats"]))),
            (TEval(ignore_index=-1), SimpleNamespace(
                cfg=Config(copy.deepcopy(cfg)), device=torch.device("cpu"),
                model=_torch_segmentor(case["params"], case["stats"]).train()))):
        trainer.logger, trainer.comm_info, trainer.storage = (
            logging.getLogger("test"), {}, _Storage())
        trainer.epoch = 0
        hook.trainer = trainer
        hook.before_train()
        if isinstance(hook, JEval):
            assert hook.extractor.patch_size == PATCH
            hook.extractor = jax_extractor[0]  # the file's one compile
        hook.after_epoch()
        assert trainer.comm_info["current_metric_name"] == "mIoU"
        assert trainer.storage.scalars["val/mIoU"] == trainer.comm_info["current_metric_value"]
        results.append(trainer.comm_info["current_metric_value"])
    ref, got = results
    assert abs(got - ref) <= METRIC_ATOL and 0 < got < 1, (got, ref)


RUNS = (("argmax", "ScanNetGSDataset"), ("top3", "ScanNetPPGSDataset"))


@pytest.fixture(scope="module")
def tester_run(gs_root, seg_case, jax_extractor, tmp_path_factory):
    """The JAX SemSegTester's scored predictions and metrics (argmax, and
    top-3 on a ScanNet++ dataset), and a config file and checkpoint for the
    port's test entry point from the same weights."""
    from scenesplat_tpu import native
    from scenesplat_tpu.engines import test as jtest
    from scenesplat_tpu.utils import misc as jmisc

    case, out = seg_case, tmp_path_factory.mktemp("semseg_tester")
    real, preds, runs = jmisc.intersection_and_union, [], {}

    def recording(pred, target, *args):
        preds.append(np.array(pred))
        return real(pred, target, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        mp.setattr(jmisc, "intersection_and_union", recording)
        for name, dataset in RUNS:
            preds.clear()
            tester = jtest.build_tester(
                dict(type="SemSegTester", num_classes=NUM_CLASSES, ignore_index=-1),
                case["model"], jax_extractor[1], _test_data_cfg(gs_root, dataset),
                patch_size=PATCH, seed=0)
            tester.extractor = jax_extractor[0]  # the file's one compile
            assert tester.top3 == (name == "top3")
            runs[name] = dict(res=tester.test(), preds=list(preds))

    weight = out / "weights.pth"
    model = _torch_segmentor(case["params"], case["stats"])
    torch.save(dict(state_dict=model.state_dict(), epoch=1), weight)
    model_cfg = dict(type="DefaultSegmentorV2", num_classes=NUM_CLASSES,
                     backbone_out_channels=TINY["dec_channels"][0],
                     backbone=dict(type="PT-v3m1", **TINY))
    for name, dataset in RUNS:
        cfg = Config(dict(seed=0, model=model_cfg,
                          data=dict(test=_test_data_cfg(gs_root, dataset)),
                          test=dict(type="SemSegTester", num_classes=NUM_CLASSES,
                                    ignore_index=-1, save_path=str(out / name))))
        cfg.dump(str(out / f"{name}.py"))
    return dict(out=out, runs=runs, weight=str(weight))


@pytest.mark.parametrize("name", [name for name, _ in RUNS])
def test_semseg_tester_entry_matches_jax(tester_run, name, monkeypatch):
    from scenesplat_tpu_torch import test as entry

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    out, ref = tester_run["out"], tester_run["runs"][name]
    (res,) = entry.main(["--config-file", str(out / f"{name}.py"), "--device", "cpu",
                         "--options", f"weight={tester_run['weight']}"])
    with open(out / name / "scene_log.json") as f:
        scenes = json.load(f)
    got = [np.load(out / name / f"{s['name']}_pred.npy") for s in scenes]
    assert len(got) == len(ref["preds"]) == 2
    for g, r in zip(got, ref["preds"]):
        assert g.shape == r.shape and g.ndim == 1
    same = np.concatenate([g == r for g, r in zip(got, ref["preds"])])
    assert same.mean() >= PRED_AGREEMENT, same.mean()
    assert abs(res["mIoU"] - ref["res"]["mIoU"]) <= METRIC_ATOL, (res["mIoU"],
                                                                  ref["res"]["mIoU"])
    assert res["iou_per_class"].shape == (NUM_CLASSES,) and 0 < res["mIoU"] < 1
    for s in scenes:  # every view's fragments were run
        assert s["fragments"] > 9 and s["extract_s"] > 0 and s["fetch_s"] > 0
