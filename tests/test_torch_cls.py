"""Port parity, classification and part segmentation: PT-v3m1 in
``cls_mode`` under ``DefaultClassifier`` against the JAX package's on the
same numpy rows (the JAX weights carried by
``utils/weights.py:state_dict_from_flax``, strict=True), the feature
extractor on a classifier and on a PartSeg model's ``cls_token``, the
testers ``ClsTester``, ``ClsVotingTester`` and ``PartSegTester`` and the
``ClsEvaluator`` hook fed the same logits as the JAX package's (stub
extractors, as tests/test_testers.py drives the JAX testers), and the two
faults of the JAX extractor on a classifier.

Tolerances: fp32 logits to 1e-4 of their scale (RTOL, the export bridge's
bar); the testers' and the evaluator's records equal. About 25 s alone on
one worker (one jitted JAX classifier of 3 stages at 2 x 256 slots, one of
2 stages, one PTv1 PartSeg26 at 256 points).
"""

import logging
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv, one_torch_thread  # noqa: E402,F401 (fixtures)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import DEEP, MINI, _make_scene  # noqa: E402
from tests.test_torch_model import _numpy_variables  # noqa: E402
from tests.test_torch_ptv2 import close, cloud, fill, port_model  # noqa: E402

RTOL = 1e-4
CLASSES = 40


def _classifier_cfg(backbone, capacity, embed):
    return dict(type="DefaultClassifier", num_classes=CLASSES, backbone_embed_dim=embed,
                backbone=dict(type="PT-v3m1", **backbone, cls_mode=True,
                              stage_capacity=capacity))


def _jax_classifier(cfg):
    from scenesplat_tpu.models import build_model

    cfg = dict(cfg, backbone=dict(cfg["backbone"], use_pallas=False, upcast_softmax=True))
    return build_model(cfg)


def _port_classifier(cfg, params, stats):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    return load_flax_weights(build_model(cfg), params, stats).eval()


def _rows(seeds_parents, levels, n):
    """Rows of _make_scene's exactly halving voxels, each padded to ``n``
    slots: (coord, grid, feat, mask), each [rows, n, ...]."""
    out = []
    for seed, parents in seeds_parents:
        rng = np.random.default_rng(seed)
        coord, grid, feat = _make_scene(rng, n_parents=parents, levels=levels)
        pad = n - len(grid)
        out.append((np.concatenate([coord, np.zeros((pad, 3), np.float32)]),
                    np.concatenate([grid, np.zeros((pad, 3), np.int32)]),
                    np.concatenate([feat, np.zeros((pad, feat.shape[1]), np.float32)]),
                    np.arange(n) < n - pad))
    return [np.stack(x) for x in zip(*out)]


def _jax_batch(coord, grid, feat, mask):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(coord), feat=jnp.asarray(feat),
                      grid_coord=jnp.asarray(grid), mask=jnp.asarray(mask))


def _port_batch(coord, grid, feat, mask):
    from scenesplat_tpu_torch.models import PointBatch

    return PointBatch(coord=torch.from_numpy(coord), feat=torch.from_numpy(feat),
                      grid_coord=torch.from_numpy(grid).long(), mask=torch.from_numpy(mask))


def test_cls_mode_classifier_matches_jax():
    """Two rows of 256 slots (the second 192 points and 64 padding): the
    port's logits [2, 40] equal JAX's; the backbone builds no decoder
    module and its output is the coarsest stage's."""
    cfg = _classifier_cfg(DEEP, (0.5, 0.25), embed=32)
    rows = _rows([(7, 64), (8, 48)], levels=2, n=256)
    model = _jax_classifier(cfg)
    point = _jax_batch(*rows)
    params, stats = _numpy_variables(model, point, np.random.default_rng(3))
    assert not any(k.startswith("dec") for k in params["backbone_module"])
    want = np.asarray(jax.jit(lambda v: model.apply(v, point, train=False))(
        {"params": params, "batch_stats": stats}))
    port = _port_classifier(cfg, params, stats)
    assert not any(".dec." in k or k.startswith("backbone.dec") for k in port.state_dict())
    assert port.backbone.out_channels == DEEP["enc_channels"][-1]
    with torch.inference_mode():
        got = port(_port_batch(*rows))
        out = port.backbone(_port_batch(*rows))
    assert got.shape == want.shape == (2, CLASSES)
    assert got.dtype == torch.float32
    close(got.numpy(), want, "classifier logits", RTOL)
    # two poolings, each halving the rows' points, into capacities of 128, 64
    assert out.feat.shape == (2, 64, DEEP["enc_channels"][-1])
    assert out.mask.sum(1).tolist() == [64, 48]


@pytest.fixture(scope="module")
def small_object():
    """An object of 30 points (fewer than the 40 classes) through a 2-stage
    classifier, padded to the extractor's bucket of 64 slots; the JAX
    model's variables and its logits by ``model.apply``."""
    cfg = _classifier_cfg(MINI, (0.5,), embed=32)
    coord, grid, feat, mask = _rows([(11, 15)], levels=1, n=64)
    model = _jax_classifier(cfg)
    point = _jax_batch(coord, grid, feat, mask)
    params, stats = _numpy_variables(model, point, np.random.default_rng(5))
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax.jit(lambda v: model.apply(v, point, train=False))(variables))[0]
    n = int(mask.sum())
    sample = dict(coord=coord[0, :n], grid_coord=grid[0, :n], feat=feat[0, :n])
    return dict(cfg=cfg, model=model, variables=variables, want=want, sample=sample)


def test_extractor_gives_a_classifiers_whole_logits(small_object):
    from scenesplat_tpu_torch.engines.infer import FeatureExtractor

    o = small_object
    port = _port_classifier(o["cfg"], o["variables"]["params"], o["variables"]["batch_stats"])
    got = FeatureExtractor(port, buckets=[64], device="cpu")(o["sample"])
    assert got.shape == (CLASSES,)
    close(got, o["want"], "extracted logits", RTOL)
    # above chunk_size a classifier's sample is refused: its chunks' logits
    # would be no one object's
    with pytest.raises(ValueError, match="chunk_size"):
        FeatureExtractor(port, buckets=[64], chunk_size=16, device="cpu")(o["sample"])


def test_jax_extractor_raises_on_a_classifier(small_object):
    """The JAX extractor's default ``output_fn`` reads ``out.feat``; a
    DefaultClassifier returns a bare array, so ClsTester and
    ClsVotingTester (whose TesterBase builds the extractor without one)
    cannot run a classifier."""
    from scenesplat_tpu.engines.infer import FeatureExtractor

    o = small_object
    with pytest.raises(AttributeError, match="feat"):
        FeatureExtractor(o["model"], buckets=[64])(o["variables"], o["sample"])


def test_jax_extractor_truncates_a_classifiers_logits(small_object):
    """With an identity ``output_fn`` the JAX extractor slices the [1, 40]
    logits by the object's 30 points: classes 30-39 are dropped."""
    from scenesplat_tpu.engines.infer import FeatureExtractor

    o = small_object
    got = FeatureExtractor(o["model"], buckets=[64], output_fn=lambda out: out)(
        o["variables"], o["sample"])
    assert got.shape == (30,)
    close(got, o["want"][:30], "the first 30 logits", RTOL)


def test_extractor_hands_partseg_its_cls_token():
    """PTv1 PartSeg26 over 4 shape categories: a sample's ``cls_token``
    reaches the model through the port's extractor as through JAX's, the
    logits equal (1e-5 of their scale, the PTv1 tests' bar), and a
    DefaultSegmentor over it passes the token on."""
    from scenesplat_tpu.engines.infer import FeatureExtractor as JaxExtractor
    from scenesplat_tpu.models import build_model as jax_build
    from scenesplat_tpu_torch.engines.infer import FeatureExtractor
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_ptv2 import jax_point

    cfg = dict(type="PointTransformer-PartSeg26", in_channels=6, num_classes=5,
               num_shape_classes=4)
    s = cloud(3, rows=1, n=256, pad=0, extent=1.0)
    sample = dict(coord=s["coord"][0], feat=s["feat"][0], grid_coord=s["grid"][0],
                  cls_token=np.array([2]))
    model = jax_build(dict(cfg))
    shapes = jax.eval_shape(lambda p: model.init(jax.random.PRNGKey(0), p),
                            jax_point(dict(s, cls_token=np.array([2], np.int32))))
    variables = fill(shapes, np.random.default_rng(9))
    want = JaxExtractor(model, buckets=[256])(variables, sample)
    port = port_model(cfg, variables).eval()
    got = FeatureExtractor(port, buckets=[256], device="cpu")(sample)
    close(got, want, "PartSeg logits", 1e-5)
    other = FeatureExtractor(port, buckets=[256], device="cpu")(dict(sample, cls_token=[1]))
    assert np.abs(other - got).max() > 1e-3  # the token reaches the head
    wrapped = build_model(dict(type="DefaultSegmentor", backbone=dict(cfg))).eval()
    wrapped.backbone.load_state_dict(port.state_dict())
    close(FeatureExtractor(wrapped, buckets=[256], device="cpu")(sample), want,
          "PartSeg logits under DefaultSegmentor", 1e-5)


# ---- testers and the evaluator, fed the same logits ------------------------

class _Objects(list):
    """Objects whose fetch draws from the transform generator ``trng`` (a
    sample's ``noise``), so the testers' seeding order shows in the
    logits."""

    categories = ["airplane", "car", "chair"]
    category2part = {"airplane": [0, 1], "car": [2, 3], "chair": [4, 5, 6]}

    def __init__(self, items, trng):
        super().__init__(items)
        self.trng = trng

    def __getitem__(self, i):
        item = dict(list.__getitem__(self, i))
        item["noise"] = self.trng().normal(0, 0.8, 5).astype(np.float32)
        self.last = item
        return item


def _objects(trng, n=6):
    rng = np.random.default_rng(4)
    shape = dict(coord=np.zeros((3, 3), np.float32), feat=np.zeros((3, 6), np.float32),
                 grid_coord=np.zeros((3, 3), np.int32))
    return _Objects([dict(shape, _id=i, category=np.array([int(c)]))
                     for i, c in enumerate(rng.integers(0, 5, n))], trng)


def _object_logits(sample):
    base = np.eye(5, dtype=np.float32)[int(sample["category"][0])] * 0.6
    return base + sample["noise"]


def _tester(module, name, dataset, extractor, **attrs):
    cls = module.TESTERS.get(name)
    t = cls.__new__(cls)
    t.dataset, t.extractor, t.seed = dataset, extractor, 3
    t.variables, t.model = {}, torch.nn.Identity()
    t.logger = logging.getLogger("test")
    for k, v in attrs.items():
        setattr(t, k, v)
    return t


@pytest.mark.parametrize("name,attrs", [
    ("ClsTester", dict(num_classes=5, max_scenes=None)),
    ("ClsVotingTester", dict(num_classes=5, num_repeat=4, metric="allAcc", max_scenes=None)),
    ("ClsVotingTester", dict(num_classes=5, num_repeat=3, metric="mAcc", max_scenes=5)),
])
def test_cls_testers_match_jax(name, attrs):
    """Each repeat's draws come from (seed, repeat, index) in both packages,
    so the running probabilities and the best record are JAX's."""
    import scenesplat_tpu.data.transforms as jtf
    import scenesplat_tpu.engines.test as jtest
    import scenesplat_tpu_torch.data.transforms as ttf
    import scenesplat_tpu_torch.engines.test as ttest

    want = _tester(jtest, name, _objects(jtf.trng),
                   lambda variables, s: _object_logits(s), **attrs).test()
    got = _tester(ttest, name, _objects(ttf.trng), _object_logits, **attrs).test()
    assert got == want
    assert set(got) == ({"allAcc"} if name == "ClsTester" else {"allAcc", "mAcc"})


def test_partseg_tester_matches_jax():
    """Two variants an object (``voting_list``), per-point logits with
    noise; parts absent from both label and prediction score 1."""
    import scenesplat_tpu.engines.test as jtest
    import scenesplat_tpu_torch.engines.test as ttest

    rng = np.random.default_rng(6)
    objects, table = [], {}
    for i, cat in enumerate([0, 2, 1, 2]):
        parts = _Objects.category2part[_Objects.categories[cat]]
        seg = rng.choice(parts[:-1] if cat == 2 else parts, 40)
        variants = []
        for v in range(2):
            key = 2 * i + v
            table[key] = (np.eye(7)[seg] * 2 + rng.normal(0, 1.0, (40, 7))).astype(np.float32)
            variants.append(dict(_id=key))
        objects.append(dict(segment=seg, cls_token=np.array([cat]), voting_list=variants))
    dataset = type("PartObjects", (list,), dict(categories=_Objects.categories,
                                                 category2part=_Objects.category2part))(objects)
    want = _tester(jtest, "PartSegTester", dataset,
                   lambda variables, s: table[s["_id"]], num_classes=7,
                   max_scenes=None).test()
    got = _tester(ttest, "PartSegTester", dataset, lambda s: table[s["_id"]],
                  num_classes=7, max_scenes=None).test()
    assert set(got) == {"ins_mIoU", "cat_mIoU"}
    np.testing.assert_allclose([got["ins_mIoU"], got["cat_mIoU"]],
                               [want["ins_mIoU"], want["cat_mIoU"]], rtol=1e-12)


def _stub_trainer(cfg):
    from scenesplat_tpu_torch.utils.events import EventStorage

    return types.SimpleNamespace(cfg=cfg, logger=logging.getLogger("test"), comm_info={},
                                 storage=EventStorage(), model=torch.nn.Identity(),
                                 device=torch.device("cpu"),
                                 state=types.SimpleNamespace(params={}, batch_stats={}))


def test_cls_evaluator_matches_jax():
    """The JAX hook's jitted forward and the port's extractor stubbed with
    the same logits (each of the object just fetched): equal metrics and
    storage, allAcc the checkpoint metric."""
    import scenesplat_tpu.data.transforms as jtf
    import scenesplat_tpu.engines.hooks.evaluator as jev
    import scenesplat_tpu_torch.data.transforms as ttf
    import scenesplat_tpu_torch.engines.hooks.evaluator as tev
    from scenesplat_tpu_torch.utils.config import ConfigDict

    cfg = ConfigDict(seed=5, data=ConfigDict(num_points=64, num_classes=5),
                     model=ConfigDict(backbone=dict(enc_patch_size=(16, 16))))
    results = []
    for module, trng in ((jev, jtf.trng), (tev, ttf.trng)):
        hook = module.ClsEvaluator()
        hook.trainer = _stub_trainer(cfg)
        hook.dataset, hook.num_classes = _objects(trng, n=8), 5
        if module is jev:
            hook._fwd = lambda variables, *batch: _object_logits(hook.dataset.last)[None]
        else:
            hook.extractor = _object_logits
        hook.after_epoch()
        results.append((hook.trainer.comm_info, dict(hook.trainer.storage.latest)))
    assert results[0] == results[1]
    assert results[1][0]["current_metric_name"] == "allAcc"
    assert set(results[1][1]) == {"val/allAcc", "val/mAcc"}


def test_cls_testers_through_the_builder_on_a_classifier(small_object):
    """The port's build_tester with a dataset of objects and the small
    classifier on the CPU: ClsTester's allAcc is the share of objects whose
    extracted logits' argmax is their category, and ClsVotingTester gives
    JAX's record form."""
    from scenesplat_tpu_torch.data import DATASETS
    from scenesplat_tpu_torch.engines.infer import FeatureExtractor
    from scenesplat_tpu_torch.engines.test import build_tester

    o = small_object
    port = _port_classifier(o["cfg"], o["variables"]["params"], o["variables"]["batch_stats"])
    rng = np.random.default_rng(12)
    objects = [dict(o["sample"], feat=o["sample"]["feat"] + rng.normal(0, 0.3, (30, 6)).astype(
        np.float32), category=np.array([c])) for c in (3, 17, 3, 30)]

    name = "_ClsObjectsOfTestTorchCls"
    if name not in DATASETS._module_dict:
        @DATASETS.register_module(name)
        class _ObjectSet:
            def __init__(self, items, **kwargs):
                self.items = items

            def __len__(self):
                return len(self.items)

            def __getitem__(self, i):
                return dict(self.items[i])

    tester = build_tester(dict(type="ClsTester", num_classes=CLASSES), port,
                          dict(type=name, items=objects), patch_size=16, device="cpu")
    tester.extractor = FeatureExtractor(port, buckets=[64], device="cpu")
    preds = [int(tester.extractor(s).argmax()) for s in objects]
    want = np.mean([p == int(s["category"][0]) for p, s in zip(preds, objects)])
    assert tester.test() == {"allAcc": want}
    voting = build_tester(dict(type="ClsVotingTester", num_classes=CLASSES, num_repeat=2), port,
                          dict(type=name, items=objects), patch_size=16, device="cpu")
    voting.extractor = tester.extractor
    record = voting.test()
    assert set(record) == {"allAcc", "mAcc"} and record["allAcc"] == want
