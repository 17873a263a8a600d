"""Port parity, the zero-shot test path: voting and metric helpers, the
test-mode data path, the tester, the test entry point and the evaluator
hooks against the JAX package on the same numpy inputs.

Helpers and the data path are held to exact equality. The whole slice runs
the JAX ``ZeroShotSemSegTester`` and ``python -m scenesplat_tpu_torch.test``
over one synthetic 3DGS dataset (the layout of tests/test_engine.py at a
small size) with the same numpy-made weights in fp32: the two forwards
differ by summation order (1e-4 on unit features), which can flip an argmax
between near-tied classes, so predictions must agree on 99.5% of the points
and mIoU, fg_mIoU, mAcc and allAcc within 0.005. The JAX GridSample takes
its numpy path (the one the port copies; its host C++ sampler draws another
random stream)."""

import copy
import importlib.util
import json
import logging
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402,F401

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu.engines import eval as jeval  # noqa: E402
from scenesplat_tpu.utils import misc as jmisc  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402
from scenesplat_tpu_torch.engines import eval as teval  # noqa: E402
from scenesplat_tpu_torch.engines import test as ttest  # noqa: E402
from scenesplat_tpu_torch.ops import bitonic_sort as tsort  # noqa: E402
from scenesplat_tpu_torch.utils import misc as tmisc  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config  # noqa: E402

FLAGSHIP = "configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py"
D_LANG, N_CLASSES = 16, 6
LABELS = ["wall", "floor", "chair", "table", "sofa", "lamp"]
GS_KEYS = ("coord", "color", "opacity", "quat", "scale", "segment", "lang_feat",
           "valid_feat_mask")
BACKBONE = dict(
    type="PT-v3m1", in_channels=11, order=("z", "hilbert"), stride=(2, 2),
    enc_depths=(1, 1, 1), enc_channels=(8, 16, 24), enc_num_head=(2, 2, 2),
    enc_patch_size=(32, 32, 32), dec_depths=(1, 1), dec_channels=(D_LANG, 16),
    dec_num_head=(2, 2), dec_patch_size=(32, 32), mlp_ratio=2, drop_path=0.1,
    serialization_depth=10, stage_capacity=(0.5, 0.25))
PRED_AGREEMENT, METRIC_ATOL = 0.995, 0.005


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


@pytest.fixture(scope="module")
def gs_root(tmp_path_factory):
    """root/{train,val}/scene<i>/<asset>.npy in a 1 m cube (dense enough for
    several points per 5 cm test voxel and no pooling overflow), a label
    file and the text table as a torch ``.pt`` file."""
    root = tmp_path_factory.mktemp("port_test_gs")
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(N_CLASSES, D_LANG)).astype(np.float32)
    torch.save(torch.from_numpy(emb * 3.0), root / "text_embeddings.pt")  # not unit rows
    (root / "labels.txt").write_text("\n".join(LABELS))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for split, count in (("train", 3), ("val", 2)):
        for i in range(count):
            scene = root / split / f"scene{i:04d}"
            scene.mkdir(parents=True)
            n = int(rng.integers(520, 640))
            seg = rng.integers(0, N_CLASSES, n).astype(np.int16)
            seg[rng.random(n) < 0.05] = -1
            coord = rng.uniform(0, 1, (n, 3)).astype(np.float32)
            assets = dict(
                coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                quat=rng.normal(size=(n, 4)).astype(np.float32),
                scale=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                opacity=rng.uniform(0, 1, (n,)).astype(np.float32), segment=seg,
                lang_feat=(emb[seg] + 0.05 * rng.normal(size=(n, D_LANG))).astype(np.float16),
                valid_feat_mask=rng.random(n) > 0.2)
            if split == "val":
                m = n // 2
                assets["pc_coord"] = coord[:m] + rng.normal(0, 0.004, (m, 3)).astype(np.float32)
                assets["pc_segment"] = seg[:m].astype(np.int32)
            for key, value in assets.items():
                np.save(scene / f"{key}.npy", value)
    return str(root)


def _test_data_cfg(root):
    """The fragment test pipeline of configs/_base_/gs_pipelines.py at a
    5 cm test voxel (1 cm dedup kept), with the evaluation cloud loaded."""
    transform, test_cfg = _pipelines().lang_test_transform_and_cfg(GS_KEYS)
    test_cfg["voxelize"]["grid_size"] = 0.05
    return dict(type="ScanNetPPGSDataset", split="val", data_root=root, is_train=False,
                transform=transform, test_mode=True, test_cfg=test_cfg)


def _tester_cfg(root, save_path=None, **extra):
    return dict(type="ZeroShotSemSegTester", class_names=os.path.join(root, "labels.txt"),
                text_embeddings=os.path.join(root, "text_embeddings.pt"),
                excluded_classes=["wall", "floor", "ceiling"], enable_voting=True, vote_k=5,
                confidence_threshold=0.1, save_path=save_path, **extra)


def _assert_same(got, ref, where=""):
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref), where
        for key in ref:
            _assert_same(got[key], ref[key], f"{where}/{key}")
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            _assert_same(g, r, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert np.asarray(got).dtype == ref.dtype and got.shape == ref.shape, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


# ---- helpers, exact -------------------------------------------------------

def test_text_embeddings_pt_equal_jax(gs_root, tmp_path):
    path = os.path.join(gs_root, "text_embeddings.pt")
    got, ref = teval.load_text_embeddings(path), jeval.load_text_embeddings(path)
    assert got.dtype == ref.dtype == np.float32 and got.shape == (N_CLASSES, D_LANG)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-6)
    torch.save({"embeddings": torch.from_numpy(ref * 2)}, tmp_path / "dict.pt")
    np.testing.assert_allclose(teval.load_text_embeddings(str(tmp_path / "dict.pt")), ref,
                               atol=1e-7)
    torch.save({"a": torch.zeros(2, 2), "b": torch.zeros(2, 2)}, tmp_path / "two.pt")
    with pytest.raises(ValueError):
        teval.load_text_embeddings(str(tmp_path / "two.pt"))


@pytest.mark.parametrize("seed", [0, 1])
def test_intersection_and_union_and_metric_equal_jax(seed):
    rng = np.random.default_rng(seed)
    names = [f"c{i}" for i in range(7)]
    tm = teval.ZeroShotMetric(names, ("c0", "c3"), -1)
    jm = jeval.ZeroShotMetric(names, ("c0", "c3"), -1)
    for _ in range(3):
        pred = rng.integers(-1, 6, 400).astype(np.int32)  # class 6 never predicted
        target = rng.integers(-1, 5, 400).astype(np.int32)  # 5 and 6 never present
        for g, r in zip(tmisc.intersection_and_union(pred, target, 7, -1),
                        jmisc.intersection_and_union(pred, target, 7, -1)):
            np.testing.assert_array_equal(g, r)
        tm.update(pred, target)
        jm.update(pred, target)
    for protocol in ("hook", "tester"):
        got, ref = tm.results(protocol), jm.results(protocol)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(got[key], ref[key], err_msg=f"{protocol}/{key}")
    assert tm.results("hook")["mIoU"] != tm.results("tester")["mIoU"]  # they mask apart


def test_majority_and_clustering_voting_equal_jax():
    rng = np.random.default_rng(2)
    labels = rng.integers(-1, 5, (300, 7)).astype(np.int32)
    labels[:4] = -1  # rows with no valid vote
    labels[4:8] = [[0, 1, 0, 1, 2, 2, -1]]  # ties: the lowest class wins
    ref = jmisc._majority_vote(labels, 5, -1)
    for chunk in (1 << 16, 64):
        got = tmisc._majority_vote(labels, 5, -1, rows_per_chunk=chunk)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    pred = rng.integers(-1, 5, 500).astype(np.int32)
    instance = rng.integers(-1, 12, 500).astype(np.int32)
    np.testing.assert_array_equal(tmisc.clustering_voting(pred, instance, -1),
                                  jmisc.clustering_voting(pred, instance, -1))


@pytest.mark.parametrize("native_knn", [False, True])
def test_neighbor_voting_equals_jax(monkeypatch, native_knn):
    """Against the JAX package's cKDTree path and, where its host library is
    built, its grid search: random coordinates, so no distance ties."""
    from scenesplat_tpu import native

    if native_knn:
        monkeypatch.undo()
        if not native.available():
            pytest.skip("the JAX package's host library is not built")
    rng = np.random.default_rng(4)
    coord = rng.uniform(0, 2, (800, 3)).astype(np.float32)
    query = rng.uniform(0, 2, (300, 3)).astype(np.float32)
    pred = rng.integers(-1, 6, 800).astype(np.int32)
    valid = (rng.random(800) > 0.3) & (pred != -1)
    for q in (query, None):
        got = tmisc.neighbor_voting(coord, pred, 9, valid, 6, query_coord=q)
        ref = jmisc.neighbor_voting(coord, pred, 9, valid, 6, query_coord=q)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    none = tmisc.neighbor_voting(coord, pred, 9, np.zeros(800, bool), 6, query_coord=query)
    assert none.shape == (300,) and (none == -1).all()
    few = tmisc.neighbor_voting(coord, pred, 9, np.arange(800) < 4, 6, query_coord=query)
    np.testing.assert_array_equal(few, jmisc.neighbor_voting(
        coord, pred, 9, np.arange(800) < 4, 6, query_coord=query))


def test_evaluate_scene_equals_jax():
    rng = np.random.default_rng(5)
    text = rng.normal(size=(6, D_LANG)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    seg = rng.integers(0, 6, 500).astype(np.int32)
    feat = text[seg] + 0.4 * rng.normal(size=(500, D_LANG)).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    coord = rng.uniform(0, 2, (500, 3)).astype(np.float32)
    kw = dict(valid_feat_mask=rng.random(500) > 0.2, pc_coord=coord[:200] + 0.01,
              pc_segment=seg[:200], vote_k=5, confidence_threshold=0.6)
    tm, jm = teval.ZeroShotMetric(LABELS, ("wall",)), jeval.ZeroShotMetric(LABELS, ("wall",))
    got = teval.evaluate_scene(feat, coord, seg, text, tm, **kw)
    ref = jeval.evaluate_scene(feat, coord, seg, text, jm, **kw)
    np.testing.assert_array_equal(got, ref)
    assert (got == -1).any() or (teval.zero_shot_predict(feat, text, 0.6)[0] == -1).any()
    np.testing.assert_array_equal(tm.intersection, jm.intersection)
    got = teval.evaluate_scene(feat, coord, seg, text, tm, enable_voting=False,
                               instance=rng.integers(0, 9, 500))
    assert got.shape == (500,)


# ---- the test-mode data path, exact ---------------------------------------

@pytest.mark.parametrize("return_inverse", [False, True])
def test_grid_sample_test_mode_equals_jax(return_inverse):
    rng = np.random.default_rng(6)
    n = 700
    data = dict(coord=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                segment=rng.integers(-1, 5, n).astype(np.int32), name="s",
                pc_coord=rng.uniform(0, 1, (900, 3)).astype(np.float32),
                pc_segment=rng.integers(-1, 5, 900).astype(np.int32))
    cfg = dict(type="GridSample", grid_size=0.1, hash_type="fnv", mode="test",
               keys=("coord", "color"), return_grid_coord=True, return_min_coord=True,
               return_inverse=return_inverse)
    got = ttf.TRANSFORMS.build(dict(cfg))(copy.deepcopy(data))
    ref = jtf.TRANSFORMS.build(dict(cfg))(copy.deepcopy(data))
    assert len(ref) >= 3  # several fragments
    _assert_same(got, ref)
    counts = np.zeros(n, int)
    for frag in got:
        counts[frag["index"]] += 1
    assert (counts >= 1).all()  # the fragments cover every point
    assert got[0]["pc_coord"].shape[0] < 900  # the evaluation cloud was subsampled
    keep = ttf.TRANSFORMS.build(dict(cfg, apply_to_pc=False))(copy.deepcopy(data))
    assert keep[0]["pc_coord"].shape[0] == 900
    for name, kw in (("Copy", dict(keys_dict={"coord": "origin_coord", "absent": "x"})),
                     ("RandomRotateTargetAngle", dict(angle=[1 / 2], axis="z",
                                                      center=[0, 0, 0], p=1))):
        ttf.seed_transforms(3)
        g = ttf.TRANSFORMS.build(dict(type=name, **kw))(copy.deepcopy(data))
        jtf.seed_transforms(3)
        _assert_same(g, jtf.TRANSFORMS.build(dict(type=name, **kw))(copy.deepcopy(data)))


def test_prepare_test_data_equals_jax(gs_root):
    cfg = _test_data_cfg(gs_root)
    tds, jds = tdata.build_dataset(copy.deepcopy(cfg)), jdata.build_dataset(copy.deepcopy(cfg))
    assert len(tds) == len(jds) == 2
    for idx in range(2):
        ttf.seed_transforms((0, idx))
        got = tds[idx]
        jtf.seed_transforms((0, idx))
        ref = jds[idx]
        _assert_same(got, ref)
        assert len(got["fragment_list"]) >= 2
        assert set(got) >= {"segment", "name", "coord", "pc_coord", "pc_segment",
                            "origin_coord", "origin_segment", "origin_feat_mask", "inverse",
                            "fragment_list"}
        assert set(got["fragment_list"][0]) == {"coord", "grid_coord", "index", "feat"}
    with pytest.raises(NotImplementedError):
        tdata.build_dataset(dict(cfg, test_cfg=dict(cfg["test_cfg"], crop=dict(type="X"))))


# ---- the tester's prediction cache (tests/test_testers.py:168-240) -------

def _stub_tester(tmp_path, calls, fingerprint=None):
    n, c, d = 48, 4, 8
    rng = np.random.default_rng(9)
    text = rng.normal(size=(c, d)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    seg = rng.integers(0, c, size=n).astype(np.int32)
    feat = text[seg] + rng.normal(0, 0.05, (n, d)).astype(np.float32)

    def extractor(sample):
        calls.append(1)
        return feat

    t = ttest.ZeroShotSemSegTester.__new__(ttest.ZeroShotSemSegTester)
    scene = dict(name="sc", segment=seg, coord=rng.normal(size=(n, 3)),
                 fragment_list=[dict(index=np.arange(n))])
    attrs = dict(
        dataset=[scene], extractor=extractor, model=torch.nn.Identity(), seed=0,
        device=torch.device("cpu"), logger=logging.getLogger("test"),
        class_names=[f"c{i}" for i in range(c)], text_emb=text, excluded_classes=(),
        enable_voting=False, vote_k=3, confidence_threshold=0.0, ignore_index=-1,
        pred_label_mapping=None, top3=False, save_feat=False, skip_eval=False,
        save_path=str(tmp_path), save_submission=False, max_scenes=None, verbose=False,
        scene_log=[], weights_fingerprint=fingerprint)
    for k, v in attrs.items():
        setattr(t, k, v)
    return t


def test_zero_shot_pred_cache_resume(tmp_path):
    calls = []
    r1 = _stub_tester(tmp_path, calls).test()
    assert len(calls) == 1 and (tmp_path / "sc_pred.npy").exists()
    r2 = _stub_tester(tmp_path, calls).test()
    assert len(calls) == 1  # no new inference
    assert r1["mIoU"] == r2["mIoU"] > 0.9
    txt = (tmp_path / "eval_results.txt").read_text()
    assert f"{r1['mIoU']:.4f}" in txt and "Per-class results:" in txt


def test_zero_shot_pred_cache_weights_fingerprint(tmp_path):
    calls = []
    _stub_tester(tmp_path, calls, "ckptA:1").test()
    assert len(calls) == 1
    _stub_tester(tmp_path, calls, "ckptA:1").test()
    assert len(calls) == 1  # same weights: cache reused
    _stub_tester(tmp_path, calls, "ckptB:2").test()
    assert len(calls) == 2  # different weights: cache invalidated
    assert (tmp_path / "pred_cache_weights.txt").read_text().strip() == "ckptB:2"


def _submitting_testers(tmp_path, kind, dataset_type):
    """The port's and the JAX package's ``kind`` tester with
    ``save_submission`` over one scene of two fragments, the dataset a list
    of ``dataset_type``'s name (its ``class2id`` where ScanNet's), fed the
    same features or logits; each writes under tmp_path/<package>."""
    from scenesplat_tpu.engines import test as jtest
    from scenesplat_tpu_torch.data import metadata

    n, c, d = 60, 5, 8
    rng = np.random.default_rng(13)
    text = rng.normal(size=(c, d)).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    frags = [dict(index=np.arange(0, n, 2)), dict(index=np.arange(1, n, 2))]
    table = [rng.normal(size=(n // 2, d if kind == "ZeroShotSemSegTester" else c)).astype(
        np.float32) for _ in frags]
    scene = dict(name="scene0007_00", segment=rng.integers(0, c, n).astype(np.int32),
                 coord=rng.normal(size=(n, 3)), fragment_list=frags)
    ds_class = type(dataset_type, (list,), dict(
        class2id=metadata.scannet_class_ids(200)) if "ScanNet200" in dataset_type else {})
    testers = []
    for module, package in ((ttest, "port"), (jtest, "jax")):
        t = module.TESTERS.get(kind).__new__(module.TESTERS.get(kind))
        attrs = dict(dataset=ds_class([scene]), model=torch.nn.Identity(), variables={}, seed=0,
                     device=torch.device("cpu"), logger=logging.getLogger("test"),
                     ignore_index=-1, top3="ScanNetPP" in dataset_type, max_scenes=None,
                     save_path=str(tmp_path / package), save_submission=True, scene_log=[],
                     verbose=False, weights_fingerprint=None)
        if kind == "ZeroShotSemSegTester":
            attrs.update(class_names=[f"c{i}" for i in range(c)], text_emb=text,
                         excluded_classes=(), enable_voting=False, vote_k=3,
                         confidence_threshold=0.0, pred_label_mapping=None, save_feat=False,
                         skip_eval=False)
        else:
            attrs.update(num_classes=c)
        for k, v in attrs.items():
            setattr(t, k, v)
        # the fragment's position in the list picks its outputs
        pick = lambda frag: table[int(frag["index"][0])]  # noqa: E731
        t.extractor = pick if package == "port" else (lambda variables, frag: pick(frag))
        testers.append(t)
    return testers


@pytest.mark.parametrize("kind,dataset_type", [
    ("ZeroShotSemSegTester", "ScanNet200GSDataset"),
    ("ZeroShotSemSegTester", "ScanNetPPGSDataset"),
    ("SemSegTester", "ScanNet200GSDataset"),
    ("SemSegTester", "KITTI360GSDataset")])
def test_save_submission_raises(gs_root, tmp_path, kind, dataset_type):
    """``save_submission`` once raised here; the port's testers now write
    the JAX package's submission files, byte for byte (ScanNet200's
    benchmark ids, ScanNet++'s three comma-separated top-3 columns,
    KITTI-360's uint32 labels), and the builder takes the option."""
    tester = ttest.build_tester(_tester_cfg(gs_root, save_submission=True,
                                            save_path=str(tmp_path / "built")),
                                torch.nn.Identity(), _test_data_cfg(gs_root), device="cpu")
    assert tester.save_submission
    port, jax_tester = _submitting_testers(tmp_path, kind, dataset_type)
    port.test()
    jax_tester.test()
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port" / "submit").rglob("*") if p.is_file())
    assert len(files) == 1
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


# ---- the whole slice --------------------------------------------------------

@pytest.fixture(scope="module")
def slice_run(gs_root, tmp_path_factory):
    """The JAX tester's run and the port's checkpoint and config file, from
    the same numpy-made weights."""
    from scenesplat_tpu import native
    from scenesplat_tpu.engines import test as jtest
    from scenesplat_tpu.models import PointBatch, build_model
    from scenesplat_tpu_torch.models import build_model as tbuild
    from scenesplat_tpu_torch.utils.weights import load_flax_weights
    from tests.test_torch_model import _numpy_variables

    out = tmp_path_factory.mktemp("slice")
    jmodel = build_model(dict(type="LangPretrainer", backbone=dict(BACKBONE, use_pallas=False)))
    zeros = np.zeros((1, 64, 3), np.float32)
    point = PointBatch(coord=zeros, feat=np.zeros((1, 64, 11), np.float32),
                       grid_coord=zeros.astype(np.int32), mask=np.ones((1, 64), bool))
    params, stats = _numpy_variables(jmodel, point, np.random.default_rng(21))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        tester = jtest.build_tester(
            _tester_cfg(gs_root, save_path=str(out / "jax")), jmodel,
            {"params": params, "batch_stats": stats}, _test_data_cfg(gs_root), patch_size=32,
            seed=0)
        results = tester.test()

    tmodel = load_flax_weights(tbuild(dict(type="LangPretrainer", backbone=dict(BACKBONE))),
                               params, stats)
    weight = out / "weights.pth"
    torch.save(dict(state_dict=tmodel.state_dict(), epoch=1), weight)
    cfg = Config(dict(seed=0, model=dict(type="LangPretrainer", backbone=dict(BACKBONE)),
                      data=dict(test=_test_data_cfg(gs_root)),
                      test=_tester_cfg(gs_root, save_path=str(out / "port"))))
    cfg_file = out / "test_cfg.py"
    cfg.dump(str(cfg_file))
    return dict(out=out, jax_results=results, cfg_file=str(cfg_file), weight=str(weight))


def _preds(folder):
    return {f: np.load(os.path.join(folder, f)) for f in sorted(os.listdir(folder))
            if f.endswith("_pred.npy")}


def test_tester_entry_matches_jax_tester(slice_run, monkeypatch):
    from scenesplat_tpu_torch import test as entry

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")  # restored after the entry point sets it
    out = slice_run["out"]
    (res,) = entry.main(["--config-file", slice_run["cfg_file"], "--device", "cpu",
                         "--options", f"weight={slice_run['weight']}"])
    ref = slice_run["jax_results"]
    got_p, ref_p = _preds(out / "port"), _preds(out / "jax")
    assert sorted(got_p) == sorted(ref_p) and len(ref_p) == 2
    same = np.concatenate([got_p[k] == ref_p[k] for k in ref_p])
    assert same.mean() >= PRED_AGREEMENT, same.mean()
    for key in ("mIoU", "fg_mIoU", "mAcc", "allAcc"):
        assert abs(res[key] - ref[key]) <= METRIC_ATOL, (key, res[key], ref[key])
    assert 0 < res["mIoU"] < 1 and len(np.unique(np.concatenate(list(got_p.values())))) > 2
    assert (out / "port" / "eval_results.txt").read_text().startswith("Val result: mIoU")

    # the same run through the bitonic sort: equal predictions and metrics
    tsort.bitonic_sort.launches = 0
    (res_on,) = entry.main([
        "--config-file", slice_run["cfg_file"], "--device", "cpu", "--options",
        f"weight={slice_run['weight']}", "bitonic_sort=True",
        f"test.save_path={out / 'port_on'}"])
    assert os.environ[tsort.ENV_SWITCH] == "1"
    on_p = _preds(out / "port_on")
    for k in got_p:
        np.testing.assert_array_equal(on_p[k], got_p[k])
    for key in res:
        np.testing.assert_array_equal(res_on[key], res[key])
    assert tsort.bitonic_sort.launches == 0  # CPU tensors: the plain version


def test_tester_entry_needs_a_card_without_device_cpu(slice_run):
    from scenesplat_tpu_torch import test as entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        entry.main(["--config-file", slice_run["cfg_file"]])


def test_train_entry_with_evaluator_hooks(gs_root, tmp_path, monkeypatch):
    """Two tiny epochs of the flagship config file with its own hook list:
    the evaluator logs val0/fg_mIoU, the saver writes model_best.pth, and
    PreciseEvaluator's tester reports what the test entry point reports on
    that checkpoint."""
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry
    from tests.test_torch_train import TINY

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    cfg = Config.fromfile(FLAGSHIP)
    exp = tmp_path / "exp"
    hooks = copy.deepcopy(cfg.hooks)
    assert [h["type"] for h in hooks[3:]] == [
        "LangPretrainZeroShotSemSegEvalMulti", "CheckpointSaver", "PreciseEvaluator"]
    hooks[2]["log_interval"] = 1
    hooks[3].update(class_names=[os.path.join(gs_root, "labels.txt")],
                    text_embeddings=[os.path.join(gs_root, "text_embeddings.pt")],
                    excluded_classes=[["wall", "floor", "ceiling"]], vote_k=5)
    val = dict(cfg.data.val[0], data_root=gs_root)
    for t in val["transform"]:
        if t["type"] == "GridSample":
            t["grid_size"] = 0.05
    cfg.merge_from_options(dict(save_path=str(exp), epoch=2, eval_epoch=2, batch_size=2,
                                num_worker=2, hooks=hooks,
                                test=_tester_cfg(gs_root, save_path=str(exp / "test"))))
    cfg.data.num_points = 1024
    cfg.data.val = [val]
    cfg.data.test = _test_data_cfg(gs_root)
    cfg.model.backbone.update(TINY)
    cfg.model.criteria[2]["min_samples"] = 5
    for ds in cfg.data.train.datasets:
        ds["data_root"], ds["split"] = gs_root, "train"
        for t in ds["transform"]:
            if t["type"] == "SphereCrop":
                t["point_max"] = 500
            if t["type"] == "GridSample":
                t["grid_size"] = 0.05
    cfg_file = tmp_path / "tiny_flagship_eval.py"
    cfg.dump(str(cfg_file))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0

    with open(exp / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    logged = [r["val0/fg_mIoU"] for r in records if "val0/fg_mIoU" in r]
    assert logged and all(0.0 <= v <= 1.0 for v in logged)
    assert "val/fg_mIoU" in records[-1] and "val0/mIoU" in records[-1]
    best = exp / "model" / "model_best.pth"
    assert best.exists() and (exp / "model" / "model_last.pth").exists()
    # the last epoch's validation comes after the last metrics.json record
    assert max(logged) <= torch.load(best, weights_only=False)["best_metric"] <= 1.0
    reported = (exp / "test" / "eval_results.txt").read_text()

    (res,) = test_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                              f"weight={best}", f"test.save_path={tmp_path / 'again'}"])
    assert (tmp_path / "again" / "eval_results.txt").read_text() == reported
    assert f"{res['mIoU']:.4f}/{res['mAcc']:.4f}/{res['allAcc']:.4f}" in reported
