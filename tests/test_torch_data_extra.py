"""Port parity, the last data pieces, writers and hooks: the transforms
``NormalizeCoord``, ``PositiveShift``, ``RandomShift``, ``PointClip``,
``ClipGaussianJitter``, ``CropBoundary`` and ``GSGaussianBlurVoxelGPU``,
GridSample's ``ravel`` hash, ``KITTI360GSDataset``, the benchmark
submission writers (byte for byte), the TensorBoard writer, and the
``RuntimeProfiler`` and ``DataCacheOperator`` hooks; and the JAX
dataset's ``test_cfg.crop`` fault, which the port refuses.

Every transform runs on the same numpy sample under the same
``seed_transforms`` in both packages and must give equal arrays (the blur:
scipy on both sides, equal bits). JAX's GridSample takes its numpy path in
train mode (its host C++ sampler draws another stream). A few seconds
alone on one worker.
"""

import copy
import json
import logging
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402

from tests.test_torch_test import _assert_same  # noqa: E402


@pytest.fixture(autouse=True)
def jax_numpy_grid_sample(monkeypatch):
    from scenesplat_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


def _sample(seed=0, n=400, grid=True):
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-1.5, 2.5, (n, 3)).astype(np.float32)
    d = dict(coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
             scale=rng.uniform(0, 0.1, (n, 3)).astype(np.float32),
             opacity=rng.uniform(0, 1, (n, 1)).astype(np.float32),
             segment=rng.integers(0, 4, n).astype(np.int32),
             quat=rng.normal(size=(n, 4)).astype(np.float32))
    if grid:
        d["grid_coord"] = np.floor((coord - coord.min(0)) / 0.25).astype(np.int64)
    return d


def _both(cfg, sample, seed=(1, 2)):
    """The transform (or a list: their Compose) of each package on a copy
    of ``sample`` under ``seed_transforms(seed)``."""
    out = []
    for tf in (ttf, jtf):
        tf.seed_transforms(seed)
        if isinstance(cfg, list):
            op = tf.Compose(copy.deepcopy(cfg))
        else:
            op = tf.TRANSFORMS.build(copy.deepcopy(cfg))
        out.append(op(copy.deepcopy(sample)))
    return out


CASES = [
    dict(type="NormalizeCoord"),
    dict(type="PositiveShift"),
    dict(type="RandomShift"),
    dict(type="RandomShift", shift=(0.5, 0.1, 0.3)),
    dict(type="PointClip", point_cloud_range=(-1, -0.5, -1, 1, 1.5, 2)),
    dict(type="ClipGaussianJitter"),
    dict(type="ClipGaussianJitter", scalar=0.05, store_jitter=True),
    dict(type="CropBoundary"),
    dict(type="GSGaussianBlurVoxelGPU", p=1.0),
    dict(type="GSGaussianBlurVoxelGPU", p=1.0, sigma=(0.05, 0.1)),  # r = 0: no blur
    dict(type="GSGaussianBlurVoxelGPU", p=0.5, sigma=(0.5, 1.5)),
]


@pytest.mark.parametrize("cfg", CASES, ids=[f"{c['type']}-{i}" for i, c in enumerate(CASES)])
@pytest.mark.parametrize("seed", [(1, 2), (3, 0, 7)])
def test_transform_equals_jax(cfg, seed):
    got, want = _both(cfg, _sample(), seed)
    _assert_same(got, want)


def test_transforms_draw_in_jax_order():
    """A chain of the drawing transforms: each draws from the per-sample
    generator in JAX's order, so the whole sample is JAX's."""
    chain = [dict(type="RandomShift", shift=((-0.2, 0.2), (0, 0.1), (-0.1, 0))),
             dict(type="ClipGaussianJitter", store_jitter=True),
             dict(type="NormalizeCoord"),
             dict(type="GSGaussianBlurVoxelGPU", p=0.7),
             dict(type="PointClip", point_cloud_range=(-0.8, -0.8, -0.8, 0.8, 0.8, 0.8)),
             dict(type="PositiveShift")]
    for seed in range(4):
        got, want = _both(chain, _sample(seed), (seed, 9))
        _assert_same(got, want)
    assert not np.array_equal(got["color"], _sample(3)["color"])  # some blur ran


@pytest.mark.parametrize("mode", ["train", "test"])
def test_grid_sample_ravel_equals_jax(mode):
    """GridSample with ``hash_type="ravel"``: the train draw, or the test
    fragments, with the inverse, grid coordinates and the evaluation
    cloud's subsample; the fragments' order follows the ravel keys, not
    FNV's."""
    sample = _sample(4, n=600, grid=False)
    rng = np.random.default_rng(5)
    sample.update(pc_coord=rng.uniform(-1.5, 2.5, (900, 3)).astype(np.float32),
                  pc_segment=rng.integers(-1, 4, 900).astype(np.int32))
    cfg = dict(type="GridSample", grid_size=0.5, hash_type="ravel", mode=mode,
               keys=("coord", "color", "segment"), return_inverse=True,
               return_grid_coord=True)
    got, want = _both(cfg, sample)
    _assert_same(got, want)
    fnv, _ = _both(dict(cfg, hash_type="fnv"), sample)
    if mode == "test":
        assert len(got) == len(fnv) > 1
        assert any(not np.array_equal(a["index"], b["index"]) for a, b in zip(got, fnv))


def test_ravel_hash_keys_rank_cells():
    cells = np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0], [2, 0, 1], [1, 3, 2]])
    keys = ttf.ravel_hash_vec(cells)
    np.testing.assert_array_equal(keys, jtf.ravel_hash_vec(cells))
    assert keys.tolist() == [0, 1, 3, 25, 23]  # x * 4 * 3 + y * 3 + z over extents (3, 4, 3)


def test_kitti360_sample_equals_jax(tmp_path):
    """A KITTI-360 GS scene (no normals: an extra ``normal.npy`` is not one
    of its assets) through a pipeline of the new transforms, GridSample on
    the ravel hash and Collect."""
    rng = np.random.default_rng(8)
    for name in ("seq00_0001", "seq00_0002"):
        scene = tmp_path / "train" / name
        scene.mkdir(parents=True)
        s = _sample(int(rng.integers(100)), n=500, grid=False)
        for key in ("coord", "color", "quat", "scale", "opacity"):
            np.save(scene / f"{key}.npy", s[key])
        np.save(scene / "segment.npy", s["segment"].astype(np.int16))
        np.save(scene / "normal.npy", rng.normal(size=(500, 3)).astype(np.float32))
    transform = [
        dict(type="RandomShift", shift=(0.2, 0.2, 0.1)),
        dict(type="PointClip", point_cloud_range=(-1.4, -1.4, -1.4, 2.4, 2.4, 2.4)),
        dict(type="ClipGaussianJitter"),
        dict(type="PositiveShift"),
        dict(type="NormalizeColor"),
        dict(type="GridSample", grid_size=0.2, hash_type="ravel", mode="train",
             keys=("coord", "color", "segment", "quat", "scale", "opacity"),
             return_grid_coord=True),
        dict(type="GSGaussianBlurVoxelGPU", p=1.0),
        dict(type="CropBoundary"),
        dict(type="Collect", keys=("coord", "grid_coord", "segment"),
             feat_keys=("color", "opacity", "quat", "scale")),
    ]
    cfg = dict(type="KITTI360GSDataset", split="train", data_root=str(tmp_path),
               transform=transform)
    tds, jds = tdata.build_dataset(copy.deepcopy(cfg)), jdata.build_dataset(copy.deepcopy(cfg))
    assert len(tds) == len(jds) == 2
    for idx in range(2):
        ttf.seed_transforms((0, 0, idx))
        got = tds[idx]
        jtf.seed_transforms((0, 0, idx))
        _assert_same(got, jds[idx])
        assert (got["segment"] != 0).all() and got["feat"].shape[1] == 11
    raw = tds.get_data(0)
    assert "normal" not in raw and raw["segment"].dtype == np.int32


def test_jax_test_crop_gains_the_dicts_keys(tmp_path):
    """The JAX dataset extends a test scene's fragment list by what its
    ``test_cfg.crop`` returns; every registered transform returns a dict
    (SphereCrop(mode="all") its input), so the list gains the dict's keys
    in place of fragments. The port refuses the option."""
    scene = tmp_path / "val" / "scene0000"
    scene.mkdir(parents=True)
    s = _sample(2, n=300, grid=False)
    for key in ("coord", "color", "quat", "scale", "opacity", "segment"):
        np.save(scene / f"{key}.npy", s[key])
    test_cfg = dict(voxelize=dict(type="GridSample", grid_size=0.5, hash_type="fnv", mode="test",
                                  keys=("coord", "color"), return_grid_coord=True),
                    crop=dict(type="SphereCrop", point_max=10 ** 6, mode="all"),
                    post_transform=[], aug_transform=[[]])
    cfg = dict(type="ScanNetPPGSDataset", split="val", data_root=str(tmp_path), is_train=False,
               transform=[], test_mode=True, test_cfg=test_cfg)
    jtf.seed_transforms((0, 0))
    fragments = jdata.build_dataset(copy.deepcopy(cfg))[0]["fragment_list"]
    assert fragments and all(isinstance(f, str) for f in fragments)
    assert {"coord", "grid_coord", "index"} <= set(fragments)
    with pytest.raises(NotImplementedError, match="test_cfg.crop"):
        tdata.build_dataset(copy.deepcopy(cfg))


# ---- the submission writers, byte for byte ---------------------------------

WRITER_CASES = [
    ("ScanNetGSDataset", "scene0011_00", "scannet20", None),
    ("ScanNet200GSDataset", "scene0012_00", "scannet200", None),
    ("KITTI360GSDataset", "seq00_0001", None, None),
    ("SemanticKITTIDataset", "08_000123", None, {i: 10 + 3 * i for i in range(20)}),
    ("NuScenesDataset", "token42", None, None),
    ("ScanNetPPGSDataset", "0a5c013435", None, None),
    ("ScanNetPPGSDataset-top3", "0a5c013436", None, None),
    ("Matterport3DGSDataset", "region7", None, None),
    ("HoliCityGSDataset", "block3", None, None),
]


@pytest.mark.parametrize("kind,name,ids,label_map", WRITER_CASES,
                         ids=[c[0] for c in WRITER_CASES])
def test_submission_files_equal_jax(tmp_path, kind, name, ids, label_map):
    from scenesplat_tpu.engines.test import _write_submission as jax_write
    from scenesplat_tpu_torch.data import metadata
    from scenesplat_tpu_torch.engines.test import _write_submission

    rng = np.random.default_rng(len(name))
    classes = 200 if ids == "scannet200" else 20
    pred = rng.integers(-1, classes, 50).astype(np.int32)
    if kind.endswith("top3"):
        pred = rng.integers(0, 100, (50, 3)).astype(np.int32)
    elif kind in ("KITTI360GSDataset", "SemanticKITTIDataset", "NuScenesDataset"):
        pred = np.abs(pred)
    dataset_type = kind.split("-")[0]
    class2id = None if ids is None else metadata.scannet_class_ids(classes)
    for root, write in ((tmp_path / "port", _write_submission), (tmp_path / "jax", jax_write)):
        write(str(root), name, pred, dataset_type, class2id, label_map)
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(tmp_path / "jax")
                                     for p in (tmp_path / "jax").rglob("*") if p.is_file())
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f


def test_scannet_class_ids_equal_jax():
    from scenesplat_tpu.data import gs_datasets as jgs
    from scenesplat_tpu_torch.data import gs_datasets as tgs

    for name in ("ScanNetGSDataset", "ScanNet200GSDataset"):
        j = getattr(jgs, name).__new__(getattr(jgs, name))
        t = getattr(tgs, name).__new__(getattr(tgs, name))
        np.testing.assert_array_equal(t.class2id, j.class2id)


# ---- writers and hooks -----------------------------------------------------

def _trainer(tmp_path, **cfg):
    from scenesplat_tpu_torch.utils.config import ConfigDict
    from scenesplat_tpu_torch.utils.events import EventStorage

    return types.SimpleNamespace(cfg=ConfigDict(save_path=str(tmp_path), **cfg),
                                 logger=logging.getLogger("test"), storage=EventStorage(),
                                 device=torch.device("cpu"))


def test_tensorboard_writer_is_off_without_tensorboardx(tmp_path, monkeypatch, caplog):
    """Without tensorboardX the writer writes nothing and says so once."""
    import builtins

    from scenesplat_tpu_torch.utils import events

    real_import = builtins.__import__

    def no_tensorboardx(name, *args, **kwargs):
        if name == "tensorboardX":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboardx)
    monkeypatch.setattr(events, "_TENSORBOARD_WARNED", [])
    logger = logging.getLogger("scenesplat_tpu_torch")
    monkeypatch.setattr(logger, "propagate", True)
    with caplog.at_level(logging.WARNING, logger="scenesplat_tpu_torch"):
        writers = [events.TensorboardWriter(str(tmp_path / "tb")) for _ in range(2)]
    storage = events.EventStorage()
    storage.put_scalar("loss", 1.0)
    for w in writers:
        w.write(storage)
        w.write_scalar("x", 1.0, 0)
        w.close()
    assert not (tmp_path / "tb").exists()
    assert sum("tensorboardX" in r.getMessage() for r in caplog.records) == 1


def test_runtime_profiler_writes_a_cpu_trace(tmp_path):
    """Two profiled steps from step 1 of a small matmul loop: a Chrome trace
    of CPU events (the matmuls among them) under save_path/profile; with
    exit_after the run ends with SystemExit(0) at the window's last step."""
    from scenesplat_tpu_torch.engines.hooks import HOOKS

    for exit_after in (False, True):
        hook = HOOKS.build(dict(type="RuntimeProfiler", start_step=1, num_steps=2,
                                exit_after=exit_after))
        hook.trainer = _trainer(tmp_path / str(exit_after))
        x = torch.randn(64, 64)
        ended = None
        for step in range(5):
            hook.trainer.storage.iter = step
            hook.before_step()
            x = torch.tanh(x @ x)
            try:
                hook.after_step()
            except SystemExit as e:
                ended = (step, e.code)
                break
        hook.after_train()
        assert ended == ((2, 0) if exit_after else None)
        with open(hook.trace_path) as f:
            events = json.load(f)["traceEvents"]
        assert hook.trace_path == os.path.join(tmp_path / str(exit_after), "profile",
                                               "trace_rank0.json")
        names = [e.get("name", "") for e in events]
        assert sum(n in ("aten::mm", "aten::matmul") for n in names) >= 2
        assert not any(e.get("cat") == "kernel" for e in events)  # no card here
        assert hook.device_events == 0


def test_data_cache_operator_reads_the_train_split(tmp_path, caplog):
    from scenesplat_tpu_torch.engines.hooks import HOOKS
    from scenesplat_tpu_torch.utils.config import ConfigDict

    for scene in ("a", "b"):
        (tmp_path / "train" / scene).mkdir(parents=True)
        for key in ("coord", "color"):
            np.save(tmp_path / "train" / scene / f"{key}.npy", np.zeros(3))
    (tmp_path / "val" / "c").mkdir(parents=True)
    np.save(tmp_path / "val" / "c" / "coord.npy", np.zeros(3))
    hook = HOOKS.build(dict(type="DataCacheOperator"))
    hook.trainer = _trainer(tmp_path, data=ConfigDict(
        train=ConfigDict(data_root=str(tmp_path), split="train")))
    with caplog.at_level(logging.INFO, logger="test"):
        hook.before_train()
    assert any("warmed for 4 asset files" in r.getMessage() for r in caplog.records)
