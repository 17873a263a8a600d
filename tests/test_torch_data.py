"""Port parity, the training data path: the flagship config read by the
port's Config, the flagship train transforms, ``collate_padded`` with Mix3D
and over-budget downsampling, and the first batches of ``Loader`` and
``MultiDatasetLoader`` against the JAX package's, equal array for array
for the same seeds, on a synthetic 3DGS dataset in the layout the three
flagship GS datasets read (``data_root/split/scene/<asset>.npy``).

The JAX pipeline runs without its last transform, ``HostConvPlan``: it only
adds the stem conv plan (a pure function of ``grid_coord``, no random
draw), which the port builds on the card instead. Its GridSample takes its
numpy path, the one it takes where the host C++ library is not built: the
port copies that path (the C++ reservoir sampler draws another, equally
distributed stream)."""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu.utils.config import Config as JConfig  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config as TConfig  # noqa: E402

FLAGSHIP = "configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py"
D_LANG = 16
POINT_MAX = 1500  # SphereCrop bound, below the scenes' voxel counts
NUM_POINTS = 2048  # collate budget: a Mix3D pair of crops goes over it
SEG_KEY = {"Matterport3D_160_GSDataset": "segment_nyu_160",
           "ScanNetPPGSDataset": "segment", "ScanNet200GSDataset": "segment200"}


def _write_scene(path, rng, seg_key):
    n = int(rng.integers(2500, 3500))
    os.makedirs(path)
    coord = rng.uniform(0, [1.6, 1.6, 0.8], (n, 3)).astype(np.float32)
    seg = rng.integers(0, 8, n).astype(np.int16)
    emb = rng.normal(size=(8, D_LANG))
    assets = {
        "coord": coord, "color": rng.uniform(0, 255, (n, 3)).astype(np.float32),
        "opacity": rng.uniform(0, 1, n).astype(np.float32),
        "quat": rng.normal(size=(n, 4)).astype(np.float32),
        "scale": rng.uniform(0, 2, (n, 3)).astype(np.float32),  # some clip at 1.5
        seg_key: seg,
        "lang_feat": (emb[seg] + 0.1 * rng.normal(size=(n, D_LANG))).astype(np.float16),
        "valid_feat_mask": rng.random(n) > 0.2,
        "normal": rng.normal(size=(n, 3)).astype(np.float32),  # not collected
    }
    for key, value in assets.items():
        np.save(os.path.join(path, f"{key}.npy"), value)


@pytest.fixture(scope="module")
def flagship_data(tmp_path_factory):
    """Data roots for the three datasets and the flagship train dataset
    config pointed at them."""
    root = tmp_path_factory.mktemp("gs_flagship")
    rng = np.random.default_rng(17)
    cfg = JConfig.fromfile(FLAGSHIP).to_dict()
    train = copy.deepcopy(cfg["data"]["train"])
    for ds, count in zip(train["datasets"], (3, 3, 2)):
        ds["data_root"] = str(root / ds["type"])
        for i in range(count):
            _write_scene(os.path.join(ds["data_root"], ds["split"][i % 2], f"scene{i:03d}"),
                         rng, SEG_KEY[ds["type"]])
        for t in ds["transform"]:
            if t["type"] == "SphereCrop":
                t["point_max"] = POINT_MAX
    return train


@pytest.fixture(autouse=True)
def _jax_numpy_grid_sample(monkeypatch):
    from scenesplat_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


def _jax_cfg(train):
    """The JAX side's copy: HostConvPlan dropped (see the module docstring)."""
    cfg = copy.deepcopy(train)
    for ds in cfg["datasets"]:
        assert ds["transform"][-1]["type"] == "HostConvPlan"
        ds["transform"] = ds["transform"][:-1]
    return cfg


def _assert_same(got, ref):
    assert sorted(got) == sorted(ref)
    for key in ref:
        g, r = got[key], ref[key]
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape, key
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            assert g == r, key


def test_config_reads_the_flagship_file_as_jax_does():
    ours, ref = TConfig.fromfile(FLAGSHIP), JConfig.fromfile(FLAGSHIP)
    assert ours.to_dict() == ref.to_dict()
    opts = ["epoch=4", "model.backbone.drop_path=0.1", "data.num_points=1024",
            "save_path=exp/x"]
    ours.merge_from_options(opts)
    ref.merge_from_options(opts)
    assert ours.to_dict() == ref.to_dict()
    assert ours.model.backbone.drop_path == 0.1 and ours.epoch == 4


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flagship_transforms_equal_jax(flagship_data, seed):
    ds_cfg = flagship_data["datasets"][seed % 3]
    tds = tdata.build_dataset(copy.deepcopy(ds_cfg))
    jds = jdata.build_dataset(_jax_cfg(dict(type="ConcatDataset",
                                            datasets=[ds_cfg]))["datasets"][0])
    for idx in range(2):
        ttf.seed_transforms((seed, 0, idx, 0))
        got = tds[idx]
        jtf.seed_transforms((seed, 0, idx, 0))
        ref = jds[idx]
        _assert_same(got, ref)
        assert got["coord"].shape[0] == POINT_MAX  # the crop ran
        assert set(got) >= {"coord", "grid_coord", "feat", "segment", "lang_feat",
                            "valid_feat_mask"}


def test_host_conv_plan_is_a_no_op():
    sample = {"grid_coord": np.zeros((5, 3), np.int32)}
    assert ttf.TRANSFORMS.build(dict(type="HostConvPlan", kernel_size=5,
                                     extent=(1024,) * 3))(dict(sample)) == sample


@pytest.mark.parametrize("mix_prob,num_points", [(0.8, NUM_POINTS), (0.0, 1024), (1.0, 4096)])
def test_collate_padded_equals_jax(flagship_data, mix_prob, num_points):
    tds = tdata.build_dataset(copy.deepcopy(flagship_data["datasets"][0]))
    samples = []
    for i in range(6):
        ttf.seed_transforms((5, 0, i, 0))
        samples.append(tds[i % len(tds)])
    ttf.seed_transforms((5, 0, 0, 1))
    got = tdata.collate_padded([dict(s) for s in samples], num_points, mix_prob=mix_prob)
    jtf.seed_transforms((5, 0, 0, 1))
    ref = jdata.collate_padded([dict(s) for s in samples], num_points, mix_prob=mix_prob)
    _assert_same(got, ref)
    b = 3 if mix_prob > 0 else 6
    assert got["mask"].shape == (b, num_points)
    assert got["lang_feat"].dtype == np.float16 and got["segment"].dtype == np.int32


def test_loaders_first_batches_equal_jax(flagship_data):
    """MultiDatasetLoader over the flagship ConcatDataset (loop ratios 3, 2,
    2) and a Loader over one child, batch 2 with Mix3D 0.8: the first
    batches of two epochs equal the JAX loaders' for the same seed."""
    tcat = tdata.build_dataset(copy.deepcopy(flagship_data))
    jcat = jdata.build_dataset(_jax_cfg(flagship_data))
    kw = dict(batch_size=2, num_points=NUM_POINTS, mix_prob=0.8, seed=3, num_workers=2)
    tl, jl = tdata.MultiDatasetLoader(tcat, **kw), jdata.MultiDatasetLoader(jcat, **kw)
    assert len(tl) == len(jl) > 0
    for epoch in (0, 1):
        tl.set_epoch(epoch)
        jl.set_epoch(epoch)
        for i, (got, ref) in enumerate(zip(tl, jl)):
            _assert_same(got, ref)
            if i == 2:
                break
    t1 = tdata.Loader(tcat.datasets[1], **kw)
    j1 = jdata.Loader(jcat.datasets[1], **kw)
    assert len(t1) == len(j1) > 0
    _assert_same(next(iter(t1)), next(iter(j1)))
