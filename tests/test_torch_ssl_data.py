"""Port parity, the SSL files' data path and trainer: the multi-crop
pipeline of ``configs/_base_/gs_pipelines.py:ssl_train_transform``
(colour jitter, grayscale, solarize, SphereCropRandomMaxPoints, the view
generator, the opacity-masked voxel blur, CollectContrast) and
``collate_ssl`` equal the JAX package's under one seed, bit for bit;
``GenericGSDataset``'s clips; the three shipped ``ssl-pretrain-*`` files
build in the port (model at the shipped widths, optimizer with its groups,
schedule, datasets with transforms, hooks, trainer); and
``python -m scenesplat_tpu_torch.train --device cpu`` runs the ScanNet file
cut by ``--options`` for two steps and writes its checkpoint.

The JAX GridSample takes its numpy path, as in tests/test_torch_test.py."""

import importlib.util
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.data import transforms as jtf  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.data import transforms as ttf  # noqa: E402
from scenesplat_tpu_torch.utils.config import Config  # noqa: E402
from tests.test_torch_test import _assert_same, one_torch_thread  # noqa: E402,F401 (fixture)

SSL = "configs/scannet/ssl-pretrain-scannet-all-base.py"
SSL_FILES = (SSL, "configs/scannetpp/ssl-pretrain-scannetpp-all-base.py",
             "configs/concat_dataset/ssl-pretrain-concat-scan-ppv2-matt-3rscan-arkit-hyper-"
             "mcmc-base.py")
ROOT_VARS = ("SCANNET_GS_ROOT", "SCANNETPP_GS_ROOT", "THREERSCAN_GS_ROOT",
             "ARKITSCENES_GS_ROOT", "HYPERSIM_GS_ROOT", "MATTERPORT3D_GS_ROOT")
PREFIXES = ("global_crop0", "global_crop1", "local_crop0", "local_crop1", "local_crop2")


@pytest.fixture(autouse=True)
def _jax_numpy_grid_sample(monkeypatch):
    from scenesplat_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)


def _pipelines():
    spec = importlib.util.spec_from_file_location("gs_pipelines",
                                                  "configs/_base_/gs_pipelines.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_scene(folder, rng, n, size=1.0):
    """An unlabeled 3DGS scene of ``n`` Gaussians in a ``size`` m cube on a
    1 cm lattice; some opacities under 1e-3 and scales outside [1e-4, 1]."""
    folder.mkdir(parents=True)
    cells = int(size / 0.01)
    lattice = rng.choice(cells ** 3, n, replace=False)
    coord = np.stack(np.unravel_index(lattice, (cells,) * 3), -1) * 0.01 + 0.005
    for key, value in dict(
            coord=coord.astype(np.float32), color=rng.uniform(0, 255, (n, 3)),
            quat=rng.normal(size=(n, 4)), scale=rng.uniform(-0.2, 1.3, (n, 3)),
            opacity=rng.uniform(-0.01, 1, n)).items():
        np.save(folder / f"{key}.npy", value.astype(np.float32))


@pytest.fixture(scope="module")
def ssl_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_ssl_gs")
    rng = np.random.default_rng(23)
    for i in range(2):
        _write_scene(root / "train" / f"scene{i:04d}_00", rng, int(rng.integers(2600, 3200)))
    return str(root)


def _dataset_cfg(root, jax_side=False, **transform_kwargs):
    """The SSL files' dataset over ``root``; for the JAX side without the
    collect's ``offset_keys_dict``, on which the JAX CollectContrast raises
    (test_jax_collect_contrast_refuses_the_shipped_offsets)."""
    transform = _pipelines().ssl_train_transform(**transform_kwargs)
    if jax_side:
        assert transform[-1]["type"] == "CollectContrast"
        transform[-1].pop("offset_keys_dict")
    return dict(type="GenericGSDataset", split="train", data_root=root, test_mode=False,
                transform=transform)


def test_generic_dataset_clips_equal_jax(ssl_root):
    """Opacity at least 1e-3, scale in [1e-4, 1], as the JAX dataset."""
    cfg = dict(type="GenericGSDataset", split="train", data_root=ssl_root, transform=None)
    got = tdata.build_dataset(dict(cfg)).get_data(1)
    ref = jdata.build_dataset(dict(cfg)).get_data(1)
    _assert_same(got, ref)
    raw = np.load(f"{ssl_root}/train/scene0001_00/opacity.npy")
    assert (raw < 1e-3).any() and got["opacity"].min() == np.float32(1e-3)
    assert got["scale"].min() == np.float32(1e-4) and got["scale"].max() == 1.0
    assert got["opacity"].shape == (len(raw), 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssl_transforms_and_collate_equal_jax(ssl_root, seed):
    """The shipped multi-crop pipeline (crops cut to this scene's size so
    each crops) and collate_ssl, port against JAX under one seed."""
    kwargs = dict(local_crop_num=3, point_max=2800, crop_point_max=2400)
    tds = tdata.build_dataset(_dataset_cfg(ssl_root, **kwargs))
    jds = jdata.build_dataset(_dataset_cfg(ssl_root, jax_side=True, **kwargs))
    samples = []
    for idx in range(2):
        ttf.seed_transforms((seed, 0, idx, 0))
        got = tds[idx]
        jtf.seed_transforms((seed, 0, idx, 0))
        ref = jds[idx]
        _assert_same(got, ref)
        assert {f"{p}_{k}" for p in PREFIXES for k in ("coord", "grid_coord", "feat")} <= set(got)
        assert got["global_crop0_feat"].shape[1] == 11
        assert len(got["local_crop0_coord"]) < len(got["global_crop0_coord"])  # crops cut
        samples.append(got)
    ttf.seed_transforms((seed, 0, 0, 1))
    got = tdata.collate.collate_ssl([dict(s) for s in samples], 2048, 600, local_crop_num=3)
    jtf.seed_transforms((seed, 0, 0, 1))
    ref = jdata.collate.collate_ssl([dict(s) for s in samples], 2048, 600, local_crop_num=3)
    _assert_same(got, ref)
    assert got["global_crop1_mask"].shape == (2, 2048) and got["local_crop2_feat"].shape == (
        2, 600, 11)
    for p, target in (("global_crop0", 2048), ("local_crop1", 600)):  # padded or subsampled
        counts = [min(len(smp[f"{p}_coord"]), target) for smp in samples]
        np.testing.assert_array_equal(got[f"{p}_mask"].sum(1), counts)
    assert got["global_crop0_grid_coord"].dtype == np.int32


def test_jax_collect_contrast_refuses_the_shipped_offsets():
    """A fault of the JAX package the port does not share: the shipped SSL
    pipeline's CollectContrast names ``offset_keys_dict``, which the JAX
    transform reads as feature keys (KeyError); the port's ignores it and
    otherwise equals the JAX transform."""
    collect = _pipelines().ssl_train_transform(local_crop_num=1)[-1]
    assert collect["type"] == "CollectContrast" and "offset_keys_dict" in collect
    rng = np.random.default_rng(1)
    sample = {f"{p}_{k}": rng.normal(size=(7, w)).astype(np.float32)
              for p in ("global_crop0", "global_crop1", "local_crop0")
              for k, w in (("coord", 3), ("color", 3), ("opacity", 1), ("quat", 4),
                           ("scale", 3))}
    with pytest.raises(KeyError, match="global_crop0_offset"):
        jtf.TRANSFORMS.build(dict(collect))(dict(sample))
    got = ttf.TRANSFORMS.build(dict(collect))(dict(sample))
    ref = jtf.TRANSFORMS.build({k: v for k, v in collect.items()
                                if k != "offset_keys_dict"})(dict(sample))
    _assert_same(got, ref)
    assert got["global_crop1_feat"].shape == (7, 11)


def test_blur_and_colour_transforms_equal_jax():
    """Each new transform alone, forced on, on one crop: bit-equal."""
    rng = np.random.default_rng(3)
    n = 900
    grid = rng.choice(40 ** 3, n, replace=False)
    base = dict(coord=(np.stack(np.unravel_index(grid, (40,) * 3), -1) * 0.02).astype(np.float32),
                grid_coord=np.stack(np.unravel_index(grid, (40,) * 3), -1).astype(np.int64),
                color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
                opacity=rng.uniform(0, 1, (n, 1)).astype(np.float32),
                quat=rng.normal(size=(n, 4)).astype(np.float32),
                scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32))
    for cfg in (dict(type="GSGaussianBlurVoxelOpc", p=1.0, extra_keys=("scale", "quat",
                                                                        "opacity")),
                dict(type="RandomColorJitter", brightness=0.4, contrast=0.4, saturation=0.2,
                     hue=0.1, p=1.0),
                dict(type="RandomColorGrayScale", p=1.0),
                dict(type="RandomColorSolarize", p=1.0),
                dict(type="SphereCropRandomMaxPoints", random_scale=(0.1, 0.4), point_max=2000),
                dict(type="SphereCropRandomMaxPoints", max_points=(300, 500))):
        ttf.seed_transforms(11)
        got = ttf.TRANSFORMS.build(dict(cfg))({k: v.copy() for k, v in base.items()})
        jtf.seed_transforms(11)
        ref = jtf.TRANSFORMS.build(dict(cfg))({k: v.copy() for k, v in base.items()})
        _assert_same(got, ref, cfg["type"])
        if cfg["type"] == "GSGaussianBlurVoxelOpc":
            assert not np.array_equal(got["color"], base["color"])
            np.testing.assert_allclose(np.linalg.norm(got["quat"], axis=1), 1, rtol=1e-5)


@pytest.mark.parametrize("path", SSL_FILES)
def test_shipped_ssl_config_builds_in_the_port(path, tmp_path, monkeypatch):
    """The trainer of each shipped SSL file builds on the CPU as the file
    stands: SimDINOSSL at the shipped widths with its teacher, AdamW with
    the "block" group, OneCycle, the GenericGSDataset(s) with the
    multi-crop transforms and collate_ssl, the hooks."""
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.models.ssl import SimDINOSSL

    rng = np.random.default_rng(2)
    for var in ROOT_VARS:
        _write_scene(tmp_path / var / "train" / "scene0000_00", rng, 400, size=0.2)
        monkeypatch.setenv(var, str(tmp_path / var))
    cfg = Config.fromfile(path)
    cfg.save_path = str(tmp_path / "exp")
    trainer = build_trainer(cfg, device="cpu")
    model = trainer.model
    assert type(trainer).__name__ == "DefaultSSLPreTrainer" and isinstance(model, SimDINOSSL)
    bb = cfg.model.backbone
    assert bb["in_channels"] == 11 and len(bb["enc_depths"]) == 5
    assert model.backbone.mask_token.shape == (1, 32)
    assert model.dino_head.fc1.weight.shape == (2048, 512)
    assert model.dino_head.fc3.weight.shape == (256, 2048)
    assert model.ibot_head.fc1.weight.shape == (256, 64)
    assert model.ibot_head.fc3.weight.shape == (32, 256)
    assert model.mae_fc2.weight.shape == (11, 32)
    student = sum(p.numel() for p in model.backbone.parameters())
    assert student == sum(p.numel() for p in model.teacher.parameters())
    trained = {id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    assert not trained & {id(p) for p in model.teacher.parameters()}
    assert [len(g["params"]) > 0 for g in trainer.optimizer.param_groups] == [True, True]
    assert trainer.optimizer.defaults["eps"] == 1e-4
    assert trainer.loss_kwargs == dict(
        local_crop_num=3, do_ema=True, do_ibot=True, enable_mae=True, dino_weight=1.0,
        ibot_weight=1.0, mae_weight=1.0, mask_type="patch", mask_grid_size=0.2,
        mask_ratio_min_max=(0.1, 0.5), mask_sample_probability=0.5)
    assert trainer.momentum_schedule(0) == pytest.approx(0.994)
    assert [type(h).__name__ for h in trainer.hooks] == [
        "CheckpointLoader", "IterationTimer", "InformationWriter", "CheckpointSaver"]
    loader = trainer.train_loader
    assert loader.collate_fn.keywords == dict(global_points=102400, local_points=25600,
                                              local_crop_num=3)
    datasets = getattr(loader.dataset, "datasets", [loader.dataset])
    assert len(datasets) == (6 if "concat" in path else 1)
    assert all(type(d).__name__ == "GenericGSDataset" for d in datasets)


def test_ssl_train_entry_two_steps(ssl_root, tmp_path):
    """``python -m scenesplat_tpu_torch.train --device cpu`` on the ScanNet
    SSL file cut by --options: two steps over two scenes (batch 1), every
    loss term logged and finite, the checkpoint with student and teacher."""
    from scenesplat_tpu_torch import train as train_entry

    exp = tmp_path / "exp"
    options = [
        f"save_path={exp}", "epoch=1", "eval_epoch=1", "batch_size=1", "num_worker=2",
        f"data.train.data_root={ssl_root}", "data.num_points=2048", "data.num_points_local=512",
        "model.backbone.enc_channels=(16,16,32,32,32)", "model.backbone.enc_num_head=(1,1,2,2,2)",
        "model.backbone.enc_depths=(1,1,1,1,1)", "model.backbone.dec_channels=(16,16,32,32)",
        "model.backbone.dec_num_head=(1,1,2,2)", "model.backbone.dec_depths=(1,1,1,1)",
        "model.backbone.enc_patch_size=(64,64,64,64,64)", "model.dino_hidden_dim=64",
        "model.ibot_hidden_dim=32"]
    assert train_entry.main(["--config-file", SSL, "--device", "cpu",
                             "--options", *options]) == 0
    with open(exp / "metrics.json") as f:
        records = [json.loads(line) for line in f]
    steps = [r for r in records if "loss" in r]  # step 0, then the epoch's end (step 1)
    assert [r["iteration"] for r in steps] == [0, 2]
    for key in ("loss", "grad_norm", "mcr_comp_loss", "mcr_expa_loss", "sim_dino_crops_loss",
                "sim_ibot_patch_loss", "global_mae_loss"):
        assert all(np.isfinite(r[key]) for r in steps), key
    ckpt = torch.load(exp / "model" / "model_last.pth", weights_only=False)
    state = ckpt["state_dict"]
    assert "backbone.mask_token" in state and "teacher.mask_token" in state
    assert ckpt["step"] == 2 and "mae_fc1.weight" in state
