"""Port parity, the training step and the trainer.

1. One train step of a tiny LangPretrainer (the MINI backbone of
   tests/test_full_model_golden.py) against the JAX package's: the JAX
   weights carried over by ``utils/weights.py``, the serialization drawn
   with a shuffle key in JAX outside the model and its ``perm`` handed to
   the port, the contrastive split drawn by JAX. The loss, every parameter
   gradient (through the same key mapping) and the BatchNorm running
   statistics after the step equal JAX's ``loss_fn``
   (``scenesplat_tpu/engines/train_step.py``), whose gradient is jitted at
   this size (under 20 s; eager dispatch takes over a minute).
2. ``python -m scenesplat_tpu_torch.train`` end to end on the CPU over a
   synthetic 3DGS dataset in the layout of tests/test_engine.py: the
   flagship config file at tiny widths, two epochs, a falling loss,
   checkpoints, and a resumed run whose next-step loss equals the
   uninterrupted run's."""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import MINI  # noqa: E402
from tests.test_torch_model import _case  # noqa: E402
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)

FLAGSHIP = "configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py"
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # relative L2 per gradient tensor
# the bias of a linear layer whose every consumer is a BatchNorm (the last
# encoder block's fc2 before pooling and skip, the pooling and unpooling
# projections) has a zero gradient in exact arithmetic: the batch mean
# cancels it. Both sides then hold rounding noise, below this share of the
# global gradient norm
ZERO_GRAD = 1e-7
CRITERIA = [
    dict(type="CosineSimilarity", reduction="mean", loss_weight=1.0),
    dict(type="L2Loss", reduction="mean", loss_weight=1.0),
    dict(type="AggregatedContrastiveLoss", temperature=0.2, reduction="mean",
         loss_weight=0.02, schedule="last_75", num_classes=256, min_samples=20),
]


@pytest.fixture(scope="module")
def step_case():
    """MINI with 2 curves, batch of one padded scene, lang targets by class."""
    case = _case(MINI, (0.5,), seed=12, pad=16)
    rng = np.random.default_rng(13)
    n, d = len(case["mask"]), MINI["dec_channels"][0]
    seg = rng.integers(0, 5, n).astype(np.int32)
    seg[~case["mask"]] = -1
    emb = rng.normal(size=(5, d)).astype(np.float32)
    case["batch"] = dict(
        segment=seg[None],
        lang_feat=(emb[np.maximum(seg, 0)] + 0.2 * rng.normal(size=(n, d)))
        .astype(np.float16)[None],
        valid_feat_mask=(rng.random(n) > 0.1)[None])
    return case


def _jax_loss_fn(case, key):
    """engines/train_step.py:loss_fn, task "lang", with the point serialized
    (and its curves shuffled) outside the model."""
    from scenesplat_tpu.models.losses.builder import build_criteria

    criteria = build_criteria(CRITERIA)
    k_shuffle, k_drop, k_loss = jax.random.split(key, 3)
    point = case["point"].serialized(MINI["order"], depth=16, shuffle_rng=k_shuffle)
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}

    def loss_fn(params):
        out, updates = case["model"].apply(
            {"params": params, "batch_stats": case["stats"]}, point, train=True,
            rngs={"dropout": k_drop, "shuffle": k_shuffle}, mutable=["batch_stats"])
        loss = criteria(out.feat, batch["lang_feat"].astype(jnp.float32),
                        valid_feat_mask=batch["valid_feat_mask"], mask=out.mask,
                        segment=batch["segment"], epoch_progress=1.0, rng=k_loss)
        return loss, updates["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(case["params"])
    split = np.array(jax.random.bernoulli(k_loss, 0.5, (case["batch"]["segment"].size,)))
    return float(loss), grads, stats, np.asarray(point.ser.perm).tolist(), split


def test_train_step_matches_jax_loss_fn(step_case):
    from scenesplat_tpu_torch.engines.train_step import lang_loss
    from scenesplat_tpu_torch.models import build_criteria
    from scenesplat_tpu_torch.ops.serialization import serialize
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_model import _torch_model

    case = step_case
    ref_loss, ref_grads, ref_stats, perm, split = _jax_loss_fn(case, jax.random.PRNGKey(4))
    assert perm == [1, 0]  # this key does shuffle the two curves

    model = _torch_model(MINI, (0.5,), case["params"], case["stats"]).train()

    def t(x):
        return torch.from_numpy(np.array(x))

    grid, mask = t(case["grid"])[None], t(case["mask"])[None]
    ser = dataclasses.replace(serialize(grid, mask, MINI["order"], 16), perm=tuple(perm))
    batch = dict(coord=t(case["coord"])[None], feat=t(case["feat"])[None], grid_coord=grid,
                 mask=mask, ser=ser, **{k: t(v) for k, v in case["batch"].items()})
    loss, _ = lang_loss(model, build_criteria(CRITERIA), batch, epoch_progress=1.0,
                        split=t(split))
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=LOSS_RTOL)

    want = state_dict_from_flax(ref_grads, {})
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(float((w ** 2).sum()) for w in want.values()))
    zero = []
    for name, g in got.items():
        w = want[name]
        if np.linalg.norm(w) < ZERO_GRAD * total:
            assert np.linalg.norm(g) < ZERO_GRAD * total, name
            zero.append(name)
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= GRAD_RTOL, (name, err)
    assert len(zero) == 5, zero  # see ZERO_GRAD

    after = state_dict_from_flax(case["params"], ref_stats)
    state = model.state_dict()
    stat_keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(stat_keys) >= 6
    for key in stat_keys:
        np.testing.assert_allclose(state[key].numpy(), after[key], rtol=1e-5, atol=1e-6,
                                   err_msg=key)


D_LANG, N_CLASSES = 16, 6


@pytest.fixture(scope="module")
def gs_root(tmp_path_factory):
    """Train scenes in the layout of tests/test_engine.py: root/train/scene."""
    root = tmp_path_factory.mktemp("port_gs")
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(N_CLASSES, D_LANG)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for i in range(4):
        scene = root / "train" / f"scene{i:04d}"
        scene.mkdir(parents=True)
        n = int(rng.integers(500, 900))
        seg = rng.integers(0, N_CLASSES, n).astype(np.int16)
        assets = dict(
            coord=rng.uniform(0, 3, (n, 3)).astype(np.float32),
            color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 1, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, (n,)).astype(np.float32), segment=seg,
            lang_feat=(emb[seg] + 0.05 * rng.normal(size=(n, D_LANG))).astype(np.float16),
            valid_feat_mask=rng.random(n) > 0.2)
        for key, value in assets.items():
            np.save(scene / f"{key}.npy", value)
    return str(root)


TINY = dict(enc_depths=(1, 1, 1, 1), enc_channels=(16, 16, 32, 32), enc_num_head=(1, 1, 2, 2),
            enc_patch_size=(64,) * 4, dec_depths=(1, 1, 1), dec_channels=(D_LANG, 16, 32),
            dec_num_head=(1, 1, 2), dec_patch_size=(64,) * 3, dtype="float32")


def _tiny_flagship(root, save_path):
    """The flagship config file with tiny widths and data, its losses,
    optimizer, schedule, param groups, drop-path, curve shuffle, Mix3D and
    transforms kept; only the ported hooks."""
    from scenesplat_tpu_torch.utils.config import Config

    cfg = Config.fromfile(FLAGSHIP)
    cfg.merge_from_options(dict(
        save_path=save_path, epoch=2, eval_epoch=2, batch_size=2, num_worker=2,
        hooks=[dict(type="CheckpointLoader"), dict(type="IterationTimer", warmup_iter=2),
               dict(type="InformationWriter", log_interval=1),
               dict(type="CheckpointSaver", save_freq=1)]))
    cfg.data.num_points = 1024
    cfg.model.backbone.update(TINY)
    cfg.model.criteria[2]["min_samples"] = 5
    for ds in cfg.data.train.datasets:
        ds["data_root"], ds["split"] = root, "train"
        for t in ds["transform"]:
            if t["type"] == "SphereCrop":
                t["point_max"] = 600
            if t["type"] == "GridSample":
                t["grid_size"] = 0.05
    return cfg


def _losses(metrics_file):
    """Per-step losses of metrics.json; the record written after each epoch
    repeats the last step's scalars and is skipped."""
    losses, last = [], None
    with open(metrics_file) as f:
        for line in f:
            rec = json.loads(line)
            rec.pop("iteration")
            if rec != last:
                losses.append(rec["loss"])
            last = rec
    return losses


def test_train_entry_two_epochs_checkpoints_and_resume(gs_root, tmp_path):
    from scenesplat_tpu_torch import train as entry
    from scenesplat_tpu_torch.engines.train import build_trainer

    cfg_file = tmp_path / "tiny_flagship.py"
    _tiny_flagship(gs_root, str(tmp_path / "unused")).dump(str(cfg_file))
    exp = tmp_path / "exp"
    assert entry.main(["--config-file", str(cfg_file), "--device", "cpu",
                       "--options", f"save_path={exp}"]) == 0
    losses = _losses(exp / "metrics.json")
    steps = len(losses) // 2
    assert steps >= 4 and len(losses) == 2 * steps
    assert np.isfinite(losses).all()
    assert np.mean(losses[steps:]) < np.mean(losses[:steps])  # it learns
    for name in ("model_last.pth", "epoch_1.pth", "epoch_2.pth"):
        assert (exp / "model" / name).exists(), name
    assert (exp / "config.py").exists()

    # resume from the first epoch's checkpoint: the next step's loss is the
    # uninterrupted run's
    cfg = _tiny_flagship(gs_root, str(tmp_path / "resumed"))
    cfg.merge_from_options(dict(weight=str(exp / "model" / "epoch_1.pth"), resume=True))
    trainer = build_trainer(cfg, device="cpu")
    trainer.train()
    resumed = trainer.storage.history("loss").values()
    assert trainer.start_epoch == 1 and len(resumed) == steps
    np.testing.assert_allclose(resumed, losses[steps:], rtol=1e-6)


def test_unported_hook_raises(gs_root, tmp_path):
    """A hook type that no registry holds (the port registers every hook of
    the JAX package): building the trainer with one raises instead of
    skipping it."""
    from scenesplat_tpu_torch.engines.train import build_trainer

    cfg = _tiny_flagship(gs_root, str(tmp_path / "exp"))
    cfg.hooks = cfg.hooks + [dict(type="NoSuchEvaluator")]
    with pytest.raises(KeyError):
        build_trainer(cfg, device="cpu")
