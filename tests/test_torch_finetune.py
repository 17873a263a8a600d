"""Port parity, pretraining to fine-tuning: the non-strict
``CheckpointLoader`` (the reference's loader: the JAX hook restores a whole
train state and cannot warm-start) and the SSL backbone extraction
(``scenesplat_tpu_torch/utils/ckpt.py``, ``python -m
scenesplat_tpu_torch.rename_ckpt``) against the JAX package's
``tools/rename_ckpt_dino_to_ptv3.py``.

Weights are made with numpy at the JAX models' shapes and cross into the
port through ``utils/weights.py:state_dict_from_flax``. The backbones are
tiny: the SSL one at the SSL files' 11 input channels, the semseg one at
the semseg files' 14, so a warm start skips the stem by its shape. Then
the chain on the CPU through the entry points: a 2-step SSL train, the
extraction, and the semseg train entry with ``weight=``."""

import json
import logging
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)

from tests.test_torch_semseg import gs_root  # noqa: E402,F401 (fixture)
from tests.test_torch_ssl import (  # noqa: E402
    SSL_TINY,
    jax_point,
    jax_ssl_model,
    numpy_variables,
    ssl_crop,
    stack_crops,
    variable_shapes,
)
from tests.test_torch_ssl_data import SSL, ssl_root  # noqa: E402,F401 (fixture)
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)

SEMSEG = "configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py"
NUM_CLASSES = 8
STEM = "backbone.embedding.stem.conv.weight"


class _Log(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _trainer(model, **cfg):
    """What CheckpointLoader reads of a trainer."""
    logger = logging.getLogger(f"finetune{id(model)}")
    logger.setLevel(logging.INFO)
    log = _Log()
    logger.addHandler(log)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    return SimpleNamespace(cfg=cfg, model=model, logger=logger, log=log, optimizer=optimizer,
                           scheduler=None, generator=torch.Generator(), start_epoch=0,
                           storage=SimpleNamespace(iter=0), comm_info={})


def _load(model, weight, **hook_kwargs):
    """CheckpointLoader's before_train on ``model`` from ``weight``; returns
    the fake trainer (with its log lines)."""
    from scenesplat_tpu_torch.engines.hooks.misc import CheckpointLoader

    trainer = _trainer(model, weight=str(weight))
    hook = CheckpointLoader(**hook_kwargs)
    hook.trainer = trainer
    hook.before_train()
    return trainer


def _segmentor(backbone, seed=3):
    from scenesplat_tpu_torch.models import build_model

    return build_model(dict(type="DefaultSegmentorV2", num_classes=NUM_CLASSES,
                            backbone_out_channels=backbone["dec_channels"][0],
                            backbone=dict(backbone, seed=seed)))


def _lang(backbone, seed=3):
    from scenesplat_tpu_torch.models import build_model

    return build_model(dict(type="LangPretrainer", backbone=dict(backbone, seed=seed)))


@pytest.fixture(scope="module")
def ssl_ckpt(tmp_path_factory):
    """A SimDINOSSL checkpoint of the port (CheckpointSaver's layout) from
    numpy-made student, teacher and heads at SSL_TINY's shapes, and the
    flax trees it came from."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    rng = np.random.default_rng(19)
    crops = stack_crops([ssl_crop(rng, 24, 112)])
    shapes = variable_shapes(jax_ssl_model(), jax_point(crops))
    params, stats = numpy_variables(shapes, rng)
    t_params, t_stats = numpy_variables(shapes, rng)
    state = state_dict_from_flax(params, stats, teacher_params=t_params["backbone_module"],
                                 teacher_batch_stats=t_stats["backbone_module"])
    path = tmp_path_factory.mktemp("ssl_ckpt") / "model_last.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(np.array(v)) for k, v in state.items()},
                    step=2, epoch=1), path)
    return dict(path=path, state=state, params=params, stats=stats, t_params=t_params,
                t_stats=t_stats)


def _extract(ssl_ckpt, tmp_path, source):
    from scenesplat_tpu_torch import rename_ckpt

    out = tmp_path / f"{source}.pth"
    assert rename_ckpt.main(["--input", str(ssl_ckpt["path"]), "--output", str(out),
                             "--source", source]) == 0
    return out


@pytest.mark.parametrize("source", ["teacher", "student"])
def test_extraction_equals_the_jax_tool(ssl_ckpt, tmp_path, source, monkeypatch):
    """The JAX tool run on the same numpy weights (an orbax checkpoint of
    the SSL train state's layout) picks ``teacher_params`` or
    ``params.backbone_module`` with their statistics; that pick through the
    port's export mapping equals the port's extraction, tensor for tensor,
    less the mask token, which neither fine-tune model has."""
    import orbax.checkpoint as ocp

    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    src, dst = tmp_path / "jax_ssl", tmp_path / "jax_backbone"
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(src), dict(params=ssl_ckpt["params"], batch_stats=ssl_ckpt["stats"],
                              teacher_params=ssl_ckpt["t_params"]["backbone_module"],
                              teacher_batch_stats=ssl_ckpt["t_stats"]["backbone_module"]))
    ckptr.wait_until_finished()
    sys.path.insert(0, "tools")
    try:
        import rename_ckpt_dino_to_ptv3 as jtool
    finally:
        sys.path.remove("tools")
    monkeypatch.setattr(sys, "argv", ["rename", "--input", str(src), "--output", str(dst),
                                      "--source", source])
    jtool.main()
    picked = ocp.StandardCheckpointer().restore(str(dst))
    want = state_dict_from_flax(picked["params"], picked["batch_stats"])
    assert want.pop("backbone.mask_token").shape == (1, SSL_TINY["enc_channels"][0])

    got = torch.load(_extract(ssl_ckpt, tmp_path, source), weights_only=False)["state_dict"]
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    # the teacher and the student differ: the pick is the asked one
    other = "student" if source == "teacher" else "teacher"
    other_state = torch.load(_extract(ssl_ckpt, tmp_path, other), weights_only=False)
    assert not torch.equal(other_state["state_dict"][STEM], got[STEM])


def test_teacher_warm_starts_segmentor_and_lang_pretrainer(ssl_ckpt, tmp_path):
    """The extracted teacher into DefaultSegmentorV2 at 14 input channels:
    every backbone tensor but the stem's is the teacher's bit for bit, the
    stem and seg_head keep their initialization, and the log names each
    one; into a LangPretrainer at the SSL files' 11 channels every tensor
    loads."""
    weight = _extract(ssl_ckpt, tmp_path, "teacher")
    teacher = {k[len("teacher."):]: v for k, v in ssl_ckpt["state"].items()
               if k.startswith("teacher.") and k != "teacher.mask_token"}

    seg = _segmentor(dict(SSL_TINY, in_channels=14))
    init = {k: v.clone() for k, v in seg.state_dict().items()}
    trainer = _load(seg, weight)
    state = seg.state_dict()
    for key, value in teacher.items():
        if key == "embedding.stem.conv.weight":
            continue
        np.testing.assert_array_equal(state["backbone." + key].numpy(), value, err_msg=key)
    kept = [k for k in state
            if not (k.startswith("backbone.") and k[len("backbone."):] in teacher) or k == STEM]
    assert sorted(kept) == [STEM, "seg_head.bias", "seg_head.weight"]
    for key in kept:
        assert torch.equal(state[key], init[key]), key
    log = "\n".join(trainer.log.lines)
    assert f"skipped {STEM}: shape (5, 5, 5, 11, 16) in the checkpoint" in log
    for key in kept:
        assert f"kept the initialization of {key}" in log

    lang = _lang(SSL_TINY)
    trainer = _load(lang, weight)
    state = lang.state_dict()
    assert sorted(state) == sorted("backbone." + k for k in teacher)
    for key, value in teacher.items():
        np.testing.assert_array_equal(state["backbone." + key].numpy(), value, err_msg=key)
    assert not any("skipped" in line or "kept" in line for line in trainer.log.lines)


def test_vl_checkpoint_warm_starts_segmentor(tmp_path):
    """A LangPretrainer checkpoint (CheckpointSaver's layout, the DDP
    ``module.`` prefix on its names) of numpy-made weights into
    DefaultSegmentorV2: the backbone loads, the stem (11 vs 14 channels)
    and seg_head keep their initialization."""
    from scenesplat_tpu.models import build_model as jbuild
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_model import _numpy_variables

    backbone = {k: v for k, v in SSL_TINY.items() if k != "type"}
    jmodel = jbuild(dict(type="LangPretrainer", backbone=dict(type="PT-v3m1", **backbone,
                                                              use_pallas=False)))
    point = jax_point(stack_crops([ssl_crop(np.random.default_rng(2), 24, 112)]))
    params, stats = _numpy_variables(jmodel, point, np.random.default_rng(29))
    state = state_dict_from_flax(params, stats)
    weight = tmp_path / "vl.pth"
    torch.save(dict(state_dict={"module." + k: torch.from_numpy(np.array(v))
                                for k, v in state.items()}), weight)
    seg = _segmentor(dict(SSL_TINY, in_channels=14))
    init = {k: v.clone() for k, v in seg.state_dict().items()}
    trainer = _load(seg, weight)
    got = seg.state_dict()
    loaded = [k for k in state if k != STEM]
    assert len(loaded) == len(state) - 1 > 50
    for key in loaded:
        np.testing.assert_array_equal(got[key].numpy(), state[key], err_msg=key)
    for key in (STEM, "seg_head.weight", "seg_head.bias"):
        assert torch.equal(got[key], init[key]), key
    assert f"loaded {len(loaded)} of the model's {len(got)} tensors" in trainer.log.lines


def test_checkpoint_without_backbone_raises(ssl_ckpt, tmp_path):
    """No tensor of ``backbone.*`` name and shape: not a warm start. A
    file of heads only, and a backbone of other widths."""
    heads = tmp_path / "heads.pth"
    torch.save(dict(state_dict={k: torch.from_numpy(np.array(v)) for k, v in
                                ssl_ckpt["state"].items() if k.startswith("dino_head.")}), heads)
    with pytest.raises(ValueError, match="no backbone"):
        _load(_segmentor(dict(SSL_TINY, in_channels=14)), heads)
    wide = dict(SSL_TINY, in_channels=14, enc_channels=(24, 24, 48), dec_channels=(24, 24))
    with pytest.raises(ValueError, match="no backbone"):
        _load(_segmentor(wide), _extract(ssl_ckpt, tmp_path, "teacher"))


def test_strict_and_resume_load_every_tensor(ssl_ckpt, tmp_path):
    """``strict=True`` and ``resume=True`` refuse a checkpoint that does not
    match the model name for name; ``resume=True`` on the model's own
    checkpoint restores the weights, the optimizer, the generator, the
    step and the epoch."""
    from scenesplat_tpu_torch.engines.hooks.misc import CheckpointLoader

    weight = _extract(ssl_ckpt, tmp_path, "teacher")
    with pytest.raises(RuntimeError, match="seg_head"):
        _load(_segmentor(dict(SSL_TINY, in_channels=14)), weight, strict=True)

    src = _segmentor(dict(SSL_TINY, in_channels=14), seed=5)
    before = _trainer(src)
    for p in src.parameters():
        p.grad = torch.ones_like(p)
    before.optimizer.step()
    before.generator.manual_seed(77)
    own = tmp_path / "own.pth"
    torch.save(dict(state_dict=src.state_dict(), optimizer=before.optimizer.state_dict(),
                    scheduler=None, generator=before.generator.get_state(), step=12, epoch=3,
                    best_metric=0.25), own)
    for path, raises in ((weight, True), (own, False)):
        model = _segmentor(dict(SSL_TINY, in_channels=14))
        trainer = _trainer(model, weight=str(path), resume=True)
        hook = CheckpointLoader()
        hook.trainer = trainer
        if raises:
            with pytest.raises(RuntimeError):
                hook.before_train()
            continue
        hook.before_train()
        for key, value in src.state_dict().items():
            assert torch.equal(model.state_dict()[key], value), key
        assert trainer.optimizer.state_dict()["state"].keys() == \
            before.optimizer.state_dict()["state"].keys()
        assert (trainer.start_epoch, trainer.storage.iter) == (3, 12)
        assert trainer.comm_info["best_metric_value"] == 0.25
        assert torch.equal(trainer.generator.get_state(), before.generator.get_state())


# ---- the chain through the entry points ------------------------------------------

SSL_OPTIONS = [
    "epoch=1", "eval_epoch=1", "batch_size=1", "num_worker=2", "data.num_points=2048",
    "data.num_points_local=512", "model.backbone.enc_channels=(16,16,32,32,32)",
    "model.backbone.enc_num_head=(1,1,2,2,2)", "model.backbone.enc_depths=(1,1,1,1,1)",
    "model.backbone.dec_channels=(16,16,32,32)", "model.backbone.dec_num_head=(1,1,2,2)",
    "model.backbone.dec_depths=(1,1,1,1)", "model.backbone.enc_patch_size=(64,64,64,64,64)",
    "model.dino_hidden_dim=64", "model.ibot_hidden_dim=32"]


def test_pretrain_extract_finetune_chain(ssl_root, gs_root, tmp_path, monkeypatch):
    """``python -m scenesplat_tpu_torch.train`` on the SSL file (2 steps),
    ``python -m scenesplat_tpu_torch.rename_ckpt --source teacher``, then
    the train entry on the semseg file at the same widths with
    ``weight=``: it trains, its log names the stem and seg_head it kept,
    and the trainer it builds starts from the teacher's backbone bit for
    bit, the stem and seg_head at their initialization."""
    from scenesplat_tpu_torch import rename_ckpt
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.ops import bitonic_sort as tsort
    from tests.test_torch_semseg import _tiny_semseg

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    ssl_exp = tmp_path / "ssl"
    assert train_entry.main(["--config-file", SSL, "--device", "cpu", "--options",
                             f"save_path={ssl_exp}", f"data.train.data_root={ssl_root}",
                             *SSL_OPTIONS]) == 0
    backbone = tmp_path / "teacher.pth"
    assert rename_ckpt.main(["--input", str(ssl_exp / "model" / "model_last.pth"),
                             "--output", str(backbone)]) == 0
    teacher = {k[len("teacher."):]: v for k, v in torch.load(
        ssl_exp / "model" / "model_last.pth", weights_only=False)["state_dict"].items()
        if k.startswith("teacher.") and k != "teacher.mask_token"}

    exp = tmp_path / "semseg"
    cfg = _tiny_semseg(gs_root, str(exp))
    cfg.model.backbone.update(mlp_ratio=4, enc_patch_size=(64,) * 5, dec_patch_size=(64,) * 4)
    cfg.weight = str(backbone)
    cfg_file = tmp_path / "finetune.py"
    cfg.dump(str(cfg_file))
    logger, handler = logging.getLogger("scenesplat_tpu_torch"), _Log()
    logger.addHandler(handler)  # the framework logger does not propagate
    try:
        assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu"]) == 0
    finally:
        logger.removeHandler(handler)
    log = "\n".join(handler.lines)
    assert f"skipped {STEM}: shape (5, 5, 5, 11, 16) in the checkpoint, " \
           f"(5, 5, 5, 14, 16) in the model" in log
    for key in (STEM, "seg_head.weight", "seg_head.bias"):
        assert f"kept the initialization of {key}" in log
    with open(exp / "metrics.json") as f:
        losses = [json.loads(line)["loss"] for line in f if '"loss"' in line]
    assert losses and np.isfinite(losses).all()

    trainer = build_trainer(cfg, device="cpu")
    init = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    (hook,) = [h for h in trainer.hooks if type(h).__name__ == "CheckpointLoader"]
    hook.before_train()
    state = trainer.model.state_dict()
    assert sorted(k for k in state if k[len("backbone."):] not in teacher) == [
        "seg_head.bias", "seg_head.weight"]
    for key, value in teacher.items():
        want = init["backbone." + key] if key == "embedding.stem.conv.weight" else value
        assert torch.equal(state["backbone." + key], want), key
