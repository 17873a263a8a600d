"""Port parity, data parallel for semantic segmentation and SSL: N processes
of the port against one process at the same global batch, and against the
JAX package, whose losses span the global batch.

Ranks are separate processes (``tests/torch_dist_worker.py``, started by
``tests/test_torch_dist.py:run_ranks`` as torchrun starts them), on the CPU
over gloo with one torch thread each.

1. ``parallel/dist.py:all_gather_rows``: every rank's rows in rank order,
   rows of unequal counts, and its backward (each rank keeps its slot's
   cotangents summed over the ranks).
2. The losses whose reductions span the batch: CE + Lovasz (the semseg
   files' criteria), Lovasz alone, the class-weighted CE, MCR, the iBOT
   cosine loss and the legacy DINOLoss over 3 steps (with its centre);
   two ranks hold the JAX loss of the global batch (1e-5
   relative), and each rank's gradient of its rows, divided by the ranks'
   count (DDP's mean), is JAX's for those rows.
3. One semseg train step (CE + Lovasz, and the weighted CE) and one SSL
   step (every loss term, the EMA teacher) at drop-path 0.3 with the curve
   shuffle and the token masks drawn: two ranks equal one process (loss
   1e-5, every gradient 1e-4 of its norm, the BatchNorm statistics 1e-6;
   the teacher bit-equal on both ranks and within 1e-6 of one process, its
   mask token unmoved).
4. One PointGroup step (PG-v1m1 over a tiny SpUNet, the reference's CE and
   the two bias terms): two ranks equal one process at the same bars.
5. MSC-v1m1 (view mixing on, the masks and pairs drawn) and CAC-v1m1 over a
   tiny SpUNet, two steps each under DDP without find_unused_parameters:
   two ranks equal one process at the same bars.
6. One semseg step of DefaultSegmentor over a tiny PT-v2m2 at drop path 0.3
   (drawn at the global batch's shape): PointBatchNorm's moments over the
   valid points and over the valid neighbour slots span the global batch,
   so two ranks equal one process at the same bars."""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_dist import GRAD_RTOL, LOSS_RTOL, _assert_grads, run_ranks  # noqa: E402

STAT_RTOL, STAT_ATOL = 1e-6, 1e-7
TEACHER_ATOL = 1e-6
NUM_CLASSES = 8
CLASS_WEIGHTS = [0.5, 1.0, 2.0, 1.5, 0.8, 1.2, 3.0, 0.7]


# ---- the gather -------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3])
def test_all_gather_rows_and_its_backward(tmp_path, world):
    """Rows of 3, 5 (and 1) gathered in rank order on every rank, padding
    dropped; each rank's gradient of the same weighted sum is ``world``
    times the weights at its rows (the sum's backward), so DDP's mean
    gives the weights."""
    from scenesplat_tpu_torch.parallel import dist as pdist

    rng = np.random.default_rng(world)
    rows = [rng.normal(size=(n, 4)).astype(np.float32) for n in (3, 5, 1)[:world]]
    full = np.concatenate(rows)
    weights = rng.normal(size=full.shape).astype(np.float32)
    got = run_ranks(tmp_path, dict(kind="gather", rows=rows, weights=weights), world=world)
    start = 0
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["full"].numpy(), full)
        n = len(rows[r])
        np.testing.assert_allclose(res["grad"].numpy(), world * weights[start:start + n],
                                   rtol=1e-6)
        start += n
    x = torch.ones(2, 3)
    assert pdist.all_gather_rows(x) is x  # no group: the rows themselves


# ---- the losses against JAX's over the global batch ---------------------------------

def _unit_rows(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _semseg_criteria(weight=None, lovasz=True):
    from scenesplat_tpu_torch.utils.config import Config

    cfg = list(Config.fromfile("configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py")
               .model.criteria)
    assert [c["type"] for c in cfg] == ["CrossEntropyLoss", "LovaszLoss"]
    if weight is not None:
        cfg[0] = dict(cfg[0], weight=weight)
    return cfg if lovasz else cfg[:1]


def _loss_cases():
    """name -> (kind, config, global inputs): logits [4, 300, C] with
    ignored points, absent classes and a padding tail (tied errors in the
    first rows); MCR's 5 student and 2 teacher crops of 4 rows; 40 iBOT
    tokens with their weights; DINOLoss's 2 student and 2 teacher views of
    4 rows over 3 steps."""
    rng = np.random.default_rng(5)
    pred = (2 * rng.normal(size=(4, 300, NUM_CLASSES))).astype(np.float32)
    pred[:, :60] = pred[0, 0]
    target = rng.integers(0, NUM_CLASSES - 2, (4, 300)).astype(np.int32)
    target[rng.random((4, 300)) < 0.1] = -1
    mask = np.ones((4, 300), bool)
    mask[1, 230:] = False
    mask[3, 280:] = False
    seg = (pred, target, mask)
    tokens = (_unit_rows(rng, 40, 8), _unit_rows(rng, 40, 8),
              ((rng.random(40) < 0.4) * rng.uniform(0.1, 1, 40)).astype(np.float32))
    dino = tuple((2 * rng.normal(size=(3, 2, 4, 16))).astype(np.float32) for _ in range(2))
    return {
        "dino": ("dino", dict(student_temp=0.1, center_momentum=0.8), dino),
        "ce_lovasz": ("criteria", _semseg_criteria(), seg),
        "lovasz": ("criteria", _semseg_criteria()[1:], seg),
        "ce_weighted": ("criteria", _semseg_criteria(CLASS_WEIGHTS, lovasz=False), seg),
        "mcr": ("mcr", None, (_unit_rows(rng, 5, 4, 16), _unit_rows(rng, 2, 4, 16))),
        "cosine": ("cosine", None, tokens),
    }


def _jax_loss(kind, cfg, inputs):
    """The JAX package's loss of the whole batch and its gradient with
    respect to the first input (the student's side)."""
    from scenesplat_tpu.models.losses.builder import build_criteria
    from scenesplat_tpu.models.ssl import cosine_patch_loss, mcr_loss

    if kind == "criteria":
        crit = build_criteria(cfg)

        def fn(p):
            return crit(p, jnp.asarray(inputs[1]), mask=jnp.asarray(inputs[2]))
    elif kind == "mcr":
        def fn(s):
            return mcr_loss(list(s), list(jnp.asarray(inputs[1])))[0]
    else:
        def fn(s):
            return cosine_patch_loss(s, jnp.asarray(inputs[1]), jnp.asarray(inputs[2]))
    value, grad = jax.value_and_grad(fn)(jnp.asarray(inputs[0]))
    return float(value), np.asarray(grad)


@pytest.fixture(scope="module")
def two_rank_losses(tmp_path_factory):
    cases = _loss_cases()
    return cases, run_ranks(tmp_path_factory.mktemp("dist_losses"),
                            dict(kind="losses", losses=cases))


@pytest.mark.parametrize("name", ["ce_lovasz", "lovasz", "ce_weighted", "mcr", "cosine"])
def test_two_ranks_loss_equals_jax_global_batch(two_rank_losses, name):
    cases, ranks = two_rank_losses
    kind, cfg, inputs = cases[name]
    want, want_grad = _jax_loss(kind, cfg, inputs)
    axis = 1 if kind == "mcr" else 0
    assert ranks[0][name]["loss"] == ranks[1][name]["loss"]  # one global loss
    np.testing.assert_allclose(ranks[0][name]["loss"], want, rtol=LOSS_RTOL)
    grad = np.concatenate([r[name]["grads"][0].numpy() for r in ranks], axis=axis) / 2
    scale = np.abs(want_grad).max()
    assert scale > 0
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=GRAD_RTOL * scale)


def test_two_ranks_dino_loss_and_centre_equal_jax_global_batch(two_rank_losses):
    """DINOLoss over 3 steps on two ranks of 2 rows each: every step's loss
    is JAX's over the 4 rows on both ranks, each rank's student gradient
    over the ranks' count (DDP's mean) is JAX's at its rows, and the centre,
    the teacher views' mean over the global batch through the EMA, is
    JAX's on both ranks (1e-6)."""
    from scenesplat_tpu.models.losses.dino_legacy import DINOLoss

    cases, ranks = two_rank_losses
    _, cfg, (students, teachers) = cases["dino"]
    module = DINOLoss(out_dim=16, **cfg)
    state = module.init(jax.random.PRNGKey(0), list(students[0]), list(teachers[0]), 0.05)
    for step in range(3):
        (want, state), want_grad = jax.value_and_grad(
            lambda s, state=state: module.apply(state, list(s), list(jnp.asarray(teachers[step])),
                                                0.05, mutable=["state"]), has_aux=True)(
            jnp.asarray(students[step]))
        assert ranks[0]["dino"]["loss"][step] == ranks[1]["dino"]["loss"][step]
        np.testing.assert_allclose(ranks[0]["dino"]["loss"][step], float(want), rtol=LOSS_RTOL)
        grad = np.concatenate([r["dino"]["grads"][step].numpy() for r in ranks], axis=1) / 2
        np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=0,
                                   atol=GRAD_RTOL * np.abs(want_grad).max())
    for r in ranks:
        np.testing.assert_allclose(r["dino"]["center"].numpy(),
                                   np.asarray(state["state"]["center"]), rtol=1e-6, atol=1e-7)


# ---- one step: two ranks against one process ---------------------------------------

def _semseg_rows():
    """Two scenes whose pooled counts halve exactly at each of the 4
    poolings, padded to 528 slots, 14 input channels, labels with ignored
    points; numpy-made weights of the JAX segmentor as the port's state
    dict."""
    from scenesplat_tpu.models import PointBatch
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_full_model_golden import _make_scene
    from tests.test_torch_model import _numpy_variables
    from tests.test_torch_semseg import TINY, _jax_segmentor

    rng = np.random.default_rng(37)
    n = 528
    cols = dict(coord=[], grid_coord=[], feat=[], mask=[], segment=[])
    for _ in range(2):
        coord, grid, _ = _make_scene(rng, n_parents=32, levels=4)
        pad = n - len(grid)
        cols["coord"].append(np.concatenate([coord, np.zeros((pad, 3), np.float32)]))
        cols["grid_coord"].append(np.concatenate([grid, np.zeros((pad, 3), np.int32)]))
        feat = rng.normal(size=(len(grid), TINY["in_channels"])).astype(np.float32)
        cols["feat"].append(np.concatenate([feat, np.zeros((pad, feat.shape[1]), np.float32)]))
        mask = np.arange(n) < len(grid)
        seg = rng.integers(0, NUM_CLASSES - 2, n).astype(np.int64)
        seg[(rng.random(n) < 0.1) | ~mask] = -1
        cols["mask"].append(mask)
        cols["segment"].append(seg)
    batch = {k: np.stack(v) for k, v in cols.items()}
    batch["grid_coord"] = batch["grid_coord"].astype(np.int64)
    model = _jax_segmentor()
    point = PointBatch(coord=jnp.asarray(batch["coord"][:1]), feat=jnp.asarray(batch["feat"][:1]),
                       grid_coord=jnp.asarray(batch["grid_coord"][:1].astype(np.int32)),
                       mask=jnp.asarray(batch["mask"][:1]))
    params, stats = _numpy_variables(model, point, rng)
    return batch, state_dict_from_flax(params, stats)


def _assert_stats(got, want, where):
    assert sorted(got) == sorted(want) and len(want) >= 6, where
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=STAT_RTOL,
                                   atol=STAT_ATOL, err_msg=f"{where}: {key}")


@pytest.mark.parametrize("weighted", [False, True], ids=["ce_lovasz", "ce_weighted_lovasz"])
def test_two_ranks_semseg_step_equals_one_process(tmp_path, weighted):
    """train_step of task "semseg" under DDP at drop-path 0.3 with the curve
    shuffle drawn: two ranks of one row each equal one process over both
    rows, the same gradients and statistics on both ranks."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria
    from tests.test_torch_semseg import TINY
    from tests.torch_dist_worker import _model, _step_record, _tensors

    batch, state = _semseg_rows()
    job = dict(kind="semseg_step", batch=batch, state=state, seed=7,
               criteria=_semseg_criteria(CLASS_WEIGHTS if weighted else None),
               model=dict(type="DefaultSegmentorV2", num_classes=NUM_CLASSES,
                          backbone_out_channels=TINY["dec_channels"][0],
                          backbone=dict(type="PT-v3m1", **dict(TINY, drop_path=0.3))))
    model = _model(job)
    metrics = train_step(model, build_criteria(job["criteria"]),
                         torch.optim.SGD(model.parameters(), lr=0.0), None, _tensors(batch),
                         generator=torch.Generator().manual_seed(7), task="semseg")
    one = _step_record(model, metrics["loss"], metrics["grad_norm"])
    ranks = run_ranks(tmp_path, job)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(got["grads"], one["grads"], f"rank {r}")
        _assert_stats(got["stats"], one["stats"], f"rank {r}")
    for key, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][key]), key
    assert "seg_head.weight" in ranks[0]["grads"]


def test_two_ranks_insseg_step_equals_one_process(tmp_path):
    """train_step of task "insseg" under DDP: the bias head's BatchNorm and
    the backbone's take the global moments, the CE and the two bias means
    span the global batch, so two ranks of one row each equal one process
    over both rows, with the same gradients on both ranks."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria, build_model
    from tests.test_torch_insseg import _pg_cfg, _targets
    from tests.test_torch_spunet import _scene
    from tests.torch_dist_worker import _model, _step_record, _tensors

    s = _scene(17)
    seg, inst, centroid = _targets(s, seed=2)
    batch = dict(coord=s["coord"], feat=s["feat"], grid_coord=s["grid"].astype(np.int64),
                 mask=s["mask"], segment=seg, instance=inst, instance_centroid=centroid)
    model_cfg = _pg_cfg()
    model_cfg["backbone"]["seed"] = 3
    state = {k: v.numpy() for k, v in build_model(dict(model_cfg)).state_dict().items()}
    job = dict(kind="semseg_step", task="insseg", batch=batch, state=state, seed=7,
               criteria=None, model=model_cfg)
    model = _model(job)
    metrics = train_step(model, build_criteria(None), torch.optim.SGD(model.parameters(), lr=0.0),
                         None, _tensors(batch), generator=torch.Generator().manual_seed(7),
                         task="insseg")
    one = _step_record(model, metrics["loss"], metrics["grad_norm"])
    ranks = run_ranks(tmp_path, job)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(got["grads"], one["grads"], f"rank {r}")
        _assert_stats(got["stats"], one["stats"], f"rank {r}")
    for key, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][key]), key
    assert {"bias_head.1.weight", "seg_head.weight"} <= set(ranks[0]["grads"])


def _one_process_step(job):
    """The job's train step in one process over the whole batch, from the
    same weights and generator seed, as a step record."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria
    from tests.torch_dist_worker import _model, _step_record, _tensors

    model = _model(job)
    metrics = train_step(model, build_criteria(job["criteria"]),
                         torch.optim.SGD(model.parameters(), lr=0.0), None,
                         _tensors(job["batch"]), generator=torch.Generator().manual_seed(7),
                         task=job["task"])
    return _step_record(model, metrics["loss"], metrics["grad_norm"])


def _msc_job():
    """MSC-v1m1 over the tiny SpUNet, 4 rows of two views, every view's two
    rows of a process merged (view mixing on), the cross masks and pairs
    drawn; two steps without find_unused_parameters."""
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_msc_loss import MSC, two_view_batch

    batch = {k: v for k, v in two_view_batch(5, n=(300, 260, 280, 240)).items()
             if not k.startswith(("match_", "view1_point", "view2_point"))}
    model = dict(MSC, type="MSC-v1m1", view1_mix_prob=1.0, view2_mix_prob=1.0,
                 backbone=dict(MSC["backbone"], seed=3))
    state = {k: v.numpy() for k, v in build_model(copy.deepcopy(model)).state_dict().items()}
    return dict(kind="semseg_step", task="msc", batch=batch, state=state, seed=7,
                criteria=None, model=model, steps=2)


def _cac_job():
    """CAC-v1m1 over the tiny SpUNet (its cross-entropy in the model), two
    rows with a padded tail; two steps without find_unused_parameters."""
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_cac import CAC, _segment
    from tests.test_torch_spunet import _scene

    s = _scene(19)
    batch = dict(coord=s["coord"], feat=s["feat"], grid_coord=s["grid"].astype(np.int64),
                 mask=s["mask"], segment=_segment(s, 3))
    model = dict(CAC, backbone=dict(CAC["backbone"], seed=3))
    state = {k: v.numpy() for k, v in build_model(copy.deepcopy(model)).state_dict().items()}
    return dict(kind="semseg_step", task="cac", batch=batch, state=state, seed=7,
                criteria=None, model=model, steps=2)


@pytest.mark.parametrize("task", ["msc", "cac"])
def test_two_ranks_msc_and_cac_steps_equal_one_process(tmp_path, task):
    """train_step of task "msc" and "cac" under DDP as the trainer builds it
    (no find_unused_parameters; a second step, which DDP would refuse after
    a parameter without a gradient, runs): two ranks equal one process over
    the whole batch, the same gradients on both ranks. MSC: the masks and
    pair priorities drawn at the global batch's shape, the rows' validity
    gathered, InfoNCE over the global pairs, the reconstruction sums over
    the global batch, each process merging its own rows' pairs; CAC: the
    adaptive perspective's and the distillation's class sums over the
    global batch, CE and BatchNorms as before."""
    job = (_msc_job if task == "msc" else _cac_job)()
    one = _one_process_step(job)
    ranks = run_ranks(tmp_path, job)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(got["grads"], one["grads"], f"rank {r}")
        _assert_stats(got["stats"], one["stats"], f"rank {r}")
        assert sorted(got["grads"]) == sorted(one["grads"])
    for key, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][key]), key
    assert ("mask_token" if task == "msc" else "feat_proj_layer.0.weight") in one["grads"]


def _ppt_job(conditions, find_unused=True):
    """PPT-v1m2 over the tiny 5-stage backbone with PDNorms (drop-path 0.3,
    the backbone's two conditions in the other order than the model's), its
    own seeded weights, the semseg rows, two steps on ``conditions``."""
    from scenesplat_tpu_torch.models import build_model
    from tests.test_torch_semseg import TINY

    batch, _ = _semseg_rows()
    model = dict(type="PPT-v1m2", backbone_out_channels=TINY["dec_channels"][0],
                 context_channels=16, conditions=("A", "B"), num_classes=(NUM_CLASSES, 5),
                 backbone=dict(type="PT-v3m1", **dict(TINY, drop_path=0.3), seed=2,
                               pdnorm_conditions=("B", "A"), context_channels=16))
    state = {k: v.numpy() for k, v in build_model(dict(model)).state_dict().items()}
    return dict(kind="ppt_steps", batch=batch, state=state, seed=7, model=model,
                criteria=_semseg_criteria(), conditions=conditions, find_unused=find_unused)


def test_two_ranks_ppt_steps_equal_one_process(tmp_path):
    """train_step of task "ppt" under the trainer's DDP (find_unused_parameters)
    through a change of condition: on each step two ranks of one row each
    equal one process over both rows, the inactive condition's head and
    norms without a gradient on every rank, the same gradients on both."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria
    from tests.torch_dist_worker import _model, _step_record, _tensors

    job = _ppt_job(["A", "B"])
    model = _model(job)
    one = []
    for name in job["conditions"]:
        metrics = train_step(model, build_criteria(job["criteria"]),
                             torch.optim.SGD(model.parameters(), lr=0.0), None,
                             dict(_tensors(job["batch"]), condition=name),
                             generator=torch.Generator().manual_seed(7), task="ppt")
        one.append(_step_record(model, metrics["loss"], metrics["grad_norm"]))
    ranks = run_ranks(tmp_path, job)
    for i, name in enumerate(job["conditions"]):
        inactive = ("A", "B").index(name) ^ 1
        assert f"seg_heads.{inactive}.weight" not in one[i]["grads"]
        for r, got in enumerate(ranks):
            step = got["steps"][i]
            np.testing.assert_allclose(step["loss"], one[i]["loss"], rtol=LOSS_RTOL)
            _assert_grads(step["grads"], one[i]["grads"], f"rank {r} step {i}")
        for key, g in ranks[0]["steps"][i]["grads"].items():
            assert torch.equal(g, ranks[1]["steps"][i]["grads"][key]), key
    _assert_stats(ranks[0]["steps"][1]["stats"], one[1]["stats"], "rank 0")


def test_ppt_under_ddp_needs_find_unused_parameters(tmp_path):
    """Without find_unused_parameters DDP refuses the PPT step whose
    parameters took no gradient (the inactive condition's norms and head):
    the ranks fail."""
    with pytest.raises(AssertionError, match=r"exited with[\s\S]*find_unused_parameters"):
        run_ranks(tmp_path, _ppt_job(["A", "B"], find_unused=False), timeout=120)


SSL_LOSS_KWARGS = dict(local_crop_num=1, enable_mae=True, mask_type="patch",
                       mask_grid_size=0.2, mask_ratio_min_max=(0.2, 0.5),
                       mask_sample_probability=1.0)


def _ssl_job():
    """Two rows of two global crops and one local crop, numpy-made student,
    teacher and heads of the JAX SimDINOSSL (tests/test_torch_ssl.py's
    SSL_TINY at mean pooling, drop-path 0.3, the curves shuffled) as the
    port's state dict."""
    from tests.test_torch_ssl import (
        HEADS,
        SSL_TINY,
        jax_point,
        jax_ssl_model,
        numpy_variables,
        ssl_crop,
        stack_crops,
        variable_shapes,
    )
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    backbone = dict(pool_reduce="mean", drop_path=0.3, shuffle_orders=True)
    rng = np.random.default_rng(43)
    batch = {}
    for prefix, parents, slots in (("global_crop0", (24, 20), 112),
                                   ("global_crop1", (22, 24), 112),
                                   ("local_crop0", (12, 10), 64)):
        crop = stack_crops([ssl_crop(rng, p, slots, shift=(0.3, -0.2, 0.1)) for p in parents])
        crop["coord"] = crop["coord"] * 3.0  # several 0.2 m mask patches a crop
        batch.update({f"{prefix}_{k}": v for k, v in crop.items()})
    model = jax_ssl_model(**backbone)
    shapes = variable_shapes(model, jax_point({k[13:]: v for k, v in batch.items()
                                               if k.startswith("global_crop0_")}))
    params, stats = numpy_variables(shapes, rng)
    t_params, t_stats = numpy_variables(shapes, rng)
    state = state_dict_from_flax(params, stats, teacher_params=t_params["backbone_module"],
                                 teacher_batch_stats=t_stats["backbone_module"])
    return dict(kind="ssl_step", batch=batch, state=state, seed=11, lr=0.05, momentum=0.9,
                loss_kwargs=SSL_LOSS_KWARGS,
                model=dict(type="SimDINOSSL", backbone=dict(SSL_TINY, **backbone),
                           enable_mae=True, mae_out_dim=11, **HEADS))


def test_two_ranks_ssl_step_equals_one_process(tmp_path):
    """ssl_train_step of SSLObjective under DDP, SGD and the EMA: every loss
    term, every student gradient and statistic of two ranks equal one
    process's; the teacher after the EMA is bit-equal on both ranks, within
    1e-6 of one process's, and its mask token is unmoved."""
    from scenesplat_tpu_torch.engines.pretrain import ssl_train_step
    from tests.torch_dist_worker import _model, _tensors, ssl_record

    job = _ssl_job()
    model = _model(job)
    token = model.teacher.mask_token.detach().clone()
    batch = {k: v.long() if k.endswith("grid_coord") else v
             for k, v in _tensors(job["batch"]).items()}
    optimizer = torch.optim.SGD([p for p in model.parameters() if p.requires_grad], lr=job["lr"])
    metrics = ssl_train_step(model, optimizer, None, batch, job["momentum"],
                             generator=torch.Generator().manual_seed(job["seed"]),
                             **job["loss_kwargs"])
    one = ssl_record(model, metrics)
    assert one["metrics"]["sim_ibot_patch_loss"] != 0 and one["metrics"]["global_mae_loss"] > 0
    ranks = run_ranks(tmp_path, job)
    for r, got in enumerate(ranks):
        assert sorted(got["metrics"]) == sorted(one["metrics"])
        for key, value in one["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], value, rtol=LOSS_RTOL,
                                       err_msg=f"rank {r}: {key}")
        assert "backbone.mask_token" in got["grads"]
        assert not any(k.startswith("teacher.") for k in got["grads"])
        _assert_grads(got["grads"], one["grads"], f"rank {r}")
        _assert_stats(got["stats"], one["stats"], f"rank {r}")
        for key, value in one["teacher"].items():
            np.testing.assert_allclose(got["teacher"][key].numpy(), value.numpy(), rtol=0,
                                       atol=TEACHER_ATOL, err_msg=f"rank {r}: {key}")
        assert torch.equal(got["teacher"]["mask_token"], token)
    for key, value in ranks[0]["teacher"].items():
        assert torch.equal(value, ranks[1]["teacher"][key]), key
    moved = [k for k, v in one["teacher"].items() if not torch.equal(v, _initial_teacher(job, k))]
    assert len(moved) == len(one["teacher"]) - 1  # every teacher parameter but the mask token


def _initial_teacher(job, name):
    return torch.from_numpy(np.array(job["state"]["teacher." + name]))


def test_two_ranks_ptv2_semseg_step_equals_one_process(tmp_path):
    """train_step of task "semseg" of DefaultSegmentor over PT-v2m2
    (tests/test_torch_ptv2.py's MINI, both position encodings, drop path
    0.3) under DDP: two ranks of one row each equal one process over both
    rows (the loss 1e-5, the gradient norm 1e-4; each gradient tensor 3e-4
    of its norm and the statistics 1e-5 with an absolute 1e-6: the ranks'
    partial sums of the BatchNorm moments move every gradient tensor by 2e-5
    to 6e-5, one grouped BatchNorm's bias by 1.1e-4, and a running mean by
    1.7e-7, measured), the same gradients on both ranks."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria, build_model
    from tests.test_torch_ptv2 import MINI, cloud
    from tests.torch_dist_worker import _model, _step_record, _tensors

    s = cloud(6)
    seg = np.random.default_rng(3).integers(0, NUM_CLASSES, s["mask"].shape)
    seg[~s["mask"]] = -1
    batch = dict(coord=s["coord"], feat=s["feat"], grid_coord=s["grid"].astype(np.int64),
                 mask=s["mask"], segment=seg)
    model_cfg = dict(type="DefaultSegmentor", backbone=dict(
        MINI, type="PT-v2m2", num_classes=NUM_CLASSES, drop_path_rate=0.3, seed=3))
    state = {k: v.numpy() for k, v in build_model(copy.deepcopy(model_cfg)).state_dict().items()}
    job = dict(kind="semseg_step", batch=batch, state=state, seed=7,
               criteria=_semseg_criteria(), model=model_cfg)

    def one_process(rows):
        model = _model(job)
        metrics = train_step(model, build_criteria(job["criteria"]),
                             torch.optim.SGD(model.parameters(), lr=0.0), None,
                             _tensors({k: v[rows] for k, v in batch.items()}),
                             generator=torch.Generator().manual_seed(7), task="semseg")
        return _step_record(model, metrics["loss"], metrics["grad_norm"])

    one = one_process([0, 1])
    ranks = run_ranks(tmp_path, job)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(got["grads"], one["grads"], f"rank {r}", PTV2_GRAD_RTOL, PTV2_ZERO_GRAD)
        for key, want in one["stats"].items():
            np.testing.assert_allclose(np.asarray(got["stats"][key]), np.asarray(want),
                                       rtol=1e-5, atol=1e-6, err_msg=f"rank {r}: {key}")
    for key, g in ranks[0]["grads"].items():
        assert torch.equal(g, ranks[1]["grads"][key]), key
    assert any(".attn.linear_p_bias.1.norm." in k for k in one["stats"])


PTV2_GRAD_RTOL = 3e-4
# a gradient zero in exact arithmetic (a linear's bias ahead of a BatchNorm
# or of the softmax over the neighbours): its sums over every neighbour slot
# leave up to 1.9e-6 of the whole on two ranks (measured; PTv1's CPU test
# holds them to the same bar)
PTV2_ZERO_GRAD = 1e-5
