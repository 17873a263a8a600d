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
   files' criteria), Lovasz alone, the class-weighted CE, MCR and the iBOT
   cosine loss; two ranks hold the JAX loss of the global batch (1e-5
   relative), and each rank's gradient of its rows, divided by the ranks'
   count (DDP's mean), is JAX's for those rows.
3. One semseg train step (CE + Lovasz, and the weighted CE) and one SSL
   step (every loss term, the EMA teacher) at drop-path 0.3 with the curve
   shuffle and the token masks drawn: two ranks equal one process (loss
   1e-5, every gradient 1e-4 of its norm, the BatchNorm statistics 1e-6;
   the teacher bit-equal on both ranks and within 1e-6 of one process, its
   mask token unmoved)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
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
    tokens with their weights."""
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
    return {
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
