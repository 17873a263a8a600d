"""Port parity, data parallel and scene sharding: N processes of the port
against one, and against the JAX package, whose step spans the global
batch.

Ranks are separate processes (``tests/torch_dist_worker.py``), started as
``torchrun`` starts them (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), on the CPU over gloo, each with one torch
thread, a free port and a time limit of its own.

1. The step: two ranks at a global batch of 2 rows give the one-process
   loss (1e-5 relative), gradients, gradient norm and BatchNorm running
   statistics (1e-4 relative) at ``drop_path`` 0.3 with the generator's
   draws, and the JAX package's global-batch loss, gradients and
   statistics (the tolerances of tests/test_torch_train.py) with the
   curve order and the contrastive split fixed.
2. Per-rank loader rows at 2 and 4 processes with Mix3D 0.8 equal the JAX
   ``Loader(process_index=r, process_count=w)``'s; ``partition_indices`` and
   the merges equal JAX's.
3. Sharded testing and the sharded evaluator hook give exactly the
   one-process metrics; each shard's metrics agree with the JAX tester run
   on that shard (``SCENESPLAT_EVAL_RANK`` / ``SCENESPLAT_EVAL_WORLD``) to
   the tolerance of tests/test_torch_test.py.
4. The trainer: two ranks of the train entry on the flagship file write
   one checkpoint that loads strictly into a one-process model; the
   shipped semseg and SSL files train a step under a group of two (their
   steps against one process: tests/test_torch_dist_tasks.py); a group that
   cannot start raises."""

import copy
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import fused_jax_conv  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu import data as jdata  # noqa: E402
from scenesplat_tpu.parallel import dist_eval as jdist_eval  # noqa: E402
from scenesplat_tpu_torch import data as tdata  # noqa: E402
from scenesplat_tpu_torch.parallel import dist as pdist  # noqa: E402
from scenesplat_tpu_torch.parallel import dist_eval as tdist_eval  # noqa: E402
from tests.test_full_model_golden import MINI, _make_scene  # noqa: E402
from tests.test_torch_data import _jax_cfg, flagship_data  # noqa: E402,F401 (fixture)
from tests.test_torch_test import (  # noqa: E402,F401 (fixtures)
    BACKBONE,
    D_LANG,
    FLAGSHIP,
    LABELS,
    METRIC_ATOL,
    N_CLASSES,
    PRED_AGREEMENT,
    _jax_numpy_grid_sample,
    _test_data_cfg,
    _tester_cfg,
    one_torch_thread,
)
from tests.test_torch_train import CRITERIA, TINY, ZERO_GRAD, _jax_loss_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240  # each spawned run's limit (the slowest takes about 40 s)
LOSS_RTOL, GRAD_RTOL, STAT_RTOL = 1e-5, 1e-4, 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, job: dict, world: int = 2, ranks=None, timeout=RANK_TIMEOUT_S):
    """Starts ``ranks`` (all of ``world`` by default) of ``job`` as torchrun
    would and returns each rank's result; kills them all past ``timeout``."""
    ranks = list(range(world)) if ranks is None else ranks
    job_file = tmp_path / f"{job['kind']}_job.pt"
    torch.save(job, job_file)
    port = _free_port()
    procs = []
    for r in ranks:
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        log = open(tmp_path / f"{job['kind']}_rank{r}.log", "w")
        procs.append((r, log, subprocess.Popen(
            [sys.executable, "-m", "tests.torch_dist_worker", str(job_file),
             str(tmp_path / f"{job['kind']}_rank{r}.pt")],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)))
    try:
        for r, log, proc in procs:
            proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for r, log, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for r, _, proc in procs:
        out = (tmp_path / f"{job['kind']}_rank{r}.log").read_text()[-4000:]
        assert proc.returncode == 0, f"rank {r} exited with {proc.returncode}:\n{out}"
    return [torch.load(tmp_path / f"{job['kind']}_rank{r}.pt", weights_only=False)
            for r in ranks]


# ---- partition and merges ---------------------------------------------------

@pytest.mark.parametrize("n,world", [(13, 1), (13, 2), (3, 2), (13, 3), (2, 4), (13, 8)])
def test_partition_indices_equal_jax(n, world):
    shards = [tdist_eval.partition_indices(n, r, world) for r in range(world)]
    assert shards == [jdist_eval.partition_indices(n, r, world) for r in range(world)]
    assert sorted(i for s in shards for i in s) == list(range(n))


def test_eval_rank_and_world_overrides_equal_jax(monkeypatch):
    assert (tdist_eval.eval_rank(), tdist_eval.eval_world()) == (0, 1)
    monkeypatch.setenv("SCENESPLAT_EVAL_RANK", "1")
    monkeypatch.setenv("SCENESPLAT_EVAL_WORLD", "3")
    assert (tdist_eval.eval_rank(), tdist_eval.eval_world()) == (
        jdist_eval.eval_rank(), jdist_eval.eval_world()) == (1, 3)
    assert tdist_eval.partition_indices(8) == jdist_eval.partition_indices(8) == [1, 4, 7]


def test_one_process_merges_are_identities():
    arrays = (np.arange(4.0), 3, np.ones((2, 2), np.int64))
    assert tdist_eval.allreduce_sum_arrays(arrays) is arrays
    assert tdist_eval.allgather_pyobjects([{"a": 1}, "rec"]) == [{"a": 1}, "rec"]
    assert tdist_eval.broadcast_pyobject("x") == "x"


def test_merges_two_ranks_equal_jax(tmp_path, monkeypatch):
    """int64 counts above 2^53 and float64 sums with low bits set: the
    port's gloo merge equals JAX's rank-ordered merge bit for bit (JAX's
    run as two processes: its gather handed the two ranks' payloads), the
    same on both ranks; the records come back in rank order."""
    rng = np.random.default_rng(3)
    arrays = [[np.array([2 ** 60 + r, 7], np.int64), rng.normal(size=5) * 10 ** (3 * r),
               np.float64(0.1 * (r + 1))] for r in range(2)]
    records = [[("scene0", {"i": np.arange(3)})], [("scene1", {"i": np.arange(2)}), "x"]]
    got = run_ranks(tmp_path, dict(kind="reductions", arrays=arrays, records=records, n=5))

    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(jdist_eval, "allgather_pyobjects",
                        lambda objs: [[np.asarray(a) for a in arrays[r]] for r in range(2)])
    ref = jdist_eval.allreduce_sum_arrays(tuple(arrays[0]))
    for r, res in enumerate(got):
        assert type(res["summed"]) is tuple and len(res["summed"]) == 3
        for g, w in zip(res["summed"], ref):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        assert res["summed"][0][0] == 2 ** 61 + 1  # exact past float64's 2^53
        assert [k if isinstance(k, str) else k[0] for k in res["gathered"]] == [
            "scene0", "scene1", "x"]
        assert res["shard"] == jdist_eval.partition_indices(5, r, 2) == [r, r + 2, r + 4][
            :len(res["shard"])]


# ---- loader rows --------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_loader_rows_equal_jax(flagship_data, world):
    """Global batch 4 with Mix3D 0.8 (8 samples a batch): each rank's rows
    of two epochs' batches equal the JAX Loader's for that process."""
    cfg = copy.deepcopy(flagship_data)
    cfg["datasets"] = cfg["datasets"][:1]  # 3 scenes, looped to 9 samples
    cfg["datasets"][0]["loop"] = 3
    tds = tdata.build_dataset(copy.deepcopy(cfg)).datasets[0]
    jds = jdata.build_dataset(_jax_cfg(cfg)).datasets[0]
    assert len(tds) == len(jds) == 9
    kw = dict(batch_size=4, num_points=2048, mix_prob=0.8, seed=3, num_workers=2)
    rows = []
    for r in range(world):
        tl = tdata.Loader(tds, process_index=r, process_count=world, **kw)
        jl = jdata.Loader(jds, process_index=r, process_count=world, **kw)
        assert len(tl) == len(jl) == 1
        for epoch in (0, 1):
            tl.set_epoch(epoch)
            jl.set_epoch(epoch)
            (got,), (ref,) = list(tl), list(jl)
            assert sorted(got) == sorted(ref)
            for key in ref:
                assert got[key].dtype == ref[key].dtype, key
                np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            assert got["mask"].shape[0] == 4 // world
            rows.append(got["coord"])
    assert not np.array_equal(rows[0], rows[2])  # the ranks hold other rows


def test_loader_split_checks():
    tds = list(range(12))
    with pytest.raises(ValueError, match="does not split over 4"):
        tdata.Loader(tds, batch_size=3, num_points=8, process_index=0, process_count=4)
    with pytest.raises(ValueError, match="drop_last"):
        tdata.Loader(tds, batch_size=2, num_points=8, process_index=0, process_count=2,
                     drop_last=False)
    loader = tdata.Loader(tds, batch_size=2, num_points=8)
    assert (loader.process_index, loader.process_count) == (0, 1)  # no group


def test_batch_split_and_draws_follow_the_global_batch(monkeypatch):
    """At 2 processes (the group's size and rank stubbed), a rank's rows
    and draws are its block of one process's batch and draws; the batch
    size must split."""
    monkeypatch.setattr(pdist, "world", lambda: 2)
    with pytest.raises(ValueError, match="batch_size 3 .* 2 processes"):
        pdist.check_global_batch(3)
    full = torch.rand((4, 5, 1), generator=torch.Generator().manual_seed(9))
    for r in range(2):
        monkeypatch.setattr(pdist, "rank", lambda r=r: r)
        assert pdist.local_batch_slice(4) == slice(2 * r, 2 * r + 2)
        gen = torch.Generator().manual_seed(9)
        torch.testing.assert_close(pdist.batch_rand((2, 5, 1), gen), full[2 * r:2 * r + 2],
                                   rtol=0, atol=0)
        # the generator moved past the whole global draw, as one process's
        one = torch.Generator().manual_seed(9)
        torch.rand((4, 5, 1), generator=one)
        assert torch.equal(gen.get_state(), one.get_state())


# ---- the global BatchNorm -------------------------------------------------

def test_global_batchnorm_equals_fused_and_gradcheck():
    """At one process the global-moment BatchNorm's forward, backward and
    running statistics equal torch's fused norm; its hand-written backward
    passes gradcheck in float64."""
    from scenesplat_tpu_torch.models.norm import MaskedBatchNorm, _GlobalMaskedBatchNorm

    x = torch.randn(3, 40, 6, dtype=torch.float64) * 2 + 1
    w, b = torch.rand(6, dtype=torch.float64) + 0.5, torch.randn(6, dtype=torch.float64)
    rows = x[:, :33].reshape(-1, 6).requires_grad_(True)
    torch.autograd.gradcheck(lambda a, c, d: _GlobalMaskedBatchNorm.apply(a, c, d, 1e-3)[0],
                             (rows, w.clone().requires_grad_(True),
                              b.clone().requires_grad_(True)))

    x32 = torch.randn(2, 50, 8) * 3 + 2
    mask = torch.rand(2, 50) > 0.3
    fused, ours = MaskedBatchNorm(8).train(), MaskedBatchNorm(8).train()
    with torch.no_grad():
        for bn in (fused, ours):
            bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
            bn.bias.normal_(generator=torch.Generator().manual_seed(2))
    xf, xg = x32.clone().requires_grad_(True), x32.clone().requires_grad_(True)
    ref, got = fused(xf, mask)[mask], ours._global(xg[mask])
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    dy = torch.randn_like(got)
    (gx,) = torch.autograd.grad((got * dy).sum(), xg)
    (fx,) = torch.autograd.grad((ref * dy).sum(), xf)
    torch.testing.assert_close(gx, fx, rtol=1e-4, atol=1e-5)
    for key in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(ours, key), getattr(fused, key), rtol=1e-6,
                                   atol=1e-7)


# ---- the step -------------------------------------------------------------------

@pytest.fixture(scope="module")
def rows():
    """Four scenes of 256 to 208 points padded to 272 slots, numpy-made
    weights at the shapes the JAX model gives them, lang targets by class
    and the port's state dict of those weights; the JAX side holds the
    first two rows."""
    from scenesplat_tpu.models import PointBatch
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax
    from tests.test_torch_model import _jax_model, _numpy_variables

    rng = np.random.default_rng(21)
    n = 272
    arrays = dict(coord=[], grid=[], feat=[], mask=[])
    for parents in (128, 112, 120, 104):
        coord, grid, feat = _make_scene(rng, n_parents=parents)
        pad = n - len(grid)
        arrays["coord"].append(np.concatenate([coord, np.zeros((pad, 3), np.float32)]))
        arrays["grid"].append(np.concatenate([grid, np.zeros((pad, 3), np.int32)]))
        arrays["feat"].append(np.concatenate([feat, np.zeros((pad, 6), np.float32)]))
        arrays["mask"].append(np.arange(n) < len(grid))
    coord, grid, feat, mask = (np.stack(arrays[k]) for k in ("coord", "grid", "feat", "mask"))
    model = _jax_model(MINI, (0.5,))
    point = PointBatch(coord=jnp.asarray(coord[:2]), feat=jnp.asarray(feat[:2]),
                       grid_coord=jnp.asarray(grid[:2]), mask=jnp.asarray(mask[:2]))
    params, stats = _numpy_variables(model, point, rng)
    d = MINI["dec_channels"][0]
    seg = rng.integers(0, 5, (4, n)).astype(np.int32)
    seg[~mask] = -1
    emb = rng.normal(size=(5, d)).astype(np.float32)
    batch = dict(segment=seg, lang_feat=(emb[np.maximum(seg, 0)] + 0.2 * rng.normal(
        size=(4, n, d))).astype(np.float16), valid_feat_mask=rng.random((4, n)) > 0.1)
    port_batch = dict(batch, coord=coord, feat=feat, grid_coord=grid.astype(np.int64),
                      mask=mask)
    return dict(model=model, point=point, params=params, stats=stats,
                batch={k: v[:2] for k, v in batch.items()},
                port_batch=port_batch, state=state_dict_from_flax(params, stats))


def _assert_grads(got, want, where, rtol=GRAD_RTOL, zero_bar=ZERO_GRAD):
    """Each gradient tensor to ``rtol`` of its norm; one that is zero in
    exact arithmetic (below ``zero_bar`` of the whole gradient, see
    tests/test_torch_train.py: ZERO_GRAD) to noise on both sides. Returns
    the names of those."""
    assert sorted(got) == sorted(want), where
    total = np.sqrt(sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want.values()))
    zero = []
    for name, g in got.items():
        g, w = np.asarray(g, np.float64), np.asarray(want[name], np.float64)
        if np.linalg.norm(w) < zero_bar * total:
            assert np.linalg.norm(g) < zero_bar * total, (where, name)
            zero.append(name)
            continue
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert err <= rtol, (where, name, err)
    return zero


def _assert_stats(got, want, where, rtol=STAT_RTOL, atol=0.0):
    assert sorted(got) == sorted(want) and len(want) >= 6, where
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]), rtol=rtol,
                                   atol=atol, err_msg=f"{where}: {key}")


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_step_equals_one_process_at_drop_path(rows, tmp_path, world):
    """train_step under DDP at drop_path 0.3 with the curve shuffle and the
    contrastive split drawn from the generator: ``world`` ranks of one row
    each equal one process over all the rows."""
    from scenesplat_tpu_torch.engines.train_step import train_step
    from scenesplat_tpu_torch.models import build_criteria
    from tests.torch_dist_worker import _model, _step_record, _tensors

    backbone = dict(MINI, type="PT-v3m1", drop_path=0.3, shuffle_orders=True,
                    stage_capacity=(0.5,))
    job = dict(kind="step", backbone=backbone, state=rows["state"],
               batch={k: v[:world] for k, v in rows["port_batch"].items()}, criteria=CRITERIA,
               seed=5)
    model = _model(job)
    metrics = train_step(model, build_criteria(CRITERIA),
                         torch.optim.SGD(model.parameters(), lr=0.0), None,
                         _tensors(job["batch"]), generator=torch.Generator().manual_seed(5),
                         epoch_progress=1.0, task="lang")
    one = _step_record(model, metrics["loss"], metrics["grad_norm"])
    ranks = run_ranks(tmp_path, job, world=world)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=GRAD_RTOL)
        _assert_grads(got["grads"], one["grads"], f"rank {r}")
        _assert_stats(got["stats"], one["stats"], f"rank {r}")
    # DDP leaves the same gradients on every rank; the global moments give
    # the same statistics
    for got in ranks[1:]:
        for key, g in ranks[0]["grads"].items():
            assert torch.equal(g, got["grads"][key]), key
        for key, stat in ranks[0]["stats"].items():
            assert torch.equal(stat, got["stats"][key]), key
    # drop-path drew: without it the gradients move far past the tolerance
    model0 = _model(dict(job, backbone=dict(backbone, drop_path=0.0)))
    train_step(model0, build_criteria(CRITERIA), torch.optim.SGD(model0.parameters(), lr=0.0),
               None, _tensors(job["batch"]), generator=torch.Generator().manual_seed(5),
               epoch_progress=1.0, task="lang")
    moved = max(float((p.grad - one["grads"][k]).norm() / one["grads"][k].norm())
                for k, p in model0.named_parameters() if one["grads"][k].norm() > 0)
    assert moved > 100 * GRAD_RTOL, moved


def test_two_ranks_step_equals_jax_global_batch(rows, tmp_path):
    """The curve order and the contrastive split drawn by JAX over the
    2-row batch: two ranks' loss, DDP-averaged gradients and running
    statistics equal JAX's loss_fn over the global batch."""
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    case = dict(rows)
    ref_loss, ref_grads, ref_stats, perm, split = _jax_loss_fn(case, jax.random.PRNGKey(4))
    assert perm == [1, 0]
    job = dict(kind="step", backbone=dict(MINI, type="PT-v3m1", stage_capacity=(0.5,)),
               state=rows["state"], batch={k: v[:2] for k, v in rows["port_batch"].items()},
               criteria=CRITERIA,
               perm=perm, split=split.reshape(2, -1))
    want = state_dict_from_flax(ref_grads, {})
    after = state_dict_from_flax(rows["params"], ref_stats)
    want_stats = {k: v for k, v in after.items() if k.endswith(("running_mean", "running_var"))}
    for r, got in enumerate(run_ranks(tmp_path, job)):
        np.testing.assert_allclose(got["loss"], ref_loss, rtol=LOSS_RTOL)
        zero = _assert_grads({k: g.numpy() for k, g in got["grads"].items()}, want,
                             f"rank {r}")
        assert len(zero) == 5, zero  # as in tests/test_torch_train.py
        _assert_stats({k: v.numpy() for k, v in got["stats"].items()}, want_stats,
                      f"rank {r}", rtol=1e-5, atol=1e-6)


# ---- the trainer ------------------------------------------------------------------

# the semseg and SSL files' 5 stages at narrow widths (the README's CPU cut)
TINY_WIDTHS = dict(enc_channels=(16, 16, 32, 32, 32), enc_num_head=(1, 1, 2, 2, 2),
                   enc_depths=(1, 1, 1, 1, 1), dec_channels=(16, 16, 32, 32),
                   dec_num_head=(1, 1, 2, 2), dec_depths=(1, 1, 1, 1), enc_patch_size=(64,) * 5)


def _write_gs_rooms(root, rng, count, n, semseg):
    """root/train/scene<i>_00/<asset>.npy: ``n`` Gaussians on a 1 cm lattice
    in a 0.4 m cube; with ``semseg`` also normals and ``segment20``."""
    for i in range(count):
        scene = root / "train" / f"scene{i:04d}_00"
        scene.mkdir(parents=True)
        cells = rng.choice(40 ** 3, n, replace=False)
        coord = (np.stack(np.unravel_index(cells, (40,) * 3), -1) * 0.01 + 0.005)
        assets = dict(coord=coord, color=rng.uniform(0, 255, (n, 3)),
                      quat=rng.normal(size=(n, 4)), scale=rng.uniform(0.01, 0.5, (n, 3)),
                      opacity=rng.uniform(0.1, 1, n))
        if semseg:
            normal = rng.normal(size=(n, 3))
            assets["normal"] = normal / np.linalg.norm(normal, axis=1, keepdims=True)
        for key, value in assets.items():
            np.save(scene / f"{key}.npy", value.astype(np.float32))
        if semseg:
            np.save(scene / "segment20.npy", rng.integers(-1, 20, n).astype(np.int16))


def test_semseg_and_ssl_files_train_two_ranks(tmp_path):
    """The shipped semseg and SSL files train under a group of two: each
    builds a two-rank trainer on the CPU (the step under DDP; SSL's through
    its SSLObjective) and takes one step of a global batch of 2, the same
    finite loss on both ranks. Cut by options as a user cuts them on the
    CPU: narrow widths and windows of 64 (``TINY_WIDTHS``), small rooms,
    1,024 points a semseg row (Mix3D as the file sets it), SSL crops of
    1,024 and 256."""
    from scenesplat_tpu_torch.utils.config import Config

    rng = np.random.default_rng(13)
    jobs = {}
    for name, path, semseg in (
            ("semseg", "configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py", True),
            ("ssl", "configs/scannet/ssl-pretrain-scannet-all-base.py", False)):
        root = tmp_path / f"{name}_root"
        _write_gs_rooms(root, rng, 4 if semseg else 2, 1500, semseg)  # Mix3D: 2 a row
        cfg = Config.fromfile(str(ROOT / path))
        cfg.merge_from_options(dict(save_path=str(tmp_path / name), batch_size=2, epoch=1,
                                    eval_epoch=1, num_worker=1, hooks=[]))
        cfg.data.train.data_root = str(root)
        cfg.model.backbone.update(TINY_WIDTHS)
        if semseg:
            cfg.model.backbone_out_channels = TINY_WIDTHS["dec_channels"][0]
            cfg.data.num_points = 1024
            for t in cfg.data.train.transform:
                if t["type"] == "SphereCrop":
                    t["point_max"] = 1000
        else:
            cfg.data.num_points, cfg.data.num_points_local = 1024, 256
            cfg.model.dino_hidden_dim, cfg.model.ibot_hidden_dim = 64, 32
        jobs[name] = cfg.to_dict()
    for name, cfg in jobs.items():
        got = run_ranks(tmp_path, dict(kind="trainer", cfg=cfg))
        for res in got:
            assert res["world"] == 2 and res["task"] == name, res
            assert res["train_model"] == "DistributedDataParallel"
            assert len(res["losses"]) == 1 and np.isfinite(res["losses"]).all()
        assert got[0]["losses"] == got[1]["losses"]


def test_failed_group_start_raises(monkeypatch):
    """torchrun's variables for rank 0 of 2 without the rendezvous address:
    the start raises, and no run goes on in one process."""
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="2").items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        pdist.init_distributed("cpu")
    assert pdist.world() == 1 and not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def gs_root3(tmp_path_factory):
    """root/{train,val}/scene<i>/<asset>.npy as tests/test_torch_test.py
    writes them, with three validation scenes."""
    root = tmp_path_factory.mktemp("dist_gs")
    rng = np.random.default_rng(31)
    emb = rng.normal(size=(N_CLASSES, D_LANG)).astype(np.float32)
    torch.save(torch.from_numpy(emb * 3.0), root / "text_embeddings.pt")
    (root / "labels.txt").write_text("\n".join(LABELS))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    for split, count in (("train", 2), ("val", 3)):
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


def _flagship_two_epochs(root, exp):
    """The flagship file at tiny widths with its own hook list over three
    validation scenes and a zero-shot tester after training; Mix3D off and
    every crop inside the collate budget, so a two-rank batch is the
    one-process batch cut in two."""
    from scenesplat_tpu_torch.utils.config import Config

    cfg = Config.fromfile(str(ROOT / FLAGSHIP))
    hooks = copy.deepcopy(cfg.hooks)
    hooks[2]["log_interval"] = 1
    hooks[3].update(class_names=[os.path.join(root, "labels.txt")],
                    text_embeddings=[os.path.join(root, "text_embeddings.pt")],
                    excluded_classes=[["wall", "floor", "ceiling"]], vote_k=5)
    val = dict(cfg.data.val[0], data_root=root)
    for t in val["transform"]:
        if t["type"] == "GridSample":
            t["grid_size"] = 0.05
    cfg.merge_from_options(dict(save_path=str(exp), epoch=2, eval_epoch=2, batch_size=2,
                                num_worker=2, mix_prob=0.0, hooks=hooks,
                                test=_tester_cfg(root, save_path=str(exp / "test"))))
    cfg.data.num_points = 1024
    cfg.data.val = [val]
    cfg.data.test = _test_data_cfg(root)
    cfg.model.backbone.update(TINY)
    cfg.model.criteria[2]["min_samples"] = 5
    for ds in cfg.data.train.datasets:
        ds["data_root"], ds["split"] = root, "train"
        for t in ds["transform"]:
            if t["type"] == "SphereCrop":
                t["point_max"] = 500
            if t["type"] == "GridSample":
                t["grid_size"] = 0.05
    return cfg


def _metric_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_entry_two_ranks(gs_root3, tmp_path, monkeypatch):
    """Two ranks of ``python -m scenesplat_tpu_torch.train`` on the flagship
    file: the first step's loss is the one-process entry's; rank 0 alone
    writes the files; the checkpoint holds the module's names and loads
    strictly into a one-process model; the sharded evaluator hook logged
    exactly what one process's hook gives on those weights; the tester
    after training reports what the one-process test entry reports."""
    from scenesplat_tpu_torch import test as test_entry
    from scenesplat_tpu_torch import train as train_entry
    from scenesplat_tpu_torch.engines.train import build_trainer
    from scenesplat_tpu_torch.entry import load_weights
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.ops import bitonic_sort as tsort
    from scenesplat_tpu_torch.utils.events import EventStorage

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    two, one = tmp_path / "two", tmp_path / "one"
    cfg_file = tmp_path / "tiny_flagship.py"
    _flagship_two_epochs(gs_root3, two).dump(str(cfg_file))
    run_ranks(tmp_path, dict(kind="entry", module="train",
                             argv=["--config-file", str(cfg_file), "--device", "cpu"]))
    assert train_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                             f"save_path={one}", f"test.save_path={one / 'test'}"]) == 0

    ranked, single = _metric_records(two / "metrics.json"), _metric_records(one / "metrics.json")
    assert len(ranked) == len(single) >= 6
    np.testing.assert_allclose(ranked[0]["loss"], single[0]["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranked[0]["grad_norm"], single[0]["grad_norm"], rtol=GRAD_RTOL)
    # one metrics file, one set of checkpoints: rank 1 wrote none (this
    # process's logger may write an earlier test's log file)
    assert sorted(set(os.listdir(two)) - {"train.log"}) == sorted(
        set(os.listdir(one)) - {"train.log"})
    assert sorted(os.listdir(two / "model")) == sorted(os.listdir(one / "model"))
    assert "process 0 of 2" in (two / "train.log").read_text()

    ckpt = torch.load(two / "model" / "model_last.pth", weights_only=False)
    assert not any(k.startswith("module.") for k in ckpt["state_dict"])
    cfg = _flagship_two_epochs(gs_root3, tmp_path / "again")
    model_cfg = dict(cfg.model, backbone=dict(cfg.model.backbone, seed=0))
    model_cfg.pop("criteria")
    build_model(model_cfg).load_state_dict(ckpt["state_dict"], strict=True)
    load_weights(build_model(model_cfg), str(two / "model" / "model_last.pth"))

    # the sharded hook's metric that chose model_best.pth is one process's
    # hook's on those weights
    best = torch.load(two / "model" / "model_best.pth", weights_only=False)
    trainer = build_trainer(cfg, device="cpu")
    trainer.model.load_state_dict(best["state_dict"], strict=True)
    (hook,) = [h for h in trainer.hooks if "ZeroShot" in type(h).__name__]
    with EventStorage() as trainer.storage:
        hook.before_train()
        hook.after_epoch()
        assert trainer.storage.latest["val/fg_mIoU"] == best["best_metric"] > 0

    scene_log = json.loads((two / "test" / "scene_log.json").read_text())
    assert sorted(s["name"] for s in scene_log) == ["scene0000", "scene0001", "scene0002"]
    (res,) = test_entry.main(["--config-file", str(cfg_file), "--device", "cpu", "--options",
                              f"weight={two / 'model' / 'model_best.pth'}",
                              f"test.save_path={tmp_path / 'retest'}"])
    assert ((tmp_path / "retest" / "eval_results.txt").read_text()
            == (two / "test" / "eval_results.txt").read_text())
    assert 0.0 <= res["mIoU"] <= 1.0


# ---- the sharded tester -------------------------------------------------------------

@pytest.fixture(scope="module")
def tester_run(gs_root3, tmp_path_factory):
    """The JAX tester over each shard of 2 (one jitted model, its test()
    run once per ``SCENESPLAT_EVAL_RANK``) and the port's checkpoint and
    config file of the same numpy-made weights."""
    from scenesplat_tpu import native
    from scenesplat_tpu.engines import test as jtest
    from scenesplat_tpu.models import PointBatch, build_model
    from scenesplat_tpu_torch.models import build_model as tbuild
    from scenesplat_tpu_torch.utils.config import Config
    from scenesplat_tpu_torch.utils.weights import load_flax_weights
    from tests.test_torch_model import _numpy_variables

    out = tmp_path_factory.mktemp("dist_tester")
    jmodel = build_model(dict(type="LangPretrainer", backbone=dict(BACKBONE, use_pallas=False)))
    zeros = np.zeros((1, 64, 3), np.float32)
    point = PointBatch(coord=zeros, feat=np.zeros((1, 64, 11), np.float32),
                       grid_coord=zeros.astype(np.int32), mask=np.ones((1, 64), bool))
    params, stats = _numpy_variables(jmodel, point, np.random.default_rng(23))
    shards = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        tester = jtest.build_tester(_tester_cfg(gs_root3), jmodel,
                                    {"params": params, "batch_stats": stats},
                                    _test_data_cfg(gs_root3), patch_size=32, seed=0)
        mp.setenv("SCENESPLAT_EVAL_WORLD", "2")
        for r in range(2):
            mp.setenv("SCENESPLAT_EVAL_RANK", str(r))
            tester.save_path = str(out / f"jax{r}")
            shards.append(tester.test())

    tmodel = load_flax_weights(tbuild(dict(type="LangPretrainer", backbone=dict(BACKBONE))),
                               params, stats)
    weight = out / "weights.pth"
    torch.save(dict(state_dict=tmodel.state_dict(), epoch=1), weight)
    cfg = Config(dict(seed=0, model=dict(type="LangPretrainer", backbone=dict(BACKBONE)),
                      data=dict(test=_test_data_cfg(gs_root3)),
                      test=_tester_cfg(gs_root3, save_path=str(out / "port"))))
    cfg_file = out / "test_cfg.py"
    cfg.dump(str(cfg_file))
    return dict(out=out, jax_shards=shards, cfg_file=str(cfg_file), weight=str(weight),
                jmodel=jmodel, params=params, stats=stats, tmodel=tmodel)


def _preds(folder):
    return {f: np.load(os.path.join(folder, f)) for f in sorted(os.listdir(folder))
            if f.endswith("_pred.npy")}


@pytest.mark.parametrize("world", [2, 4])
def test_zero_shot_tester_ranks_equal_one_process(tester_run, tmp_path, monkeypatch, world):
    """``world`` ranks of the test entry over 3 scenes (at 4, one rank draws
    none) report exactly the one-process metrics on every rank; their
    predictions are the one-process run's, bit for bit; rank 0 writes the
    report and every rank's scene log."""
    from scenesplat_tpu_torch import test as entry
    from scenesplat_tpu_torch.ops import bitonic_sort as tsort

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    argv = ["--config-file", tester_run["cfg_file"], "--device", "cpu", "--options",
            f"weight={tester_run['weight']}"]
    ranked = run_ranks(tmp_path, dict(
        kind="entry", module="test", argv=argv + [f"test.save_path={tmp_path / 'ranks'}"]),
        world=world)
    (one,) = entry.main(argv + [f"test.save_path={tmp_path / 'one'}"])
    for r, res in enumerate(ranked):
        (got,) = res["result"]
        assert sorted(got) == sorted(one)
        for key in one:
            np.testing.assert_array_equal(got[key], one[key], err_msg=f"rank {r}: {key}")
    got_p, one_p = _preds(tmp_path / "ranks"), _preds(tmp_path / "one")
    assert sorted(got_p) == sorted(one_p) and len(one_p) == 3
    for name, pred in got_p.items():
        np.testing.assert_array_equal(pred, one_p[name])
    assert ((tmp_path / "ranks" / "eval_results.txt").read_text()
            == (tmp_path / "one" / "eval_results.txt").read_text())
    assert len(json.loads((tmp_path / "ranks" / "scene_log.json").read_text())) == 3


def test_zero_shot_tester_shards_equal_jax(tester_run, tmp_path, monkeypatch):
    """Each shard of 2 tested alone (``SCENESPLAT_EVAL_RANK`` /
    ``SCENESPLAT_EVAL_WORLD``) agrees with the JAX tester's run on that
    shard: its scenes, 99.5% of the predictions, the metrics to 0.005."""
    from scenesplat_tpu_torch import test as entry
    from scenesplat_tpu_torch.ops import bitonic_sort as tsort

    monkeypatch.setenv(tsort.ENV_SWITCH, "0")
    argv = ["--config-file", tester_run["cfg_file"], "--device", "cpu", "--options",
            f"weight={tester_run['weight']}"]
    monkeypatch.setenv("SCENESPLAT_EVAL_WORLD", "2")
    for r, ref in enumerate(tester_run["jax_shards"]):
        monkeypatch.setenv("SCENESPLAT_EVAL_RANK", str(r))
        (got,) = entry.main(argv + [f"test.save_path={tmp_path / f'shard{r}'}"])
        got_p, ref_p = _preds(tmp_path / f"shard{r}"), _preds(tester_run["out"] / f"jax{r}")
        assert sorted(got_p) == sorted(ref_p) and len(ref_p) == (2 if r == 0 else 1)
        same = np.concatenate([got_p[k] == ref_p[k] for k in ref_p])
        assert same.mean() >= PRED_AGREEMENT, (r, same.mean())
        for key in ("mIoU", "fg_mIoU", "mAcc", "allAcc"):
            assert abs(got[key] - ref[key]) <= METRIC_ATOL, (r, key, got[key], ref[key])


class _Storage:
    """The one method of the trainers' event storages the hooks call."""

    def __init__(self):
        self.latest = {}

    def put_scalar(self, name, value):
        self.latest[name] = float(value)


def test_zero_shot_eval_hook_shards_equal_jax(tester_run, gs_root3, monkeypatch):
    """The zero-shot evaluator hook over the flagship file's validation
    pipeline, run on each shard of 2 alone (``SCENESPLAT_EVAL_RANK`` /
    ``SCENESPLAT_EVAL_WORLD``), the port's and the JAX package's from the
    same weights: their metrics agree to the tolerance of
    tests/test_torch_test.py. (Two ranks of the port's hook against one
    process: test_train_entry_two_ranks.)"""
    import logging
    from types import SimpleNamespace

    from scenesplat_tpu.engines.hooks import evaluator as jev
    from scenesplat_tpu.utils.config import Config as JConfig
    from scenesplat_tpu_torch.engines.hooks import evaluator as tev
    from scenesplat_tpu_torch.utils.config import Config as TConfig

    val = dict(TConfig.fromfile(str(ROOT / FLAGSHIP)).data.val[0], data_root=gs_root3)
    for t in val["transform"]:
        if t["type"] == "GridSample":
            t["grid_size"] = 0.05
    cfg = dict(seed=0, model=dict(type="LangPretrainer", backbone=dict(BACKBONE)),
               data=dict(val=[val]))
    kw = dict(class_names=[os.path.join(gs_root3, "labels.txt")],
              text_embeddings=[os.path.join(gs_root3, "text_embeddings.pt")],
              excluded_classes=[["wall", "floor", "ceiling"]], vote_k=5)
    log = logging.getLogger("test")
    monkeypatch.setenv("SCENESPLAT_EVAL_WORLD", "2")
    for r in range(2):
        monkeypatch.setenv("SCENESPLAT_EVAL_RANK", str(r))
        got, ref = tev.LangPretrainZeroShotSemSegEvalMulti(**kw), \
            jev.LangPretrainZeroShotSemSegEvalMulti(**kw)
        got.trainer = SimpleNamespace(cfg=TConfig(copy.deepcopy(cfg)), model=tester_run["tmodel"],
                                      device=torch.device("cpu"), epoch=0, logger=log,
                                      storage=_Storage(), comm_info={})
        ref.trainer = SimpleNamespace(
            cfg=JConfig(copy.deepcopy(cfg)), model=tester_run["jmodel"], epoch=0, logger=log,
            state=SimpleNamespace(params=tester_run["params"], batch_stats=tester_run["stats"]),
            storage=_Storage(), comm_info={})
        for hook in (got, ref):
            hook.before_train()
            hook.after_epoch()
        for key in ("val0/mIoU", "val0/fg_mIoU", "val/fg_mIoU"):
            g, w = got.trainer.storage.latest[key], ref.trainer.storage.latest[key]
            assert abs(g - w) <= METRIC_ATOL, (r, key, g, w)
        assert got.trainer.storage.latest["val0/mIoU"] > 0
