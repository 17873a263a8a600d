"""Context and tensor parallel building blocks on one process: a stage's
blocks and the window spans, ``shard_point_batch`` and the draws of every
rank of a grid tiling one process's (each rank's layout set in turn, no collective
needed), and the refusals: a TP or CP call without a process group of the
right size raises. The grids themselves run in tests/test_torch_tp.py
(one group of 4 ranks, both grids)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)

from scenesplat_tpu_torch.ops.window_attention import rank_windows  # noqa: E402
from scenesplat_tpu_torch.parallel import context, dist as pdist  # noqa: E402


def _grid(data, seq, model, r, seq_group=None):
    d, s, m = r // (seq * model), (r // model) % seq, r % model
    return pdist.Layout(data=data, seq=seq, model=model, data_rank=d, seq_rank=s, model_rank=m,
                        seq_group=seq_group)


@pytest.fixture
def as_rank():
    """Sets each rank's layout of a grid in turn (``as_rank(data, seq,
    model, r[, seq_group])``: a stand-in group for the calls that only
    check that there is one); back to plain data parallel after the
    test."""
    yield lambda *args: pdist.set_layout(_grid(*args))
    pdist.set_layout(None)


@pytest.mark.parametrize("n,seq", [(128, 2), (64, 2), (96, 4), (49152, 4), (6144, 2), (48, 3)])
def test_parts_tile_a_stage(as_rank, n, seq):
    """Part.of on every seq rank: equal blocks that tile the stage's
    slots; a stage the seq axis does not divide raises."""
    parts = []
    for r in range(seq):
        as_rank(1, seq, 1, r, "group")
        parts.append(context.Part.of(n))
    assert parts[0].lo == 0 and parts[-1].hi == n
    assert all(a.hi == b.lo and a.hi - a.lo == n // seq for a, b in zip(parts, parts[1:]))
    with pytest.raises(ValueError, match="do not split"):
        context.Part.of(n + 1)


@pytest.mark.parametrize("n,patch,parts", [(128, 16, 2), (64, 64, 2), (6144, 1024, 2),
                                           (100, 16, 3), (48, 48, 4), (49152, 1024, 4)])
def test_rank_windows_are_whole_windows_that_tile_the_row(n, patch, parts):
    """Each part starts on a window's first slot, the parts tile [0, n)
    (the last window may be ragged) and, with fewer windows than parts, the
    last parts are empty (a rank without work at that stage)."""
    spans = [rank_windows(n, patch, parts, i) for i in range(parts)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(lo % patch == 0 for lo, hi in spans if hi > lo)
    windows = -(-n // patch)
    assert sum(hi > lo for lo, hi in spans) == min(windows, parts)


def test_shard_point_batch_tiles_the_batch(as_rank):
    """(data 2, seq 2): rank d * 2 + s holds rows [2d, 2d + 2) and slots
    [s N / 2, (s + 1) N / 2) of every [B, N, ...] array; one-axis arrays
    keep their rows; N that does not split raises."""
    rng = np.random.default_rng(0)
    batch = dict(coord=rng.normal(size=(4, 8, 3)), mask=rng.random((4, 8)) > 0.3,
                 name=np.arange(4), tag="scene")
    for r in range(4):
        as_rank(2, 2, 1, r)
        got = context.shard_point_batch(batch)
        d, s = r // 2, r % 2
        assert np.array_equal(got["coord"], batch["coord"][2 * d:2 * d + 2, 4 * s:4 * s + 4])
        assert np.array_equal(got["mask"], batch["mask"][2 * d:2 * d + 2, 4 * s:4 * s + 4])
        assert np.array_equal(got["name"], batch["name"][2 * d:2 * d + 2])
        assert got["tag"] == "scene"
    with pytest.raises(ValueError, match="do not split"):
        context.shard_point_batch(dict(mask=np.ones((4, 7), bool)))


@pytest.mark.parametrize("grid", [(2, 2, 1), (2, 1, 2), (1, 4, 1)])
def test_draws_of_the_ranks_tile_one_process_draw(as_rank, grid):
    """batch_rand and batch_randint on every rank of a grid, each from the
    same seed: rows by data rank, points by seq rank for a draw that is
    one a point (every stage's slots split evenly), channels by a
    tensor-parallel span; the ranks of one model group draw the same. Put
    together they are one process's draw at the global shape. A draw not
    marked per point ([B, 1] as SSL's per-row draws) is whole on every seq
    rank."""
    data, seq, model = grid
    b, n, c = 2 * data, 12, 8
    want = torch.rand((b, n, c), generator=torch.Generator().manual_seed(3))
    want_int = torch.randint(0, 9, (b, 1), generator=torch.Generator().manual_seed(4))
    want_row = torch.rand((b, 1, 1), generator=torch.Generator().manual_seed(6))
    want_stage = torch.rand((b, 48, 1), generator=torch.Generator().manual_seed(5))
    for r in range(data * seq * model):
        as_rank(data, seq, model, r)
        g = pdist.layout()
        rows = slice(g.data_rank * 2, g.data_rank * 2 + 2)
        pts = slice(g.seq_rank * n // seq, (g.seq_rank + 1) * n // seq)
        cols = (c, g.model_rank * c // model, (g.model_rank + 1) * c // model)
        got = pdist.batch_rand((2, n // seq, c // model), torch.Generator().manual_seed(3),
                               points=True, channels=cols)
        assert torch.equal(got, want[rows, pts, cols[1]:cols[2]])
        got_int = pdist.batch_randint(0, 9, (2, 1), torch.Generator().manual_seed(4))
        assert torch.equal(got_int, want_int[rows])
        got_row = pdist.batch_rand((2, 1, 1), torch.Generator().manual_seed(6))
        assert torch.equal(got_row, want_row[rows])
        lo, hi = g.seq_rank * 48 // seq, (g.seq_rank + 1) * 48 // seq
        got_stage = pdist.batch_rand((2, hi - lo, 1), torch.Generator().manual_seed(5),
                                     points=True)
        assert torch.equal(got_stage, want_stage[rows, lo:hi])
        assert pdist.local_batch_slice(b) == rows


def test_tp_and_cp_calls_without_their_group_raise(as_rank):
    """No group of the right size, no grid: make_layout, tp_groups and
    context_groups refuse a world that is not data x seq x model;
    shard_model_tp refuses a layout without a model group; a backbone
    forward under a seq axis without its group refuses to run."""
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.models.structure import PointBatch
    from scenesplat_tpu_torch.parallel.tp import shard_model_tp, tp_groups

    with pytest.raises(ValueError, match="needs 4 processes"):
        pdist.make_layout(2, seq=2)
    with pytest.raises(ValueError):
        tp_groups(1, 2)
    with pytest.raises(ValueError, match="no seq axis"):
        context.context_groups(1)
    model = build_model(dict(type="PT-v3m1", in_channels=3, enc_depths=(1, 1),
                             enc_channels=(8, 8), enc_num_head=(2, 2), enc_patch_size=(16, 16),
                             dec_depths=(1,), dec_channels=(8,), dec_num_head=(2,),
                             dec_patch_size=(16,), stride=(2,), order=("z",)))
    with pytest.raises(RuntimeError, match="model group"):
        shard_model_tp(model)
    as_rank(1, 2, 1, 0)  # a seq axis of 2, but no group
    point = PointBatch(coord=torch.zeros(1, 16, 3), feat=torch.zeros(1, 16, 3),
                       grid_coord=torch.zeros(1, 16, 3, dtype=torch.int64),
                       mask=torch.ones(1, 16, dtype=torch.bool))
    with pytest.raises(RuntimeError, match="seq group"):
        model.eval()(point)
