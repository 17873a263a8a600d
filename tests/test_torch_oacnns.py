"""Port parity, OA-CNNs: a two-stage OACNNs' eval forward, train forward
with its BatchNorm statistics, loss and every gradient against the JAX
module (tests/test_torch_mink_unet.py's helpers and tolerances: fp32
forwards 1e-5, gradients 1e-4 relative L2, statistics 1e-5), on rows whose
pooled levels fill their capacities exactly (2,048 voxels, then 512 and
128 clusters), so that no level has a padding slot; and the JAX module's
fault: its in-cluster softmax subtracts the largest logit over every slot,
padding included, so its output moves with the padding's content, which
the port's does not (it takes the largest over the real points, as the
reference does)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_mink_unet import (  # noqa: E402,F401
    _jitted,
    check_model,
    fill,
    jax_geometry,
    scene,
)

OACNNS = dict(type="OACNNs", in_channels=6, num_classes=5, embed_channels=8,
              enc_channels=(8, 16), enc_depth=(1, 1), dec_channels=(8, 16),
              point_grid_size=((2, 4), (2, 4, 8)), stage_capacity=(0.25, 0.0625))


def test_oacnns_matches_jax():
    s = scene(0)
    model = check_model(OACNNS, s)
    assert [len(stage.blocks) for stage in model.enc] == [1, 1]


def _block_inputs(seed=0, n=400, valid=300, c=8):
    rng = np.random.default_rng(seed)
    cells = np.unique(rng.integers(0, 10, (4 * n, 3)), axis=0)[:valid]
    grid = np.zeros((1, n, 3), np.int32)
    grid[0, :valid] = cells[rng.permutation(valid)]
    mask = np.arange(n)[None] < valid
    feat = rng.normal(size=(1, n, c)).astype(np.float32)
    return grid, mask, feat


def test_jax_oacnns_block_moves_with_the_padding():
    """One adaptive block in eval mode, the same real points, the padding
    slots' features 0 or 30: the JAX block's output at the real points
    moves (its max runs over the padding), the port's stays bit-equal."""
    from scenesplat_tpu.models.oacnns import OABasicBlock as JBlock
    from scenesplat_tpu.models.spunet import LevelState
    from scenesplat_tpu.ops.pointops import grid_cluster_plan as jcluster
    from scenesplat_tpu.ops.serialization import serialize as jser
    from scenesplat_tpu.ops.subm_conv import build_subm_conv_plan as jplan
    from scenesplat_tpu_torch.models.spunet import make_level
    from scenesplat_tpu_torch.models.oacnns import OABasicBlock
    from scenesplat_tpu_torch.ops.pointops import grid_cluster_plan
    from scenesplat_tpu_torch.ops.serialization import serialize

    grid, mask, feat = _block_inputs()
    padded = feat.copy()
    padded[~mask] = 30.0
    g, m = jnp.asarray(grid), jnp.asarray(mask)
    jser, jplan, jcluster = (_jitted(f.__name__, f) for f in (jser, jplan, jcluster))
    level = LevelState(g, m, jser(g, m, ("z",), 16), jplan(g, m, 3, depth=16))
    plans = [jcluster(g.astype(jnp.float32), m, float(size), grid.shape[1]) for size in (2, 4)]
    block = JBlock(embed_channels=8, num_scales=2)
    shapes = jax.eval_shape(lambda x: block.init(jax.random.PRNGKey(0), x, level, plans, True),
                            jnp.asarray(feat))
    v = fill(shapes, np.random.default_rng(1))
    apply = jax.jit(lambda v, x: block.apply(v, x, level, plans, True))
    jout = [np.asarray(apply(v, jnp.asarray(x)))[mask] for x in (feat, padded)]
    assert np.abs(jout[0] - jout[1]).max() > 1e-3 * np.abs(jout[0]).max()

    tg, tm = torch.from_numpy(grid).long(), torch.from_numpy(mask)
    tlevel = make_level(tg, tm, serialize(tg, tm, ("z",), 16), 16)
    tplans = [grid_cluster_plan(tg.float(), tm, float(size), grid.shape[1]) for size in (2, 4)]
    port = OABasicBlock(8, 2).eval()
    gen = torch.Generator().manual_seed(2)
    for p in port.parameters():
        p.data = torch.randn(p.shape, generator=gen) * 0.3
    with torch.no_grad():
        out = [port(torch.from_numpy(x), tlevel, tplans)[tm] for x in (feat, padded)]
    assert torch.equal(out[0], out[1])
