"""Port parity, SPVCNN: point -> voxel and the trilinear voxel -> point
against the JAX package's functions, and a narrow SPVCNN's eval forward,
train forward with its BatchNorm statistics, loss and every gradient
against the JAX module (tests/test_torch_mink_unet.py's helpers, rows and
tolerances: fp32 forwards 1e-5, gradients 1e-4 relative L2, statistics
1e-5). The train forward is compared without its dropout: the JAX
module's nn.Dropout and the port module's ``dropout`` are replaced by the
identity for the test; the port's dropout is checked apart."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import flax.linen as fnn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_mink_unet import (  # noqa: E402,F401
    RTOL,
    check_model,
    close,
    jax_geometry,
    scene,
    torch_point,
)

SPVCNN = dict(type="SPVCNN", in_channels=6, out_channels=5, base_channels=8,
              channels=(8, 16, 16, 16, 16, 16, 8, 8), layers=(1,) * 8)


class _NoDropout(fnn.Module):
    rate: float
    deterministic: bool = False

    @fnn.compact
    def __call__(self, x):
        return x


def test_spvcnn_matches_jax(monkeypatch):
    import scenesplat_tpu_torch.models.spvcnn as port_spvcnn

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    monkeypatch.setattr(port_spvcnn, "dropout", lambda x, p, generator: x)
    model = check_model(SPVCNN, scene(0))
    assert len(model.stage1) == 2 and len(model.up4[1]) == 1


def test_voxel_transfers_match_jax():
    """point_to_voxel's masked means and voxel_to_point's trilinear mix at
    strides 4 and 16 of one row's pooled levels (missing corners weigh 0)."""
    from scenesplat_tpu.models.spunet import LevelState
    from scenesplat_tpu.models.spvcnn import point_to_voxel as jp2v
    from scenesplat_tpu.models.spvcnn import voxel_to_point as jv2p
    from scenesplat_tpu.ops.serialization import serialize as jser
    from scenesplat_tpu_torch.models.ptv3 import StageState
    from scenesplat_tpu_torch.models.spvcnn import point_to_voxel, voxel_to_point

    s = scene(2)
    rng = np.random.default_rng(3)
    grid0, mask = s["grid"], s["mask"]
    feat = rng.normal(size=grid0.shape[:2] + (4,)).astype(np.float32)
    for log2 in (2, 4):
        b, n = mask.shape
        lv = np.zeros_like(grid0)
        lm = np.zeros_like(mask)
        p2l = np.zeros(mask.shape, np.int64)
        for i in range(b):
            cells, inv = np.unique(grid0[i][mask[i]] >> log2, axis=0, return_inverse=True)
            lv[i, : len(cells)], lm[i, : len(cells)] = cells, True
            p2l[i, mask[i]] = inv.reshape(-1)
        vox = rng.normal(size=lv.shape[:2] + (4,)).astype(np.float32)
        jlevel = LevelState(jnp.asarray(lv), jnp.asarray(lm),
                            jser(jnp.asarray(lv), jnp.asarray(lm), ("z",), 16), None)
        want = jv2p(jnp.asarray(vox), jlevel, jnp.asarray(grid0), jnp.asarray(mask), log2, 16)
        level = StageState(None, torch.from_numpy(lv).long(), torch.from_numpy(lm), None, None)
        got = voxel_to_point(torch.from_numpy(vox), level, torch.from_numpy(grid0),
                             torch.from_numpy(mask), log2, 16)
        m = mask[..., None]
        close(got.numpy() * m, np.asarray(want) * m, f"voxel_to_point at stride {1 << log2}")
        want = jp2v(jnp.asarray(feat), jnp.asarray(p2l), jnp.asarray(mask), n)
        got = point_to_voxel(torch.from_numpy(feat), torch.from_numpy(p2l),
                             torch.from_numpy(mask), n)
        close(got, want, f"point_to_voxel at stride {1 << log2}", RTOL)


def test_spvcnn_dropout_draws_from_the_generator():
    """A training forward drops 0.3 of the up stages' inputs, as the
    generator draws them: the same seed gives the same output, another
    seed another, and without a generator it refuses."""
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(SPVCNN)).train()
    point = torch_point(scene(4, rows=1))

    def run(seed):
        with torch.no_grad():
            return model(point, generator=torch.Generator().manual_seed(seed)).feat

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))
    with pytest.raises(ValueError, match="Generator"):
        model(point)
