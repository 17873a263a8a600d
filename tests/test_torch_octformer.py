"""Port parity, OctFormer-v1m1: a narrow OctFormer's eval forward, train
forward with its BatchNorm statistics, loss and every gradient against the
JAX module in both quantizations (tests/test_torch_mink_unet.py's helpers
and tolerances: fp32 forwards 1e-5, gradients 1e-4 relative L2,
statistics 1e-5), drop path 0 (the JAX module's nn.Dropout draws from
JAX's generator); and the port's drop path apart: a whole scene's branch
kept or dropped.

The model's first stage has two blocks (the second dilated by 2), windows
of 6 points (so each level's last window is ragged) and one head-up
deconv. "ocnn": a second stage of one block behind a downsample, a patch
embed of two pools (the finer one unpooled nearest), over rows of jittered
points in leaves of 4 cm (about eight points a leaf, mean-pooled, then
unpooled to each point); "cmin": one stem pool and the first stage alone,
over rows of one point a voxel, at the voxel centres."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_mink_unet import (  # noqa: E402,F401
    check_model,
    jax_geometry,
    scene,
    torch_point,
)

OCTFORMER = dict(type="OctFormer-v1m1", in_channels=6, num_classes=5, fpn_channels=8,
                 channels=(8, 16), num_blocks=(2, 1), num_heads=(2, 2), patch_size=6,
                 stem_down=2, head_up=1, dilation=2, drop_path=0.0, octree_scale_factor=0.64,
                 octree_depth=5, serialization_depth=10)
OCNN = dict(OCTFORMER, quantization="ocnn")


# "cmin": cells of 0.5 / 2**5 = 1/64, a binary fraction, so that (coord -
# min) / cell is exact on both sides at the voxel centres; one stem pool
# and the first stage alone
CMIN = dict(OCTFORMER, quantization="cmin", octree_scale_factor=0.5, stem_down=1,
            channels=(8,), num_blocks=(2,), num_heads=(2,))


def _centred(s):
    """``s`` with each point at the centre of its 1/64 voxel."""
    coord = (s["grid"].astype(np.float32) + 0.5) / 64
    return dict(s, coord=np.where(s["mask"][..., None], coord, 0.0).astype(np.float32))


@pytest.mark.parametrize("quantization", ["ocnn", "cmin"])
def test_octformer_matches_jax(quantization):
    s = scene(0) if quantization == "ocnn" else _centred(scene(0))
    cfg = OCNN if quantization == "ocnn" else CMIN
    model = check_model(cfg, s)
    n = s["mask"].shape[1]
    assert n % (cfg["patch_size"] * cfg["dilation"]) != 0  # a ragged last window
    out = model.eval()(torch_point(s))
    leaves = out.plans[0].out_mask.sum(1) if quantization == "ocnn" else None
    if leaves is not None:  # leaves hold several points each
        assert (leaves < torch.from_numpy(s["mask"]).sum(1)).all()
    assert model.layers[0].blocks[1].attention.dilation == 2


def test_drop_path_takes_whole_scenes():
    """Each row keeps its branch scaled by 1 / (1 - p) or loses it whole,
    rows apart, as the generator draws; no generator refuses."""
    from scenesplat_tpu_torch.models.octformer import drop_path

    x = torch.randn(64, 50, 4) + 3.0
    y = drop_path(x, 0.5, torch.Generator().manual_seed(0))
    kept = (y == x / 0.5).all(-1).all(-1)
    dropped = (y == 0).all(-1).all(-1)
    assert (kept ^ dropped).all() and 10 < int(kept.sum()) < 54
    assert torch.equal(y, drop_path(x, 0.5, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="Generator"):
        drop_path(x, 0.5, None)


def test_octformer_training_forward_draws_drop_path():
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(OCTFORMER, drop_path=0.5)).train()
    point = torch_point(scene(1))

    def run(seed):
        with torch.no_grad():
            return model(point, generator=torch.Generator().manual_seed(seed)).feat

    assert torch.equal(run(3), run(3))
    assert not torch.allclose(run(3), run(5))  # seeds whose draws differ
