"""Port parity, the visualization writers and seeding: the port's PLY
bytes (with and without colours), PCA colours and label palette equal
``scenesplat_tpu/utils/visualization.py``'s, and ``set_seed`` gives the
numpy, Python and transform streams that the JAX package's gives."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from scenesplat_tpu.utils import env as jenv  # noqa: E402
from scenesplat_tpu.utils import visualization as jvis  # noqa: E402
from scenesplat_tpu_torch.utils import env as tenv  # noqa: E402
from scenesplat_tpu_torch.utils import visualization as tvis  # noqa: E402


@pytest.mark.parametrize("with_color", [False, True])
def test_ply_bytes_equal_jax(tmp_path, with_color):
    rng = np.random.default_rng(0)
    coord = rng.normal(size=(50, 3)).astype(np.float32)
    color = rng.uniform(-20, 300, (50, 3)) if with_color else None
    jvis.save_point_cloud_ply(str(tmp_path / "jax" / "a.ply"), coord, color)
    tvis.save_point_cloud_ply(str(tmp_path / "port" / "a.ply"), coord, color)
    got = (tmp_path / "port" / "a.ply").read_bytes()
    assert got == (tmp_path / "jax" / "a.ply").read_bytes()
    assert got.count(b"\n") == 50 + (10 if with_color else 7)


@pytest.mark.parametrize("n,d", [(200, 768), (30, 8), (1, 4)])
def test_pca_colors_equal_jax(n, d):
    feat = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32)
    got = tvis.features_to_pca_colors(feat)
    assert got.dtype == np.uint8 and got.shape == (n, 3)
    assert np.array_equal(got, jvis.features_to_pca_colors(feat))


def test_label_palette_equals_jax():
    labels = np.array([-1, 0, 3, 19, 20, 255, 5, 5])
    got = tvis.segmentation_to_colors(labels, 20)
    assert np.array_equal(got, jvis.segmentation_to_colors(labels, 20))
    assert (got[[0, 4, 5]] == 128).all() and np.array_equal(got[6], got[7])


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5])
def test_set_seed_gives_the_jax_streams(seed):
    """numpy's global stream, Python's and this thread's transform RNG
    after the port's set_seed equal those after the JAX package's; torch's
    stream is seeded too."""
    from scenesplat_tpu.data.transforms import trng as jtrng
    from scenesplat_tpu_torch.data.transforms import trng as ttrng

    assert jenv.set_seed(seed) == seed
    want = (np.random.rand(5), random.random(), jtrng().random(5))
    assert tenv.set_seed(seed) == seed
    got = (np.random.rand(5), random.random(), ttrng().random(5))
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    first = torch.rand(3)
    tenv.set_seed(seed)
    assert torch.equal(torch.rand(3), first)
    assert isinstance(tenv.set_seed(None), int)
