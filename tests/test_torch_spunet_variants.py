"""Port parity, SpUNet-v1m2 (its BatchNorm momentum of 0.02) and
SpUNetNoSkipBase (a decoder without skips) against the JAX package, with
the helpers and tolerances of tests/test_torch_spunet.py (a file of its
own: each variant's JAX jit compiles for about 30 s)."""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_spunet import check_variant  # noqa: E402


def test_spunet_v1m2_matches_jax():
    model = check_variant("v1m2", seed=6)
    assert model.conv_input.normalization.momentum == 0.02


def test_spunet_noskip_matches_jax():
    model = check_variant("noskip", seed=7)
    assert model.dec[0].block0.conv1.weight.shape[3] == 8  # no skip channels
