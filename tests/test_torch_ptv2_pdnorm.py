"""Port parity, PT-v2m3: Point Transformer V2 with every norm a PDNorm
(looked up by the condition's name, the adaptive affine from a context per
row) against the JAX package on tests/test_torch_ptv2.py's MINI and cloud,
the weights carried by ``utils/weights.py:state_dict_from_flax`` and loaded
with strict=True. One jit of the JAX train forward and gradient (about 30 s
of compile on one CPU worker: three norms a slot). Tolerances as
tests/test_torch_ptv2.py's."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax.numpy as jnp  # noqa: E402

from tests.test_torch_ptv2 import (  # noqa: E402
    MINI,
    assert_loss,
    check_grads,
    check_stats,
    close,
    cloud,
    jax_run,
    port_model,
    port_run,
    torch_point,
)

CTX = 16
CONDITIONS = ("ScanNet", "S3DIS", "Structured3D")


def test_ptv2_matches_jax_m3():
    """The train forward on condition S3DIS with a context row each, its
    loss, every gradient and the active condition's running statistics (JAX
    moves every condition's, ROADMAP Queue 3)."""
    cfg = dict(MINI, type="PT-v2m3", conditions=CONDITIONS, context_channels=CTX)
    s = cloud(0)
    ctx = np.random.default_rng(9).normal(size=(2, CTX)).astype(np.float32)
    want = jax_run(cfg, s, dict(condition_index=jnp.asarray(1, jnp.int32),
                                context=jnp.asarray(ctx)))
    model = port_model(cfg, want["variables"])
    _, train_fwd, loss = port_run(model, s, want["cot"], condition=CONDITIONS[1],
                                  context=torch.from_numpy(ctx))
    close(train_fwd, want["train_fwd"], "train forward")
    assert_loss(loss, want)
    check_grads(model, want["grads"])
    other = re.compile(r"\.norm\.[02]\.running_")  # the inactive conditions
    check_stats(model, want["stats"], skip=lambda k: other.search(k) is not None)


def test_ptv2m3_needs_the_condition():
    """A PDNorm backbone without a condition raises (the JAX package falls
    back to the first condition's norms)."""
    from scenesplat_tpu_torch.models import build_model

    model = build_model(dict(MINI, type="PT-v2m3", conditions=CONDITIONS, pd_adaptive=False))
    with pytest.raises(ValueError, match="condition"):
        model(torch_point(cloud(0)))
