"""Module fixtures that the port's test files import (``from
tests.torch_fixtures import ...``): each applies to the whole file that
imports it."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's torch work in the file. The
    suite runs files in parallel processes, and each process's torch ops
    start an OpenMP team as wide as the machine; beside other workers'
    teams they spin against each other (a train entry test of 8 s took
    over 15 minutes beside five copies of itself on 8 cores; the plain
    bitonic sort's file, 22 s alone, took 527 s of a worker's time in the
    suite, and 26 s with one thread)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def fused_jax_conv():
    """The JAX package's fused submanifold conv for the file's JAX models
    (``SCENESPLAT_CONV_APPLY=fused``: one gather and one fp32 einsum over
    the K3 x Cin products, as the port's one matmul a chunk), whose jit
    compiles in under half the per-offset loop's time (SpUNet-v1m1's step:
    47 s to 20 s on one CPU worker). A file whose JAX models hold a
    submanifold conv (SpUNet, PT-v3m1) may import it; module-scoped, so it
    is set before the file's module fixtures trace. Each family keeps files
    on the package's default per-offset conv: test_torch_spunet.py and
    test_torch_spunet_variants.py (SpUNet), test_torch_model.py and
    test_torch_ssl_step.py (PT-v3m1)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SCENESPLAT_CONV_APPLY", "fused")
        yield
