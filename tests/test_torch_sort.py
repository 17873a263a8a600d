"""Port parity, the row sort: the plain version of the port's bitonic sort
against the JAX package's Pallas kernel in interpret mode on the same
numpy-seeded rows (tolerance: exact, payloads included, since both run one
deterministic network on identically padded rows), and the port's sort
sites with the switch on against the switch off (exact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from scenesplat_tpu.ops import pallas_sort as jsort  # noqa: E402
from scenesplat_tpu.ops import serialization as jser  # noqa: E402
from scenesplat_tpu_torch.ops import bitonic_sort as tsort  # noqa: E402
from scenesplat_tpu_torch.ops import segops as tseg  # noqa: E402
from scenesplat_tpu_torch.ops import serialization as tser  # noqa: E402
from scenesplat_tpu_torch.ops import subm_conv as tconv  # noqa: E402
from tests.test_torch_ops import ORDERS, _padded_scene, _t  # noqa: E402


def _rows(case, rng):
    """(operands as uint32/int32 numpy arrays, num_keys): the cases of
    tests/test_pallas_sort.py."""
    if case.startswith("single_key_"):
        n = int(case.rsplit("_", 1)[1])
        return [rng.integers(0, 2**31, (3, n)).astype(np.uint32),
                np.tile(np.arange(n, dtype=np.int32), (3, 1))], 1
    if case == "two_key":
        return [rng.integers(0, 4, (2, 2048)).astype(np.uint32),
                rng.integers(0, 2**24, (2, 2048)).astype(np.uint32),
                np.tile(np.arange(2048, dtype=np.int32), (2, 1))], 2
    if case == "heavy_ties_1d":
        return [rng.integers(0, 8, 3000).astype(np.uint32), np.arange(3000, dtype=np.int32)], 1
    if case == "three_operands":
        return [rng.integers(0, 2**20, (2, 1024)).astype(np.uint32),
                rng.integers(0, 100, (2, 1024)).astype(np.int32),
                np.tile(np.arange(1024, dtype=np.int32), (2, 1))], 1
    if case == "high_bit_keys":  # unsigned order: keys above 2^31 sort last
        return [rng.integers(0, 2**32, (2, 1500), dtype=np.uint64).astype(np.uint32),
                np.tile(np.arange(1500, dtype=np.int32), (2, 1))], 1
    raise KeyError(case)


@pytest.mark.parametrize("case", [
    "single_key_1000", "single_key_1024", "single_key_4096", "single_key_5000", "two_key",
    "heavy_ties_1d", "three_operands", "high_bit_keys"])
def test_plain_sort_equals_pallas_interpret(case):
    ops, num_keys = _rows(case, np.random.default_rng(len(case)))
    ref = [np.asarray(o) for o in jsort.bitonic_sort(
        [jnp.asarray(o) for o in ops], num_keys=num_keys, interpret=True)]
    got = tsort.bitonic_sort_reference([_t(o.view(np.int32)) for o in ops], num_keys)
    got = [g.numpy().view(o.dtype) for g, o in zip(got, ops)]
    # same network, same padding: every operand equal, payloads included
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    # and it is a sort: keys ascending as unsigned tuples, the payload a
    # permutation that still sits beside its key
    keys = np.zeros(ops[0].shape, np.uint64)
    for k in ops[:num_keys]:
        keys = (keys << np.uint64(32)) | k.astype(np.uint64)
    sorted_keys = np.zeros(ops[0].shape, np.uint64)
    for k in got[:num_keys]:
        sorted_keys = (sorted_keys << np.uint64(32)) | k.astype(np.uint64)
    np.testing.assert_array_equal(sorted_keys, np.sort(keys, axis=-1))
    perm = got[-1].astype(np.int64)
    np.testing.assert_array_equal(np.sort(perm, axis=-1),
                                  np.broadcast_to(np.arange(ops[0].shape[-1]), perm.shape))
    for src, out in zip(ops[:-1], got[:-1]):
        np.testing.assert_array_equal(np.take_along_axis(src, perm, -1), out)


@pytest.mark.parametrize("switch", ["off", "on"])
def test_sort_int64_equals_jax_sort_rows(monkeypatch, switch):
    """The sort sites' drop-in against the JAX package's: ``sort_int64`` of
    codes with heavy ties gives the keys and the order that the JAX
    ``sort_rows`` gives for the codes' (high, low) halves and the index."""
    monkeypatch.setenv(tsort.ENV_SWITCH, "1" if switch == "on" else "0")
    monkeypatch.delenv("SCENESPLAT_PALLAS_SORT", raising=False)
    rng = np.random.default_rng(3)
    n = 3000
    code = rng.integers(0, 2**10, (2, n)) << 30  # both halves set, heavy ties
    code[:, -n // 6:] = tser.SENTINEL
    hi, lo = (code >> 32).astype(np.uint32), (code & 0xFFFFFFFF).astype(np.uint32)
    idx = np.tile(np.arange(n, dtype=np.int32), (2, 1))
    rh, rl, ri = (np.asarray(x) for x in jsort.sort_rows(
        (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(idx)), num_keys=3))
    values, order = tsort.sort_int64(_t(code))
    np.testing.assert_array_equal(values.numpy(),
                                  (rh.astype(np.int64) << 32) | rl.astype(np.int64))
    np.testing.assert_array_equal(order.numpy(), ri)
    assert tsort.bitonic_sort.launches == 0  # CPU tensors: no kernel


@pytest.mark.parametrize("shape", [(4, 2, 700), (3, 1, 1024), (2, 3, 1500), (900,)])
def test_sort_int64_switch_on_equals_torch_sort(monkeypatch, shape):
    """Codes with duplicates and a sentinel tail: sorted values and the
    stable order are equal with the switch off and on."""
    rng = np.random.default_rng(sum(shape))
    code = rng.integers(0, 1 << 48, shape)
    code[..., : shape[-1] // 3] = code[..., shape[-1] // 3: 2 * (shape[-1] // 3)]  # ties
    code[..., -(shape[-1] // 5):] = tser.SENTINEL
    code = _t(code)
    monkeypatch.delenv(tsort.ENV_SWITCH, raising=False)
    values_off, order_off = tsort.sort_int64(code)
    monkeypatch.setenv(tsort.ENV_SWITCH, "1")
    values_on, order_on = tsort.sort_int64(code)
    assert torch.equal(values_off, values_on) and torch.equal(order_off, order_on)
    assert order_on.dtype == torch.int64
    if len(shape) == 3:
        order, inverse = tser.sort_codes(code)
        assert torch.equal(order, order_off)
        assert torch.equal(torch.gather(inverse, -1, order),
                           torch.arange(shape[-1]).expand(shape))


def test_sort_sites_switch_on_equal_switch_off(monkeypatch):
    """serialize, pool_serialization and build_subm_conv_plan return equal
    tensors with the switch off and on, and serialize matches the JAX
    serialize order on the real points."""
    _, grid, mask, _ = _padded_scene(31, n_parents=160, levels=2, pad=41)

    def run():
        ser = tser.serialize(_t(grid), _t(mask), ORDERS, 10)
        plan = tseg.build_pooling_plan(ser, _t(mask), 400, 1)
        pooled = tseg.pool_serialization(plan, ser, 1)
        conv = tconv.build_subm_conv_plan(_t(grid), _t(mask), 3, 10)
        conv2 = tconv.build_subm_conv_plan(_t(np.concatenate([grid, grid + 1])),
                                           _t(np.concatenate([mask, mask])), 5, 10)
        return dict(order=ser.order, inverse=ser.inverse, pooled_code=pooled.code,
                    pooled_order=pooled.order, pooled_inverse=pooled.inverse,
                    nbr=conv.neighbor_index, nbr_valid=conv.neighbor_valid,
                    nbr_b2=conv2.neighbor_index, nbr_valid_b2=conv2.neighbor_valid)

    monkeypatch.delenv(tsort.ENV_SWITCH, raising=False)
    off = run()
    monkeypatch.setenv(tsort.ENV_SWITCH, "1")
    on = run()
    for key in off:
        assert torch.equal(off[key], on[key]), key
    ser_j = jser.serialize(jnp.asarray(grid), jnp.asarray(mask), ORDERS, 10)
    nv = int(mask.sum())
    np.testing.assert_array_equal(on["order"].numpy()[..., :nv],
                                  np.asarray(ser_j.order)[..., :nv])


def test_switch_and_config_option(monkeypatch):
    from scenesplat_tpu_torch.utils.config import Config

    monkeypatch.delenv(tsort.ENV_SWITCH, raising=False)
    assert not tsort.use_bitonic_sort()
    tsort.apply_sort_switch(Config(dict(seed=0)))
    assert not tsort.use_bitonic_sort()
    cfg = Config(dict(seed=0)).merge_from_options(["bitonic_sort=True"])
    tsort.apply_sort_switch(cfg)
    assert tsort.use_bitonic_sort()
    tsort.apply_sort_switch(Config(dict(bitonic_sort=False)))
    assert not tsort.use_bitonic_sort()
    monkeypatch.delenv(tsort.ENV_SWITCH, raising=False)  # set through os.environ above


def test_wrapper_checks_and_padding():
    """CPU tensors take the plain version without a launch; operands are
    checked; the sentinel codes stay strictly below the padding keys."""
    k = torch.arange(10, dtype=torch.int32).flip(0)
    before = tsort.bitonic_sort.launches
    (out,) = tsort.bitonic_sort([k], 1)
    assert out.tolist() == list(range(10)) and k[0] == 9  # the input is left alone
    assert tsort.bitonic_sort.launches == before
    with pytest.raises(TypeError):
        tsort.bitonic_sort([k.long()], 1)
    with pytest.raises(ValueError):
        tsort.bitonic_sort([k, k[:5]], 1)
    with pytest.raises(ValueError):
        tsort.bitonic_sort([k] * 5, 1)
    with pytest.raises(ValueError):
        tsort.bitonic_sort([k, k], 3)
    assert [tsort.padded_length(n) for n in (1, 1000, 1024, 1025, 196608)] == [
        1024, 1024, 1024, 2048, 262144]
    assert [tsort.padded_length(n) for n in (1000, 5000, 196608)] == [
        jsort._next_pow2(n) for n in (1000, 5000, 196608)]
    assert [tsort.kernel_launches(n) for n in (1000, 4096, 8192, 196608)] == [1, 1, 3, 28]
    for sentinel in (tser.SENTINEL, tconv._PAD_KEY):
        assert sentinel >> 32 == 0x40000000 < 0xFFFFFFFF


def test_kernel_source_and_build_command():
    """K3 ships as CUDA C++ for sm_90a with a plain C entry point that the
    ctypes binding declares; both kernels' libraries go to one directory,
    named by source and hash, through one helper."""
    from scenesplat_tpu_torch.ops import _build
    from scenesplat_tpu_torch.ops import flash_window_attn as tfwa

    src = tsort.SOURCE.read_text()
    assert 'extern "C" int bitonic_sort_rows(' in src and "__global__" in src
    assert "__syncthreads" in src
    for banned in ("thrust", "cub::", "#include <cub"):
        assert banned not in src
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = tsort.LIBRARY.path()
    assert path.parent == _build.BUILD_DIR == tfwa.LIBRARY.path().parent
    assert path.name.startswith("libbitonic_sort_") and path.suffix == ".so"
    assert tfwa.LIBRARY.path().name.startswith("libflash_window_attn_")
    assert isinstance(tfwa.LIBRARY, _build.KernelLibrary)
