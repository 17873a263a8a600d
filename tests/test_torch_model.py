"""Port parity, whole model: the port's LangPretrainer over PT-v3m1 against
the JAX package's, with the JAX weights carried by
``scenesplat_tpu_torch/utils/weights.py`` and loaded with strict=True, on
the same numpy scenes; plus the decoder-window-48 fault the port fixes and
the FeatureExtractor + zero-shot path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.test_full_model_golden import DEEP, MINI, _make_scene  # noqa: E402

RTOL, ATOL = 1e-4, 2e-4  # the export bridge's bar (tests/test_export_bridge.py)


def _jax_model(cfg, stage_capacity, **extra):
    from scenesplat_tpu.models import build_model

    return build_model(dict(type="LangPretrainer", backbone=dict(
        type="PT-v3m1", **cfg, upcast_softmax=True, use_pallas=False,
        stage_capacity=stage_capacity, **extra)))


def _jax_point(coord, grid, feat, mask):
    from scenesplat_tpu.models import PointBatch

    return PointBatch(coord=jnp.asarray(coord)[None], feat=jnp.asarray(feat)[None],
                      grid_coord=jnp.asarray(grid)[None],
                      mask=jnp.asarray(mask)[None])


def _torch_model(cfg, stage_capacity, params, stats, **extra):
    from scenesplat_tpu_torch.models import build_model
    from scenesplat_tpu_torch.utils.weights import load_flax_weights

    model = build_model(dict(type="LangPretrainer", backbone=dict(
        type="PT-v3m1", **cfg, stage_capacity=stage_capacity, **extra)))
    return load_flax_weights(model, params, stats).eval()


def _torch_forward(model, coord, grid, feat, mask):
    from scenesplat_tpu_torch.models import PointBatch

    point = PointBatch(coord=torch.from_numpy(coord)[None],
                       feat=torch.from_numpy(feat)[None],
                       grid_coord=torch.from_numpy(grid)[None],
                       mask=torch.from_numpy(mask)[None])
    with torch.inference_mode():
        out = model(point)
    return out.feat[0].float().numpy(), out


def _numpy_variables(model, point, rng):
    """Parameters and BatchNorm statistics made with numpy from ``rng`` at
    the shapes flax would give them (``jax.eval_shape`` traces the init
    without compiling it): fan-in scaled kernels, norm scales near 1, small
    biases, running statistics away from their 0/1 init so BN is exercised."""
    shapes = jax.eval_shape(lambda p: model.init(
        {"params": jax.random.PRNGKey(0), "shuffle": jax.random.PRNGKey(1)},
        p, train=False), point)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            x = rng.normal(size=leaf.shape) / np.sqrt(fan_in)
        elif name == "scale":
            x = 1 + 0.1 * rng.normal(size=leaf.shape)
        elif name in ("bias", "mean"):
            x = 0.1 * rng.normal(size=leaf.shape)
        elif name == "var":
            x = rng.uniform(0.5, 1.5, size=leaf.shape)
        else:
            raise KeyError(f"unexpected variable {jax.tree_util.keystr(path)}")
        return np.asarray(x, leaf.dtype)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return variables["params"], variables["batch_stats"]


def _case(cfg, stage_capacity, seed, n_parents=128, levels=1, pad=0, **extra):
    """A scene (with ``pad`` trailing padding slots), numpy-made weights and
    the JAX forward's features."""
    rng = np.random.default_rng(seed)
    coord, grid, feat = _make_scene(rng, n_parents=n_parents, levels=levels)
    n = len(grid)
    coord = np.concatenate([coord, np.zeros((pad, 3), np.float32)])
    grid = np.concatenate([grid, np.zeros((pad, 3), np.int32)])
    feat = np.concatenate([feat, np.zeros((pad, feat.shape[1]), np.float32)])
    mask = np.arange(n + pad) < n
    model = _jax_model(cfg, stage_capacity, **extra)
    point = _jax_point(coord, grid, feat, mask)
    params, stats = _numpy_variables(model, point, rng)
    return dict(coord=coord, grid=grid, feat=feat, mask=mask, params=params,
                stats=stats, model=model, point=point)


def _jax_forward(case, model=None):
    model = model or case["model"]
    feat = jax.jit(lambda v, p: model.apply(v, p, train=False).feat)(
        {"params": case["params"], "batch_stats": case["stats"]}, case["point"])
    return np.asarray(feat[0].astype(jnp.float32))


@pytest.fixture(scope="module")
def mini():
    case = _case(MINI, (0.5,), seed=42, pad=16)
    case["ref"] = _jax_forward(case)
    return case


@pytest.fixture(scope="module")
def deep():
    case = _case(DEEP, (0.5, 0.25), seed=7, n_parents=64, levels=2)
    case["ref"] = _jax_forward(case)
    return case


def test_weights_equal_export_key_for_key(mini):
    from scenesplat_tpu.utils.ckpt_bridge import export_ptv3_lang_checkpoint
    from scenesplat_tpu_torch.utils.weights import state_dict_from_flax

    ours = state_dict_from_flax(mini["params"], mini["stats"])
    ref = export_ptv3_lang_checkpoint(mini["params"], mini["stats"])
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    # and the port's module tree has exactly these keys
    model = _torch_model(MINI, (0.5,), mini["params"], mini["stats"])
    assert sorted(model.state_dict()) == sorted(ref)


@pytest.mark.parametrize("which", ["mini", "deep"])
def test_lang_pretrainer_forward_fp32(which, request):
    case = request.getfixturevalue(which)
    cfg, caps = (MINI, (0.5,)) if which == "mini" else (DEEP, (0.5, 0.25))
    model = _torch_model(cfg, caps, case["params"], case["stats"])
    got, out = _torch_forward(model, case["coord"], case["grid"], case["feat"],
                              case["mask"])
    m = case["mask"]
    np.testing.assert_allclose(got[m], case["ref"][m], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got[m], axis=-1), 1.0, atol=1e-5)
    assert all(int(p.n_overflow.max()) == 0 for p in out.plans)


def test_lang_pretrainer_forward_bf16(mini):
    """dtype=bfloat16 on both sides. The two round at different places (the
    JAX package sums pooled features and adds biases in bf16, the port in
    fp32), so each is held to the fp32 result instead of to the other: the
    port's relative error may be at most 2.5x the JAX package's own bf16
    error (the noise-floor rule of tests/test_attention.py)."""
    jmodel = _jax_model(MINI, (0.5,), dtype="bfloat16")
    ref16 = _jax_forward(mini, jmodel)
    model = _torch_model(MINI, (0.5,), mini["params"], mini["stats"],
                         dtype="bfloat16")
    got16, out = _torch_forward(model, mini["coord"], mini["grid"], mini["feat"],
                                mini["mask"])
    assert out.feat.dtype == torch.bfloat16
    m = mini["mask"]
    truth = mini["ref"][m]

    def rel(a):
        return float(np.linalg.norm(a[m] - truth) / np.linalg.norm(truth))

    floor, err = rel(ref16), rel(got16)
    assert floor > 1e-4, "bf16 path not exercised"
    assert err <= 2.5 * floor, (err, floor)


def test_decoder_window_48_ragged():
    """configs/test_lang_inference.py leaves dec_patch_size at 48, and no
    stage size there is a multiple of 48, which the JAX package rejects. The
    port's last window is ragged instead: at 270 points (270 % 48 = 30) it
    equals the JAX model on the same points padded to 288 = 6 * 48 slots."""
    cfg = dict(MINI, dec_patch_size=(48,))
    case = _case(cfg, (0.5,), seed=3, n_parents=135, pad=18)
    assert case["mask"].sum() == 270 and len(case["mask"]) == 288
    ref = _jax_forward(case)[:270]
    tmodel = _torch_model(cfg, (0.5,), case["params"], case["stats"])
    got, _ = _torch_forward(tmodel, case["coord"][:270], case["grid"][:270],
                            case["feat"][:270], np.ones(270, bool))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_feature_extractor_zero_shot(mini):
    """Bucket padding + forward + zero-shot prediction against text
    embeddings on one scene: the port's FeatureExtractor pads the scene's
    points to the JAX ladder's bucket (1024 slots) and must give the JAX
    forward's features and the JAX zero-shot predictions."""
    from scenesplat_tpu.engines import infer as jinfer
    from scenesplat_tpu.engines.eval import zero_shot_predict as jpredict
    from scenesplat_tpu_torch.engines import infer as tinfer
    from scenesplat_tpu_torch.engines.eval import zero_shot_predict

    for patch in (16, 48, 1024):
        assert tinfer.default_buckets(patch) == jinfer.default_buckets(patch)
        for n in (1, 1000, 1025, 5000, 600000):
            assert tinfer.bucket_size(n, patch) == jinfer.bucket_size(n, patch)

    rng = np.random.default_rng(8)
    text = rng.normal(size=(20, MINI["dec_channels"][0])).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    m = mini["mask"]
    sample = dict(coord=mini["coord"][m], feat=mini["feat"][m],
                  grid_coord=mini["grid"][m])
    model = _torch_model(MINI, (0.5,), mini["params"], mini["stats"])
    got_feat = tinfer.FeatureExtractor(model, patch_size=16, device="cpu")(sample)
    ref_feat = mini["ref"][m]
    np.testing.assert_allclose(got_feat, ref_feat, rtol=RTOL, atol=ATOL)
    ref_pred, ref_prob = jpredict(ref_feat, text, confidence_threshold=0.5)
    pred, prob = zero_shot_predict(got_feat, text, confidence_threshold=0.5)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_allclose(prob, ref_prob, rtol=1e-4)
