"""The port's single-scene tools against the JAX-side ones: the feature
writer (``utils/save_features.py`` against the repo's
``save_inference_features_simple.py``, file by file), ``entry.py
--save-features`` on the CPU, the PCA tool (``tools.visualize_features_pca``
against ``tools/visualize_features_pca.py``, byte for byte from the same
features, and through the model on the CPU) and the scene viewer
(``tools.visualize_scene`` against ``tools/visualize_scene.py``, both
backends that need no window and every mode). About 45 s alone on one
worker."""

import importlib.util
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from tests.torch_fixtures import one_torch_thread  # noqa: E402,F401 (fixture)

from scenesplat_tpu_torch import entry  # noqa: E402
from scenesplat_tpu_torch.tools import visualize_features_pca as tpca  # noqa: E402
from scenesplat_tpu_torch.tools import visualize_scene as tscene  # noqa: E402
from scenesplat_tpu_torch.utils import save_features as tsave  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _from_file(name, path):
    """A repo script imported as a module by its path."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_scene(root, n=1500, seed=0):
    """A scene directory of the .npy assets the tools read: a 2 m box of
    Gaussians with colour, opacity, quaternion, scale, normal and labels."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    quat = rng.normal(size=(n, 4))
    assets = dict(coord=rng.uniform(0, 2, (n, 3)) + 5.0,
                  color=rng.integers(0, 256, (n, 3)).astype(np.uint8),
                  opacity=rng.uniform(0, 1, n), quat=quat / np.linalg.norm(quat, axis=1)[:, None],
                  scale=rng.uniform(0, 0.05, (n, 3)), normal=rng.normal(size=(n, 3)),
                  segment=rng.integers(0, 20, n))
    for name, x in assets.items():
        np.save(os.path.join(root, f"{name}.npy"),
                x if x.dtype in (np.uint8, np.int64) else x.astype(np.float32))
    return root


def _saved_runs_equal(a, b):
    """Two writers' returns ({artifact: path}): the same artifacts, the same
    names up to the timestamp, equal arrays and equal pickled outputs."""
    assert sorted(a) == sorted(b)
    for tag in a:
        name = re.sub(r"_\d{8}_\d{6}_", "_T_", os.path.basename(a[tag]))
        assert name == re.sub(r"_\d{8}_\d{6}_", "_T_", os.path.basename(b[tag]))
        if tag == "full_output":
            with open(a[tag], "rb") as fa, open(b[tag], "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            if not isinstance(pa, dict):  # a bare feature array
                pa, pb = dict(feat=pa), dict(feat=pb)
            assert sorted(pa) == sorted(pb)
            for key in pa:
                np.testing.assert_array_equal(pa[key], pb[key])
                assert pa[key].dtype == pb[key].dtype
        else:
            xa, xb = np.load(a[tag]), np.load(b[tag])
            assert xa.dtype == xb.dtype and xa.shape == xb.shape
            np.testing.assert_array_equal(xa, xb)


def test_saved_arrays_equal_the_jax_writer(tmp_path, capsys):
    jsave = _from_file("save_inference_features_simple", "save_inference_features_simple.py")
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(300, 768)).astype(np.float32)
    coord = rng.uniform(0, 2, (300, 3)).astype(np.float32)
    inputs = dict(feat=rng.normal(size=(300, 11)).astype(np.float32), coord=coord,
                  lang_feat=rng.normal(size=(300, 768)).astype(np.float16))
    ref = jsave.save_inference_output_simple(dict(point_feat=feat, coord=coord), inputs,
                                             "scene0", results_dir=str(tmp_path / "jax"))
    # the port's writer takes tensors as well as arrays
    got = tsave.save_inference_output_simple(
        dict(point_feat=torch.from_numpy(feat), coord=coord),
        dict(inputs, feat=torch.from_numpy(inputs["feat"])), "scene0",
        results_dir=str(tmp_path / "port"))
    assert sorted(got) == ["coords", "features", "full_output", "input_geom", "input_lang"]
    _saved_runs_equal(ref, got)
    # a bare feature array
    _saved_runs_equal(jsave.save_inference_output_simple(feat, None, "bare", str(tmp_path / "j2")),
                      tsave.save_inference_output_simple(feat, None, "bare", str(tmp_path / "p2")))
    # read back and analyzed alike
    capsys.readouterr()
    a = jsave.analyze_features(str(tmp_path / "jax"))
    text_a = capsys.readouterr().out
    b = tsave.analyze_features(str(tmp_path / "port"))
    text_b = capsys.readouterr().out
    assert re.sub(r"\d{8}_\d{6}", "T", text_a) == re.sub(r"\d{8}_\d{6}", "T", text_b)
    assert "cos(pred, input lang)" in text_b
    for key in ("features", "coords", "input_lang", "input_geom"):
        np.testing.assert_array_equal(a[key], b[key])
    with pytest.raises(FileNotFoundError):
        tsave.load_simple_results(str(tmp_path / "port"), scene_name="missing")


def test_entry_save_features_on_cpu(tmp_path, one_torch_thread):
    """entry.py --save-features writes what the JAX script writes from the
    same run: the features, the coordinates shifted to their least corner,
    the input features, the pickled output; equal, file by file, to the JAX
    writer's files from those arrays."""
    scene = _write_scene(str(tmp_path / "scene0011_00"))
    out = str(tmp_path / "results")
    assert entry.main(["--scene", scene, "--device", "cpu", "--dtype", "float32",
                       "--save-features", "--results-dir", out]) == 0
    run = tsave.load_simple_results(out, scene_name="scene0011_00")
    coord, feat = entry.load_scene(scene)
    coord = coord - coord.min(axis=0)
    assert run["features"].shape == (1500, 768) and run["features"].dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(run["features"], axis=1), 1.0, atol=1e-3)
    np.testing.assert_array_equal(run["coords"], coord)
    np.testing.assert_array_equal(run["input_geom"], feat)
    # the JAX writer from the same features and inputs writes the same files
    jsave = _from_file("save_inference_features_simple", "save_inference_features_simple.py")
    ref = jsave.save_inference_output_simple(dict(point_feat=run["features"], coord=coord),
                                             dict(feat=feat, coord=coord), "scene0011_00",
                                             results_dir=str(tmp_path / "jax"))
    got = {tag: f"{run['prefix']}_{tag}.npy" for tag in ("features", "coords", "input_geom")}
    got["full_output"] = f"{run['prefix']}_full_output.pkl"
    _saved_runs_equal(ref, got)


def test_pca_ply_equals_the_jax_tool_from_the_same_features(tmp_path):
    scene = _write_scene(str(tmp_path / "scene"), n=800, seed=2)
    feat_file = str(tmp_path / "feat.npy")
    np.save(feat_file, np.random.default_rng(3).normal(size=(800, 768)).astype(np.float32))
    ref, got = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "visualize_features_pca.py"),
                    "--scene", scene, "--feat-file", feat_file, "--output", ref],
                   check=True, capture_output=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert tpca.main(["--scene", scene, "--feat-file", feat_file, "--output", got]) == 0
    with open(ref, "rb") as fa, open(got, "rb") as fb:
        data = fb.read()
        assert fa.read() == data
    assert b"element vertex 800\n" in data and data.count(b"\n") == 800 + 10


def test_pca_tool_runs_the_model_on_cpu(tmp_path, one_torch_thread):
    """Without --feat-file the tool extracts features with the flagship
    model (bf16, weights from seed 0): the file equals the PCA colours of
    entry's features of the same scene from that model, at the scene's own
    coordinates."""
    scene = _write_scene(str(tmp_path / "scene"), n=1200, seed=4)
    got = str(tmp_path / "pca.ply")
    assert tpca.main(["--scene", scene, "--output", got, "--device", "cpu"]) == 0
    coord, feat = entry.load_scene(scene)
    model = entry.build_lang_model(dtype="bfloat16", device="cpu", seed=0)
    from scenesplat_tpu_torch.utils.visualization import (features_to_pca_colors,
                                                          save_point_cloud_ply)

    ref = str(tmp_path / "ref.ply")
    save_point_cloud_ply(ref, coord, features_to_pca_colors(
        entry.scene_features(model, coord, feat, "cpu")))
    with open(ref, "rb") as fa, open(got, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("backend,mode", [("ply", "pointcloud"), ("ply", "gaussians"),
                                          ("ply", "both"), ("matplotlib", "pointcloud")])
def test_scene_tool_writes_what_the_jax_tool_writes(tmp_path, backend, mode):
    jscene = _from_file("jax_visualize_scene", os.path.join("tools", "visualize_scene.py"))
    scene = _write_scene(str(tmp_path / "scene0000_00"), n=600, seed=5)
    np.testing.assert_equal(tscene.load_scene_data(scene), jscene.load_scene_data(scene))
    args = ["--mode", mode, "--backend", backend, "--sample-ratio", "0.5"]
    argv = sys.argv
    try:
        sys.argv = ["visualize_scene.py", scene, *args, "--out", str(tmp_path / "jax" / "s")]
        jscene.main()
    finally:
        sys.argv = argv
    assert tscene.main([scene, *args, "--out", str(tmp_path / "port" / "s")]) == 0
    written = sorted(os.listdir(tmp_path / "port"))
    assert written == sorted(os.listdir(tmp_path / "jax"))
    assert written == {"pointcloud": ["s_points.ply"], "gaussians": ["s_gaussians.ply"],
                       "both": ["s_gaussians.ply", "s_points.ply"]}[mode] if backend == "ply" \
        else written == ["s_points.png"]
    for name in written:
        a, b = (tmp_path / side / name for side in ("jax", "port"))
        if name.endswith(".png"):
            from matplotlib.image import imread

            np.testing.assert_array_equal(imread(a), imread(b))
        else:
            assert a.read_bytes() == b.read_bytes()
