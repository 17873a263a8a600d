"""Persist single-scene inference outputs for offline analysis (counterpart
of the repo's ``save_inference_features_simple.py``, which the JAX
single-scene script writes through; the port keeps its own copy).

Saves the core artifacts of a LangPretrainer forward (the per-Gaussian
features, the coordinates and the input features) as timestamped ``.npy``
files and the whole output as a pickle, under the same names and with the
same arrays as that script; ``load_simple_results`` reads a run back and
``analyze_features`` prints its norm and cosine statistics.

    python -m scenesplat_tpu_torch.utils.save_features --results-dir DIR
"""

from __future__ import annotations

import glob
import os
import pickle
from datetime import datetime

import numpy as np
import torch


def _to_numpy(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_inference_output_simple(output, input_dict, scene_name, results_dir="results"):
    """Save model output and inputs; returns {artifact: path}.

    ``output`` may be a dict with "point_feat" (or "feat") and "coord", or
    a bare feature array; numpy arrays and tensors (on any device) alike.
    Files: ``<scene>_<timestamp>_{features,coords,input_lang,input_geom}.npy``
    and ``<scene>_<timestamp>_full_output.pkl``."""
    os.makedirs(results_dir, exist_ok=True)
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    prefix = os.path.join(results_dir, f"{scene_name}_{timestamp}")
    saved = {}

    def _save(tag, array):
        if array is None:
            return
        array = _to_numpy(array)
        path = f"{prefix}_{tag}.npy"
        np.save(path, array)
        saved[tag] = path
        print(f"   {tag}: {os.path.basename(path)} {array.shape}")

    if isinstance(output, dict):
        feat = output.get("point_feat", output.get("feat"))
        _save("features", feat)
        _save("coords", output.get("coord"))
        pickled = {k: _to_numpy(v) if hasattr(v, "shape") else v for k, v in output.items()}
    else:
        _save("features", output)
        pickled = _to_numpy(output)

    with open(f"{prefix}_full_output.pkl", "wb") as f:
        pickle.dump(pickled, f)
    saved["full_output"] = f"{prefix}_full_output.pkl"

    if input_dict:
        _save("input_lang", input_dict.get("lang_feat"))
        _save("input_geom", input_dict.get("feat"))
        if "coords" not in saved:
            _save("coords", input_dict.get("coord"))

    print(f"Saved {len(saved)} artifacts under {results_dir}/")
    return saved


def load_simple_results(results_dir="results", scene_name=None, timestamp=None):
    """Load the most recent (or the given) saved run back into a dict of its
    arrays, its pickled output and its path prefix."""
    pattern = f"{scene_name or '*'}_{timestamp or '*'}_features.npy"
    matches = sorted(glob.glob(os.path.join(results_dir, pattern)))
    if not matches:
        raise FileNotFoundError(f"no saved runs matching {pattern} under {results_dir}")
    prefix = matches[-1][: -len("_features.npy")]
    results = {}
    for tag in ("features", "coords", "input_lang", "input_geom"):
        path = f"{prefix}_{tag}.npy"
        if os.path.exists(path):
            results[tag] = np.load(path)
    pkl = f"{prefix}_full_output.pkl"
    if os.path.exists(pkl):
        with open(pkl, "rb") as f:
            results["full_output"] = pickle.load(f)
    results["prefix"] = prefix
    return results


def analyze_features(results_dir="results", scene_name=None, timestamp=None):
    """Print a saved run's feature norms, their cosines with the input
    language features (where the run has them) and the coordinates' box."""
    results = load_simple_results(results_dir, scene_name, timestamp)
    feat = results["features"]
    print(f"Run: {os.path.basename(results['prefix'])}")
    norms = np.linalg.norm(feat, axis=-1)
    print(f"features: {feat.shape} {feat.dtype}  "
          f"|f| mean={norms.mean():.4f} std={norms.std():.4f} "
          f"min={norms.min():.4f} max={norms.max():.4f}")
    if "input_lang" in results:
        lang = results["input_lang"].astype(np.float32)
        lnorm = np.linalg.norm(lang, axis=-1, keepdims=True)
        valid = lnorm[:, 0] > 1e-6
        if valid.any():
            f = feat[valid] / np.clip(np.linalg.norm(feat[valid], axis=-1, keepdims=True),
                                      1e-12, None)
            lang = lang[valid] / np.clip(lnorm[valid], 1e-12, None)
            cos = (f * lang).sum(-1)
            print(f"cos(pred, input lang) over {valid.sum():,} valid gaussians: "
                  f"mean={cos.mean():.4f} std={cos.std():.4f} "
                  f"p5={np.percentile(cos, 5):.4f} p95={np.percentile(cos, 95):.4f}")
    if "coords" in results:
        coord = results["coords"]
        print(f"coords: {coord.shape}  bbox min={coord.min(0)} max={coord.max(0)}")
    return results


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="analyze saved inference runs")
    parser.add_argument("--results-dir", default="results")
    parser.add_argument("--scene-name", default=None)
    parser.add_argument("--timestamp", default=None)
    args = parser.parse_args(argv)
    analyze_features(args.results_dir, args.scene_name, args.timestamp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
