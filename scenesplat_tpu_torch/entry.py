"""Single-scene open-vocabulary zero-shot inference (counterpart of the
repo's ``test_single_scene_lang.py`` and of ``FLAGSHIP_BACKBONE`` in
``__graft_entry__.py``).

Loads one scene's ``.npy`` assets (or takes arrays), builds the flagship
LangPretrainer with weights drawn from a seed (or loads a Pointcept-layout
``.pth``), extracts L2-normalized per-Gaussian features through the
bucketed FeatureExtractor and predicts classes against SigLIP2 text
embeddings; with ``--save-features`` it writes the features, coordinates
and inputs as that script does (``utils/save_features.py``).

    python -m scenesplat_tpu_torch.entry --scene DIR [--device cpu]
        [--dtype bfloat16|float16|float32] [--save-features --results-dir DIR]

Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from scenesplat_tpu_torch.engines.eval import load_text_embeddings, zero_shot_predict
from scenesplat_tpu_torch.engines.infer import FeatureExtractor
from scenesplat_tpu_torch.models import build_model
from scenesplat_tpu_torch.utils.save_features import save_inference_output_simple

# the flagship PT-v3m1 LangPretrainer backbone (scenesplat_tpu's
# __graft_entry__.FLAGSHIP_BACKBONE, without its TPU-only dense_extent)
FLAGSHIP_BACKBONE = dict(
    type="PT-v3m1",
    in_channels=11,  # color 3 + opacity 1 + quat 4 + scale 3
    order=("z", "z-trans", "hilbert", "hilbert-trans"),
    stride=(2, 2, 2),
    enc_depths=(2, 2, 2, 6),
    enc_channels=(32, 64, 128, 256),
    enc_num_head=(2, 4, 8, 16),
    enc_patch_size=(1024, 1024, 1024, 1024),
    dec_depths=(2, 2, 2),
    dec_channels=(768, 512, 256),
    dec_num_head=(16, 16, 16),
    dec_patch_size=(1024, 1024, 1024),
    mlp_ratio=4,
    drop_path=0.3,
    shuffle_orders=True,
    upcast_softmax=False,
    serialization_depth=10,
)

# the backbone of configs/test_lang_inference.py: it leaves dec_patch_size
# at PTv3's default of 48 windows
SHIPPED_INFERENCE_BACKBONE = dict(
    type="PT-v3m1",
    in_channels=11,
    order=("z", "z-trans", "hilbert", "hilbert-trans"),
    stride=(2, 2, 2),
    enc_depths=(2, 2, 2, 6),
    enc_channels=(32, 64, 128, 256),
    enc_num_head=(2, 4, 8, 16),
    enc_patch_size=(1024, 1024, 1024, 1024),
    dec_depths=(2, 2, 2),
    dec_channels=(768, 512, 256),
    dec_num_head=(16, 16, 16),
    mlp_ratio=4,
    qkv_bias=True,
    drop_path=0.3,
    shuffle_orders=True,
    pre_norm=True,
    upcast_softmax=False,
    serialization_depth=10,
    stage_capacity=(0.5, 0.25, 0.125),
    dtype="bfloat16",
)


def load_scene(scene_dir: str):
    """Scene directory of .npy assets -> (coord [N, 3], feat [N, 11])."""
    def load(k):
        return np.load(os.path.join(scene_dir, f"{k}.npy"))

    coord = load("coord").astype(np.float32)
    color = load("color").astype(np.float32) / 127.5 - 1
    opacity = load("opacity").astype(np.float32).reshape(-1, 1)
    quat = load("quat").astype(np.float32)
    scale = load("scale").astype(np.float32).clip(0, 1.5)
    return coord, np.concatenate([color, opacity, quat, scale], axis=1)


def grid_coords(coord: np.ndarray, grid_size: float = 0.02) -> np.ndarray:
    return np.floor((coord - coord.min(axis=0)) / grid_size).astype(np.int64)


def build_lang_model(backbone: dict = FLAGSHIP_BACKBONE, dtype="bfloat16",
                     device="cuda", seed: int = 0) -> torch.nn.Module:
    """LangPretrainer over ``backbone`` in eval mode on ``device``, with
    weights drawn from ``seed``."""
    cfg = dict(backbone, dtype=dtype, seed=seed)
    return build_model(dict(type="LangPretrainer", backbone=cfg)).to(device).eval()


def load_weights(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """A Pointcept-layout checkpoint (a state dict, or a dict holding one
    under ``state_dict``; a DDP ``module.`` prefix is dropped) loaded with
    strict=True."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    state = state.get("state_dict", state)
    model.load_state_dict({k.removeprefix("module."): v for k, v in state.items()},
                          strict=True)
    return model


def scene_features(model: torch.nn.Module, coord: np.ndarray, feat: np.ndarray,
                   device="cuda", grid_size: float = 0.02) -> np.ndarray:
    """One scene's arrays (coord [N, 3], feat [N, 11]) -> L2-normalized
    features [N, C] (fp32 numpy), the coordinates shifted to their least
    corner first."""
    coord = coord - coord.min(axis=0)
    extractor = FeatureExtractor(model, patch_size=1024, device=device)
    out = extractor(dict(coord=coord, feat=feat,
                         grid_coord=grid_coords(coord, grid_size)))
    if not np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-2):
        raise RuntimeError("features are not L2-normalized")
    return out


def zero_shot_scene(model: torch.nn.Module, coord: np.ndarray, feat: np.ndarray,
                    text_emb: np.ndarray, device="cuda", grid_size: float = 0.02):
    """One scene's arrays (coord [N, 3], feat [N, 11]) -> L2-normalized
    features [N, C] and zero-shot predictions [N] against ``text_emb``."""
    out = scene_features(model, coord, feat, device, grid_size)
    pred, _ = zero_shot_predict(out, text_emb)
    return out, pred


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", required=True, help="scene dir of .npy assets")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float16", "float32"))
    parser.add_argument("--seed", type=int, default=0, help="seed of the weights")
    parser.add_argument("--weight", default=None,
                        help="Pointcept-layout .pth checkpoint (default: seeded weights)")
    parser.add_argument("--text-embeddings", default="builtin:scannet200")
    parser.add_argument("--subsample", type=int, default=100000)
    parser.add_argument("--grid-size", type=float, default=0.02)
    parser.add_argument("--save-features", action="store_true",
                        help="write the features, coordinates and inputs (utils/save_features.py)")
    parser.add_argument("--results-dir", default="results")
    args = parser.parse_args(argv)

    coord, feat = load_scene(args.scene)
    n = coord.shape[0]
    print(f"scene: {n} gaussians, feat dim {feat.shape[1]}", flush=True)
    if args.subsample and n > args.subsample:
        keep = np.random.default_rng(42).choice(n, args.subsample, replace=False)
        coord, feat = coord[keep], feat[keep]
    coord = coord - coord.min(axis=0)
    model = build_lang_model(dtype=args.dtype, device=args.device, seed=args.seed)
    if args.weight:
        load_weights(model, args.weight)
    t0 = time.perf_counter()
    out, pred = zero_shot_scene(model, coord, feat,
                                load_text_embeddings(args.text_embeddings),
                                device=args.device, grid_size=args.grid_size)
    print(f"features {out.shape} in {time.perf_counter() - t0:.2f} s", flush=True)
    uniq, counts = np.unique(pred, return_counts=True)
    print(f"classes predicted: {dict(zip(uniq.tolist(), counts.tolist()))}")
    if args.save_features:
        save_inference_output_simple(dict(point_feat=out, coord=coord),
                                     dict(feat=feat, coord=coord),
                                     os.path.basename(os.path.normpath(args.scene)),
                                     results_dir=args.results_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
