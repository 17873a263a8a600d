"""Per-Gaussian features as a PCA-coloured point cloud (counterpart of the
repo's ``tools/visualize_features_pca.py``): the port's FeatureExtractor
over the flagship LangPretrainer on the card (or features read from
``--feat-file``), projected to RGB by PCA and written as an ascii ``.ply``
of the scene's coordinates.

    python -m scenesplat_tpu_torch.tools.visualize_features_pca --scene DIR \\
        --output scene_pca.ply [--weight model.pth] [--feat-file feat.npy] \\
        [--device cpu]

The model is the flagship in its own dtype (bf16), its weights drawn from
seed 0 as the JAX tool draws them from PRNGKey(0), or a Pointcept-layout
``.pth`` (``entry.py:load_weights``). Runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from scenesplat_tpu_torch.entry import build_lang_model, load_scene, load_weights, scene_features
from scenesplat_tpu_torch.utils.visualization import features_to_pca_colors, save_point_cloud_ply


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--scene", required=True, help="scene dir of .npy assets")
    parser.add_argument("--weight", default=None, help="Pointcept-layout .pth checkpoint")
    parser.add_argument("--output", required=True)
    parser.add_argument("--grid-size", type=float, default=0.02)
    parser.add_argument("--feat-file", default=None,
                        help="precomputed per-point features .npy (no model)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    coord = np.load(os.path.join(args.scene, "coord.npy")).astype(np.float32)
    if args.feat_file:
        feat = np.load(args.feat_file)
    else:
        _, inputs = load_scene(args.scene)
        model = build_lang_model(device=args.device)
        if args.weight:
            load_weights(model, args.weight)
        feat = scene_features(model, coord, inputs, args.device, args.grid_size)
    save_point_cloud_ply(args.output, coord, features_to_pca_colors(feat))
    print(f"wrote {coord.shape[0]} points -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
