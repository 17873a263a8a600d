"""Testing entry point of the port (counterpart of ``tools/test.py``): runs
the configured testers with a trained checkpoint.

    python -m scenesplat_tpu_torch.test --config-file configs/.../xxx.py \
        [--options weight=exp/run1/model/model_best.pth ...] [--device cpu]

``cfg.weight`` is a checkpoint of the port's ``CheckpointSaver`` or a
reference Pointcept ``.pth``; without it the model keeps the weights drawn
from ``cfg.seed``. The testers read the model's output: the L2-normalized
features of a ``LangPretrainer`` (``ZeroShotSemSegTester``), the logits of a
``DefaultSegmentorV2`` (``SemSegTester``). Every ``(test, data.test)`` pair of the config runs in
turn; the final metrics go to the log and, with a tester ``save_path``, to
``eval_results.txt``. ``--options bitonic_sort=True`` sorts through the
hand-written bitonic kernel (``SCENESPLAT_BITONIC_SORT=1``). Runs on the
CUDA card unless ``--device cpu`` is given.

Under ``torchrun --nproc_per_node N -m scenesplat_tpu_torch.test ...`` each
process tests its share of the scenes on ``cuda:LOCAL_RANK`` (gloo with
``--device cpu``) and every process returns the metrics of all scenes.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from scenesplat_tpu_torch.engines.test import build_tester
from scenesplat_tpu_torch.entry import load_weights
from scenesplat_tpu_torch.models import build_model
from scenesplat_tpu_torch.ops.bitonic_sort import apply_sort_switch
from scenesplat_tpu_torch.parallel.dist import process_group, rank
from scenesplat_tpu_torch.utils.config import Config


def weights_fingerprint(weight) -> str:
    """Identifies a checkpoint file for the testers' prediction cache."""
    try:
        return f"{os.path.abspath(weight)}:{int(os.stat(weight).st_mtime)}"
    except OSError:
        return os.path.abspath(str(weight))


def main(argv=None) -> list:
    """Returns each tester's metrics."""
    parser = argparse.ArgumentParser("scenesplat_tpu_torch testing")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--options", nargs="*", default=None,
                        help="key=value config overrides")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_options(args.options)
    apply_sort_switch(cfg)
    with process_group(args.device) as device:
        model_cfg = dict(cfg.model)
        model_cfg.pop("criteria", None)
        model_cfg["backbone"] = dict(model_cfg["backbone"])
        model_cfg["backbone"].setdefault("seed", cfg.get("seed", 0))
        model = build_model(model_cfg).to(device).eval()
        weight = cfg.get("weight")
        if weight:
            load_weights(model, weight)
            if rank() == 0:
                print(f"loaded weight: {weight}", flush=True)

        test_cfgs, data_cfgs = cfg.get("test"), cfg.data.get("test")
        if not test_cfgs or data_cfgs is None:
            raise KeyError("the config names no tester: it needs test= and data.test=")
        test_cfgs = test_cfgs if isinstance(test_cfgs, (list, tuple)) else [test_cfgs]
        data_cfgs = data_cfgs if isinstance(data_cfgs, (list, tuple)) else [data_cfgs]
        patch = max(model_cfg["backbone"].get("enc_patch_size", [1024]))
        results = []
        for tc, dc in zip(test_cfgs, data_cfgs):
            tester = build_tester(tc, model, dc, patch_size=patch, seed=cfg.get("seed", 0),
                                  weights_fingerprint=weights_fingerprint(weight) if weight
                                  else None, device=device)
            res = tester.test()
            results.append(res)
            if res and rank() == 0:  # the scalar metrics (the per-class arrays are in the log)
                print("test results: " + " ".join(
                    f"{k} {v:.4f}" for k, v in res.items() if np.ndim(v) == 0), flush=True)
        return results


if __name__ == "__main__":
    main()
    sys.exit(0)
