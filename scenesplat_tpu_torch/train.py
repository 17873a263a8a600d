"""Training entry point of the port (counterpart of ``tools/train.py``).

    python -m scenesplat_tpu_torch.train --config-file configs/.../xxx.py \
        [--options save_path=exp/run1 batch_size=2 ...] [--device cpu]

Reads the repo's config files as they are. Two keys there exist only for
the TPU and have no effect here: ``split_geometry`` (geometry programs
compiled apart from the train step, for the TPU compiler's memory) and
``aot_cache`` (the TPU's executable cache); PyTorch runs eagerly.
``--options bitonic_sort=True`` sorts through the hand-written bitonic
kernel (``SCENESPLAT_BITONIC_SORT=1``). Runs on the CUDA card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from scenesplat_tpu_torch.engines.train import build_trainer
from scenesplat_tpu_torch.ops.bitonic_sort import apply_sort_switch
from scenesplat_tpu_torch.utils.config import Config


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("scenesplat_tpu_torch training")
    parser.add_argument("--config-file", required=True)
    parser.add_argument("--options", nargs="*", default=None,
                        help="key=value config overrides")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config_file)
    cfg.merge_from_options(args.options)
    apply_sort_switch(cfg)
    cfg.setdefault("save_path", os.path.join("exp", "default"))
    os.makedirs(cfg.save_path, exist_ok=True)
    cfg.dump(os.path.join(cfg.save_path, "config.py"))
    build_trainer(cfg, device=args.device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
