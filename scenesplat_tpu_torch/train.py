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

Data parallel on N cards of one host:

    torchrun --nproc_per_node N -m scenesplat_tpu_torch.train --config-file ...

``batch_size`` is the global batch (it must split over the N processes);
each process trains on ``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device
cpu``), and rank 0 writes the logs, metrics and checkpoints. A process
group that fails to start raises.
"""

from __future__ import annotations

import argparse
import os
import sys

from scenesplat_tpu_torch.engines.train import build_trainer
from scenesplat_tpu_torch.ops.bitonic_sort import apply_sort_switch
from scenesplat_tpu_torch.parallel.dist import process_group, rank
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
    with process_group(args.device) as device:
        if rank() == 0:
            os.makedirs(cfg.save_path, exist_ok=True)
            cfg.dump(os.path.join(cfg.save_path, "config.py"))
        build_trainer(cfg, device=device).train()
    return 0


if __name__ == "__main__":
    sys.exit(main())
