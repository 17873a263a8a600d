"""Extract the teacher or the student backbone of an SSL checkpoint for a
fine-tune (counterpart of ``tools/rename_ckpt_dino_to_ptv3.py``):

    python -m scenesplat_tpu_torch.rename_ckpt --input exp/ssl/model/model_last.pth \
        --output exp/ssl/backbone.pth --source teacher

The output holds ``backbone.*`` under ``state_dict``; pass it as
``--options weight=exp/ssl/backbone.pth`` to the train entry point of a
semseg or VL pretraining file (``utils/ckpt.py``)."""

from __future__ import annotations

import argparse
import sys

from scenesplat_tpu_torch.utils.ckpt import SOURCES, extract_backbone_file


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("scenesplat_tpu_torch SSL backbone extraction")
    parser.add_argument("--input", required=True, help="SSL checkpoint (.pth)")
    parser.add_argument("--output", required=True, help="backbone checkpoint (.pth)")
    parser.add_argument("--source", choices=sorted(SOURCES), default="teacher")
    args = parser.parse_args(argv)
    n = extract_backbone_file(args.input, args.output, args.source)
    print(f"{args.source} backbone ({n} tensors) -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
