"""The pooling cluster counts of chip_smoke.py's one-card flagship
trainer phases (train, ddp_train, wide_train), replayed on the CPU: the
flagship file's seeded loader over write_flagship_data's synthetic rooms,
batch 2, every batch of the first epoch, at each seed given (the file's
own is 0; the rooms' size and Gaussians default to the script's).

    python3 tools/flagship_pooling_replay.py [--seeds 0 1 2 3] [--points N] [--room X Y Z]

The loader is seeded, so its batches are the card's; the model plays no
part. A batch row's clusters at pooling s are its distinct grid cells of
2^s voxels (grid_coord >> s over its valid points), which PT-v3m1's
poolings count, against the capacity the model gives the row there
(0.5^s of its padded points, to the stage's patch). The loader's last
transform, the stem's convolution plan, is left out: it draws nothing and
does not change grid_coord. Prints a JSON line a seed (each batch's rows'
points and clusters at each pooling) and last a JSON object with the
capacities, the largest count at each pooling over every seed and the
margins left; exits 1 if a margin is negative.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from scenesplat_tpu_torch.data import build_dataset  # noqa: E402
from scenesplat_tpu_torch.data.loader import MultiDatasetLoader  # noqa: E402
from scenesplat_tpu_torch.models.ptv3 import _round_capacity  # noqa: E402


def replay(root, exp, seed, workers):
    cfg = cs.flagship_train_config(root, exp, 2)
    cfg.merge_from_options(dict(seed=seed))
    train = dict(cfg.data.train)
    train["datasets"] = [dict(ds, transform=[t for t in ds["transform"]
                                             if t["type"] != "HostConvPlan"])
                         for ds in train["datasets"]]
    dataset = build_dataset(train)
    loader = MultiDatasetLoader(dataset, batch_size=2, num_points=cfg.data.num_points,
                                mix_prob=cfg.get("mix_prob", 0.0), seed=cfg.seed,
                                num_workers=workers)
    loader.set_epoch(0)
    backbone = cfg.model.backbone
    poolings = len(backbone.enc_depths) - 1
    batches, caps = [], None
    for batch in loader:
        n = batch["mask"].shape[1]
        caps = [_round_capacity(n, 0.5 ** s, backbone.enc_patch_size[s])
                for s in range(1, poolings + 1)]
        rows = [[len(np.unique(batch["grid_coord"][b][batch["mask"][b]] >> s, axis=0))
                 for s in range(1, poolings + 1)] for b in range(batch["mask"].shape[0])]
        batches.append(dict(points=batch["mask"].sum(1).tolist(), clusters=rows))
    return batches, caps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    parser.add_argument("--points", type=int, default=cs.FLAGSHIP_SCENE_POINTS,
                        help="Gaussians a room")
    parser.add_argument("--room", type=float, nargs=3, default=cs.FLAGSHIP_ROOM_M,
                        help="room size in metres")
    parser.add_argument("--workers", type=int, default=2)
    args = parser.parse_args(argv)
    worst, caps = None, None
    with tempfile.TemporaryDirectory() as tmp:
        root, _ = cs.write_flagship_data(tmp, scene_points=args.points, room=tuple(args.room))
        for seed in args.seeds:
            batches, caps = replay(root, os.path.join(tmp, "exp"), seed, args.workers)
            top = [max(c) for c in zip(*(row for b in batches for row in b["clusters"]))]
            worst = top if worst is None else [max(a, b) for a, b in zip(worst, top)]
            print(json.dumps(dict(seed=seed, largest=top, batches=batches)), flush=True)
    margin = [c - w for c, w in zip(caps, worst)]
    print(json.dumps(dict(points=args.points, room=args.room, seeds=args.seeds, capacity=caps, largest=worst,
                          margin=margin)))
    return 0 if min(margin) >= 0 else 1


if __name__ == "__main__":
    sys.exit(main())
