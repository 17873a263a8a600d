"""Datasets: scene folders of .npy assets and their transform pipelines
(the port's copy of ``scenesplat_tpu/data/defaults.py``: ``DefaultDataset``
with its fragmented test items, ``ConcatDataset``). A scene is
``data_root/split/scene`` holding one ``<asset>.npy`` per key."""

from __future__ import annotations

import glob
import os
from collections.abc import Sequence
from copy import deepcopy

import numpy as np

from scenesplat_tpu_torch.utils.logger import get_root_logger
from scenesplat_tpu_torch.utils.registry import Registry

from .transforms import TRANSFORMS, Compose

DATASETS = Registry("datasets")


def build_dataset(cfg, **kwargs):
    return DATASETS.build(cfg, **kwargs)


@DATASETS.register_module()
class DefaultDataset:
    VALID_ASSETS = ["coord", "color", "normal", "strength", "segment", "instance", "pose"]
    EVAL_PC_ASSETS: list = []

    def __init__(self, split="train", data_root="data/dataset", transform=None,
                 test_mode=False, test_cfg=None, cache=False, ignore_index=-1, loop=1,
                 filtered_scene=None, is_train=True):
        self.data_root = data_root
        self.split = split
        self.transform = Compose(transform)
        self.ignore_index = ignore_index
        self.loop = loop if not test_mode else 1
        self.test_mode = test_mode
        self.is_train = is_train
        if test_mode:
            if test_cfg.get("crop"):
                raise NotImplementedError("test_cfg.crop is not ported (the zero-shot "
                                          "test pipelines set crop=None)")
            voxelize = test_cfg.get("voxelize")
            self.test_voxelize = TRANSFORMS.build(dict(voxelize)) if voxelize else None
            self.post_transform = Compose(test_cfg.get("post_transform"))
            self.aug_transform = [Compose(aug)
                                  for aug in test_cfg.get("aug_transform", [[]])]
        self.data_list = self.get_data_list(filtered_scene=filtered_scene)
        get_root_logger().info(f"Totally {len(self.data_list)} x {self.loop} samples in "
                               f"{split} set.")

    def get_data_list(self, filtered_scene=None):
        if isinstance(self.split, str):
            splits = [self.split]
        elif isinstance(self.split, Sequence):
            splits = list(self.split)
        else:
            raise NotImplementedError(f"split {self.split!r}")
        data_list = []
        for split in splits:
            data_list += sorted(glob.glob(os.path.join(self.data_root, split, "*")))
        if filtered_scene is not None:
            data_list = [d for d in data_list
                         if os.path.basename(d).split("_")[0] not in filtered_scene]
        return data_list

    def get_data_name(self, idx):
        return os.path.basename(self.data_list[idx % len(self.data_list)])

    def load_assets(self, data_path):
        data_dict = {}
        for asset in sorted(os.listdir(data_path)):
            if not asset.endswith(".npy"):
                continue
            key = asset[:-4]
            if key not in self.VALID_ASSETS and (self.is_train
                                                 or key not in self.EVAL_PC_ASSETS):
                continue
            data_dict[key] = np.load(os.path.join(data_path, asset))
        return data_dict

    def get_data(self, idx):
        data_dict = self.load_assets(self.data_list[idx % len(self.data_list)])
        data_dict["name"] = self.get_data_name(idx)
        self.standardize(data_dict)
        return data_dict

    def standardize(self, data_dict):
        n = data_dict["coord"].shape[0]
        for key in ("coord", "color", "normal"):
            if key in data_dict:
                data_dict[key] = data_dict[key].astype(np.float32)
        for key in ("segment", "instance"):
            data_dict[key] = (data_dict[key].reshape(-1).astype(np.int32) if key in data_dict
                              else np.full(n, -1, dtype=np.int32))

    def prepare_test_data(self, idx):
        """A fragmented test item: the scene-level arrays (labels, the
        evaluation point cloud, the ``origin_*`` copies and the inverse map
        of the deduplicating GridSample) and ``fragment_list``, for each
        test-time augmentation the complementary voxel fragments, each
        through ``post_transform``."""
        data_dict = self.transform(self.get_data(idx))
        result_dict = dict(segment=data_dict.pop("segment", None),
                           name=data_dict.pop("name", None))
        for key in ("coord", "pc_coord", "pc_segment", "origin_coord", "origin_feat_mask",
                    "origin_instance"):
            if key in data_dict:
                result_dict[key] = (data_dict.pop(key) if key.startswith("origin_")
                                    else data_dict[key])
        if "origin_segment" in data_dict:
            if "inverse" not in data_dict:
                raise KeyError("origin_segment needs the GridSample inverse map")
            result_dict["origin_segment"] = data_dict.pop("origin_segment")
            result_dict["inverse"] = data_dict.pop("inverse")

        fragment_list = []
        for aug in self.aug_transform:
            data = aug(deepcopy(data_dict))
            if self.test_voxelize is not None:
                data_part_list = self.test_voxelize(data)
            else:
                data["index"] = np.arange(data["coord"].shape[0])
                data_part_list = [data]
            fragment_list += data_part_list
        result_dict["fragment_list"] = [self.post_transform(frag) for frag in fragment_list]
        return result_dict

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_data(idx)
        return self.transform(self.get_data(idx))

    def __len__(self):
        return len(self.data_list) * self.loop


@DATASETS.register_module()
class ConcatDataset:
    """Flat index over child datasets."""

    def __init__(self, datasets, loop=1):
        self.datasets = [build_dataset(dict(d)) for d in datasets]
        self.loop = loop
        self.data_list = [(i, j) for i, ds in enumerate(self.datasets) for j in range(len(ds))]
        get_root_logger().info(f"Totally {len(self.data_list)} x {self.loop} samples in "
                               "the concat set.")

    def __getitem__(self, idx):
        dataset_idx, data_idx = self.data_list[idx % len(self.data_list)]
        return self.datasets[dataset_idx][data_idx]

    def __len__(self):
        return len(self.data_list) * self.loop
