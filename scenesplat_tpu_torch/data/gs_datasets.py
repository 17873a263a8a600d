"""3D Gaussian Splatting datasets of the flagship config (the port's copy of
part of ``scenesplat_tpu/data/gs_datasets.py``): each scene holds the 3DGS
attributes (xyz, color, wxyz quaternion, scale, opacity), per-Gaussian
SigLIP2 ``lang_feat`` with its ``valid_feat_mask``, and labels."""

from __future__ import annotations

import numpy as np

from .defaults import DATASETS, DefaultDataset


class _GSDatasetBase(DefaultDataset):
    """Shared 3DGS attribute standardization."""

    SCALE_CLIP = (0.0, 1.5)
    SEGMENT_KEYS = ("segment",)  # priority order; the first found becomes 'segment'
    PC_SEGMENT_KEYS = ("pc_segment",)

    def standardize(self, data_dict):
        n = data_dict["coord"].shape[0]
        for key in ("coord", "pc_coord", "color", "normal", "quat", "sh"):
            if key in data_dict:
                data_dict[key] = data_dict[key].astype(np.float32)
        if "opacity" in data_dict:
            data_dict["opacity"] = data_dict["opacity"].astype(np.float32).reshape(-1, 1)
        if "scale" in data_dict:
            data_dict["scale"] = data_dict["scale"].astype(np.float32).clip(*self.SCALE_CLIP)
        if "lang_feat" in data_dict:
            data_dict["lang_feat"] = data_dict["lang_feat"].astype(np.float16)
        if "valid_feat_mask" in data_dict:
            data_dict["valid_feat_mask"] = data_dict["valid_feat_mask"].astype(bool)
        segment = next((data_dict.pop(k) for k in self.SEGMENT_KEYS if k in data_dict), None)
        data_dict["segment"] = (segment.reshape(-1).astype(np.int32) if segment is not None
                                else np.full(n, -1, dtype=np.int32))
        for key in self.PC_SEGMENT_KEYS:
            if key in data_dict:
                data_dict["pc_segment"] = data_dict.pop(key).reshape(-1).astype(np.int32)
                break
        data_dict["instance"] = (data_dict.pop("instance").reshape(-1).astype(np.int32)
                                 if "instance" in data_dict
                                 else np.full(n, -1, dtype=np.int32))


@DATASETS.register_module()
class ScanNetGSDataset(_GSDatasetBase):
    VALID_ASSETS = ["coord", "color", "normal", "segment20", "instance", "quat", "scale",
                    "opacity", "lang_feat", "valid_feat_mask", "pc_instance"]
    EVAL_PC_ASSETS = ["pc_coord", "pc_segment20"]
    SEGMENT_KEYS = ("segment20", "segment200", "segment")
    PC_SEGMENT_KEYS = ("pc_segment20", "pc_segment200", "pc_segment")


@DATASETS.register_module()
class ScanNet200GSDataset(ScanNetGSDataset):
    VALID_ASSETS = ["coord", "color", "normal", "segment200", "instance", "quat", "scale",
                    "opacity", "lang_feat", "valid_feat_mask", "pc_instance"]
    EVAL_PC_ASSETS = ["pc_coord", "pc_segment200"]
    SEGMENT_KEYS = ("segment200", "segment20", "segment")
    PC_SEGMENT_KEYS = ("pc_segment200", "pc_segment20", "pc_segment")


@DATASETS.register_module()
class ScanNetPPGSDataset(_GSDatasetBase):
    VALID_ASSETS = ["coord", "color", "normal", "segment", "instance", "quat", "scale",
                    "opacity", "lang_feat", "valid_feat_mask"]
    EVAL_PC_ASSETS = ["pc_coord", "pc_segment"]


@DATASETS.register_module()
class Matterport3DGSDataset(_GSDatasetBase):
    VALID_ASSETS = ["coord", "color", "normal", "segment", "instance", "quat", "scale",
                    "opacity", "lang_feat", "valid_feat_mask"]
    EVAL_PC_ASSETS = ["pc_coord", "pc_segment"]


@DATASETS.register_module()
class Matterport3D_160_GSDataset(Matterport3DGSDataset):
    # "segment_nyu_160" is the reference preprocessor's on-disk name;
    # "segment160" is accepted as a shorthand
    VALID_ASSETS = ["coord", "color", "normal", "segment160", "segment_nyu_160", "segment",
                    "instance", "quat", "scale", "opacity", "lang_feat", "valid_feat_mask"]
    EVAL_PC_ASSETS = ["pc_coord", "pc_segment160", "pc_segment_nyu_160", "pc_segment"]
    SEGMENT_KEYS = ("segment160", "segment_nyu_160", "segment")
    PC_SEGMENT_KEYS = ("pc_segment160", "pc_segment_nyu_160", "pc_segment")
