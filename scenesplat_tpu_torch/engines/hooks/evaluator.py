"""Per-epoch evaluation hooks (counterpart of
``scenesplat_tpu/engines/hooks/evaluator.py``).

``LangPretrainZeroShotSemSegEvalMulti``: after every ``eval_interval``-th
training epoch it extracts per-Gaussian features of each validation scene,
predicts classes by cosine similarity against text embeddings, votes the
predictions onto the evaluation point cloud, logs mIoU / fg_mIoU per
validation dataset and hands the mean fg_mIoU to the checkpoint saver
(``trainer.comm_info["current_metric_value"]``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from scenesplat_tpu_torch.data import build_dataset
from scenesplat_tpu_torch.data.transforms import seed_transforms
from scenesplat_tpu_torch.engines.eval import (
    ZeroShotMetric,
    evaluate_scene,
    load_class_names,
    load_text_embeddings,
)
from scenesplat_tpu_torch.engines.infer import FeatureExtractor

from .default import HOOKS, HookBase


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)) and x and isinstance(x[0], (list, tuple, str)):
        return list(x)
    return [x]


@HOOKS.register_module()
class LangPretrainZeroShotSemSegEvalMulti(HookBase):
    def __init__(self, class_names: Sequence, text_embeddings: Sequence,
                 excluded_classes: Sequence = (), pred_label_mapping: Optional[Sequence] = None,
                 ignore_index: int = -1, vote_k: int = 25, enable_voting: bool = True,
                 confidence_threshold: float = 0.1, eval_interval: int = 1,
                 max_scenes: Optional[int] = None):
        self.class_names_cfg = _as_list(class_names)
        self.text_embeddings_cfg = _as_list(text_embeddings)
        self.excluded_cfg = list(excluded_classes) if excluded_classes else []
        if self.excluded_cfg and not isinstance(self.excluded_cfg[0], (list, tuple)):
            self.excluded_cfg = [self.excluded_cfg] * len(self.class_names_cfg)
        self.pred_label_mapping = pred_label_mapping
        self.ignore_index = ignore_index
        self.vote_k = vote_k
        self.enable_voting = enable_voting
        self.confidence_threshold = confidence_threshold
        self.eval_interval = eval_interval
        self.max_scenes = max_scenes
        self.datasets = []

    def before_train(self):
        cfg = self.trainer.cfg
        val_cfg = cfg.data.get("val")
        if val_cfg is None:
            return
        val_cfgs = val_cfg if isinstance(val_cfg, (list, tuple)) else [val_cfg]
        self.datasets = [build_dataset(dict(c)) for c in val_cfgs]
        self.class_names = [load_class_names(c) for c in self.class_names_cfg]
        self.text_embs = [load_text_embeddings(p) for p in self.text_embeddings_cfg]
        backbone_cfg = cfg.model.get("backbone", cfg.model)
        self.extractor = FeatureExtractor(
            self.trainer.model, patch_size=max(backbone_cfg.get("enc_patch_size", [1024])),
            device=self.trainer.device)

    def after_epoch(self):
        if not self.datasets or (self.trainer.epoch + 1) % self.eval_interval != 0:
            return
        trainer = self.trainer
        trainer.model.eval()  # the next train step puts it back into training
        fg_mious = []
        for di, dataset in enumerate(self.datasets):
            metric = ZeroShotMetric(self.class_names[di],
                                    self.excluded_cfg[di] if self.excluded_cfg else (),
                                    self.ignore_index)
            n_scenes = len(dataset)
            if self.max_scenes:
                n_scenes = min(n_scenes, self.max_scenes)
            for i in range(n_scenes):
                seed_transforms((self._seed(), di, i))
                sample = dataset[i]

                def get(key):
                    return np.asarray(sample[key]) if key in sample else None

                evaluate_scene(
                    feat=self.extractor(sample), coord=np.asarray(sample["coord"]),
                    segment=np.asarray(sample.get("segment")), text_emb=self.text_embs[di],
                    metric=metric, valid_feat_mask=get("valid_feat_mask"),
                    pc_coord=get("pc_coord"), pc_segment=get("pc_segment"),
                    vote_k=self.vote_k, enable_voting=self.enable_voting,
                    confidence_threshold=self.confidence_threshold,
                    ignore_index=self.ignore_index, device=trainer.device)
            res = metric.results()
            fg_mious.append(res["fg_mIoU"])
            trainer.logger.info(
                f"val[{di}] mIoU {res['mIoU']:.4f} fg_mIoU {res['fg_mIoU']:.4f} "
                f"mAcc {res['mAcc']:.4f} allAcc {res['allAcc']:.4f}")
            trainer.storage.put_scalar(f"val{di}/mIoU", res["mIoU"])
            trainer.storage.put_scalar(f"val{di}/fg_mIoU", res["fg_mIoU"])
        mean_fg = float(np.mean(fg_mious)) if fg_mious else 0.0
        # fg_mIoU drives checkpoint selection
        trainer.comm_info["current_metric_value"] = mean_fg
        trainer.comm_info["current_metric_name"] = "fg_mIoU"
        trainer.storage.put_scalar("val/fg_mIoU", mean_fg)


@HOOKS.register_module()
class LangPretrainZeroShotSemSegEval(LangPretrainZeroShotSemSegEvalMulti):
    """Single-dataset variant."""
