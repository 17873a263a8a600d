"""Per-epoch evaluation hooks (counterpart of
``scenesplat_tpu/engines/hooks/evaluator.py``).

``LangPretrainZeroShotSemSegEvalMulti``: after every ``eval_interval``-th
training epoch it extracts per-Gaussian features of each validation scene,
predicts classes by cosine similarity against text embeddings, votes the
predictions onto the evaluation point cloud, logs mIoU / fg_mIoU per
validation dataset and hands the mean fg_mIoU to the checkpoint saver
(``trainer.comm_info["current_metric_value"]``).

``SemSegEvaluator``: after every epoch it runs each whole validation scene
through the segmentor, takes the argmax of the logits and hands the mIoU
over the classes the scenes hold to the checkpoint saver. For a Point
Prompt Training model each scene runs on its own dataset's ``condition``
(set by its pipeline's ``Add``) and is scored in that condition's class
space; each condition's mIoU is logged, and their mean is the metric.

``InsSegEvaluator``: PointGroup proposals scored with the ScanNet AP
protocol; AP50 is the checkpoint metric.

``ClsEvaluator``: a classifier's argmax over each validation object;
per-class IoU and accuracy, ``val/allAcc`` (the checkpoint metric) and
``val/mAcc``.

Under data parallel each process evaluates its round-robin share of the
scenes (``parallel/dist_eval.py``) with the module itself, not its DDP
wrapper (whose forward syncs buffers across processes, which run different
numbers of forwards here), and the confusion sums add up over the
processes, so every process logs the same metrics.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from scenesplat_tpu_torch.data import build_dataset
from scenesplat_tpu_torch.data.transforms import seed_transforms
from scenesplat_tpu_torch.engines.eval import (
    ZeroShotMetric,
    evaluate_scene,
    load_class_names,
    load_text_embeddings,
)
from scenesplat_tpu_torch.engines.infer import FeatureExtractor
from scenesplat_tpu_torch.models.point_group import proposals_from_predictions
from scenesplat_tpu_torch.parallel.dist_eval import (
    allgather_pyobjects,
    allreduce_sum_arrays,
    partition_indices,
)
from scenesplat_tpu_torch.utils.insseg_eval import associate_instances, evaluate_matches
from scenesplat_tpu_torch.utils.misc import intersection_and_union

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
            for i in partition_indices(n_scenes):
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
            metric.intersection, metric.union, metric.target = allreduce_sum_arrays(
                (metric.intersection, metric.union, metric.target))
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


@HOOKS.register_module()
class SemSegEvaluator(HookBase):
    """Supervised segmentation over ``cfg.data.val``: mIoU over the classes
    present in the validation scenes, logged as ``val/mIoU``; with scenes
    of several conditions (PPT), each condition's apart as
    ``val/<condition>/mIoU`` and ``val/mIoU`` their mean."""

    def __init__(self, ignore_index: int = -1, max_scenes: Optional[int] = None):
        self.ignore_index = ignore_index
        self.max_scenes = max_scenes
        self.dataset = None

    def before_train(self):
        cfg = self.trainer.cfg
        val_cfg = cfg.data.get("val")
        if val_cfg is None:
            return
        self.dataset = build_dataset(dict(val_cfg))
        self.num_classes = cfg.data.get("num_classes")
        backbone_cfg = cfg.model.get("backbone", cfg.model)
        self.extractor = FeatureExtractor(
            self.trainer.model, patch_size=max(backbone_cfg.get("enc_patch_size", [1024])),
            device=self.trainer.device)

    def after_epoch(self):
        if self.dataset is None:
            return
        trainer = self.trainer
        trainer.model.eval()  # the next train step puts it back into training
        n_scenes = len(self.dataset)
        if self.max_scenes:
            n_scenes = min(n_scenes, self.max_scenes)
        # the model's conditions in its order (PPT), or one unnamed
        conditions = list(getattr(trainer.model, "conditions", None) or [None])
        counts = {c: [] for c in conditions}  # per scene: (intersection, union, target)
        for i in partition_indices(n_scenes):
            seed_transforms((self._seed(), i))
            sample = self.dataset[i]
            logits = self.extractor(sample)
            counts[sample.get("condition")].append(intersection_and_union(
                logits.argmax(-1).astype(np.int32), np.asarray(sample["segment"]),
                logits.shape[-1], self.ignore_index))
        mious = {}
        for cond in conditions:
            # a process that drew no scene of the condition adds zeros
            inter, union, target = allreduce_sum_arrays(
                tuple(sum(c) for c in zip(*counts[cond])) if counts[cond]
                else (np.zeros(self.num_classes or 1),) * 3)
            iou = inter / np.maximum(union, 1e-10)
            seen = target > 0
            if cond is None or seen.any():
                mious[cond] = float(iou[seen].mean()) if seen.any() else 0.0
        for cond, value in mious.items():
            if cond is not None:
                trainer.logger.info(f"val {cond} mIoU {value:.4f}")
                trainer.storage.put_scalar(f"val/{cond}/mIoU", value)
        miou = float(np.mean(list(mious.values()))) if mious else 0.0
        trainer.logger.info(f"val mIoU {miou:.4f}")
        trainer.comm_info["current_metric_value"] = miou
        trainer.comm_info["current_metric_name"] = "mIoU"
        trainer.storage.put_scalar("val/mIoU", miou)


@HOOKS.register_module()
class InsSegEvaluator(HookBase):
    """Instance segmentation with the ScanNet AP protocol (reference
    evaluator.py:249-625): after every epoch each whole validation scene
    runs through the model (logits and centre bias), the model config's
    ``cluster_*`` settings make PointGroup proposals on the card
    (``models/point_group.py:proposals_from_predictions``), and the
    proposals meet the scene's instances (``utils/insseg_eval.py``). Under
    data parallel each process takes its share of the scenes and every
    process's records are gathered before the matching, since AP ranks the
    proposals' scores over all scenes. Logs ``val/mAP``, ``val/AP50`` and
    ``val/AP25``; AP50 is the checkpoint metric. ``scene_log`` keeps each of
    this process's scenes' points, proposals and clustering seconds."""

    def __init__(self, segment_ignore_index=(-1,), instance_ignore_index: int = -1,
                 max_scenes: Optional[int] = None):
        self.segment_ignore_index = tuple(segment_ignore_index)
        self.instance_ignore_index = instance_ignore_index
        self.max_scenes = max_scenes
        self.dataset = None
        self.scene_log = []

    def before_train(self):
        cfg = self.trainer.cfg
        val_cfg = cfg.data.get("val")
        if val_cfg is None:
            return
        self.dataset = build_dataset(dict(val_cfg))
        self.num_classes = cfg.data.get("num_classes")
        self.names = cfg.data.get("names", [str(i) for i in range(self.num_classes or 0)])
        self.model_cfg = dict(cfg.model)
        self.extractor = FeatureExtractor(
            self.trainer.model, patch_size=1024, device=self.trainer.device,
            output_fn=lambda out: torch.cat([out[0].feat.float(), out[1].float()], -1))

    def after_epoch(self):
        if self.dataset is None:
            return
        trainer = self.trainer
        trainer.model.eval()  # the next train step puts it back into training
        mc = self.model_cfg
        n_scenes = len(self.dataset)
        if self.max_scenes:
            n_scenes = min(n_scenes, self.max_scenes)
        scenes, self.scene_log = [], []
        for i in partition_indices(n_scenes):
            seed_transforms((self._seed(), i))
            sample = self.dataset[i]
            out = self.extractor(sample)
            t0 = time.perf_counter()
            pred = proposals_from_predictions(
                np.asarray(sample["coord"], np.float32), out[:, :-3], out[:, -3:],
                segment_ignore_index=mc.get("segment_ignore_index", self.segment_ignore_index),
                cluster_thresh=mc.get("cluster_thresh", 1.5),
                cluster_propose_points=mc.get("cluster_propose_points", 100),
                cluster_min_points=mc.get("cluster_min_points", 50),
                voxel_size=mc.get("voxel_size", 0.02), device=trainer.device)
            self.scene_log.append(dict(points=len(out), proposals=len(pred["pred_classes"]),
                                       cluster_s=time.perf_counter() - t0))
            scenes.append(associate_instances(
                pred["pred_masks"], pred["pred_classes"], pred["pred_scores"],
                np.asarray(sample["segment"]).reshape(-1),
                np.asarray(sample["instance"]).reshape(-1), self.num_classes,
                segment_ignore_index=self.segment_ignore_index,
                instance_ignore_index=self.instance_ignore_index))
        scores = evaluate_matches(allgather_pyobjects(scenes), self.num_classes, self.names,
                                  segment_ignore_index=self.segment_ignore_index)
        m_ap, ap50, ap25 = scores["all_ap"], scores["all_ap_50%"], scores["all_ap_25%"]
        trainer.logger.info(f"val mAP/AP50/AP25 {m_ap:.4f}/{ap50:.4f}/{ap25:.4f}")
        trainer.comm_info["current_metric_value"] = ap50
        trainer.comm_info["current_metric_name"] = "AP50"
        trainer.storage.put_scalar("val/mAP", m_ap)
        trainer.storage.put_scalar("val/AP50", ap50)
        trainer.storage.put_scalar("val/AP25", ap25)


@HOOKS.register_module()
class ClsEvaluator(HookBase):
    """Object classification over ``cfg.data.val``: after every epoch each
    validation object (its transforms seeded by (seed, index)) runs whole
    through the classifier on the model's device, and the argmax of its
    logits meets its ``category``. Per class, IoU (a wrong prediction adds
    to the predicted class's union) and accuracy add up over every
    process's objects; logs mIoU / mAcc / allAcc, ``val/allAcc`` and
    ``val/mAcc``. allAcc is the checkpoint metric."""

    def __init__(self, max_scenes: Optional[int] = None, batch_points: int = 0):
        # batch_points is taken and unused only so that configs written for
        # the JAX hook, which pads every object to that many points for its
        # compiles, still build; the port's attention takes a ragged last
        # window and runs each object at its bucket
        self.max_scenes = max_scenes
        self.dataset = None

    def before_train(self):
        cfg = self.trainer.cfg
        val_cfg = cfg.data.get("val")
        if val_cfg is None:
            return
        self.dataset = build_dataset(dict(val_cfg))
        self.num_classes = cfg.data.get("num_classes")
        backbone_cfg = cfg.model.get("backbone", cfg.model)
        self.extractor = FeatureExtractor(
            self.trainer.model, patch_size=max(backbone_cfg.get("enc_patch_size", [1024])),
            device=self.trainer.device)

    def after_epoch(self):
        if self.dataset is None:
            return
        trainer = self.trainer
        trainer.model.eval()  # the next train step puts it back into training
        n_scenes = len(self.dataset)
        if self.max_scenes:
            n_scenes = min(n_scenes, self.max_scenes)
        inter, union, target = (np.zeros(self.num_classes) for _ in range(3))
        for i in partition_indices(n_scenes):
            seed_transforms((self._seed(), i))
            sample = self.dataset[i]
            pred = int(self.extractor(sample).argmax(-1))
            label = int(np.asarray(sample["category"]).reshape(-1)[0])
            if 0 <= label < self.num_classes:
                target[label] += 1
                union[label] += 1
                if pred == label:
                    inter[label] += 1
                elif 0 <= pred < self.num_classes:
                    union[pred] += 1
        inter, union, target = allreduce_sum_arrays((inter, union, target))
        iou = inter / np.maximum(union, 1e-10)
        acc = inter / np.maximum(target, 1e-10)
        seen = target > 0
        m_iou = float(iou[seen].mean()) if seen.any() else 0.0
        m_acc = float(acc[seen].mean()) if seen.any() else 0.0
        all_acc = float(inter.sum() / max(target.sum(), 1e-10))
        trainer.logger.info(f"Val result: mIoU/mAcc/allAcc {m_iou:.4f}/{m_acc:.4f}/{all_acc:.4f}")
        trainer.comm_info["current_metric_value"] = all_acc
        trainer.comm_info["current_metric_name"] = "allAcc"
        trainer.storage.put_scalar("val/allAcc", all_acc)
        trainer.storage.put_scalar("val/mAcc", m_acc)
