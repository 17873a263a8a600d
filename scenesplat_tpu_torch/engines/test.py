"""Testers: full-benchmark inference over fragmented test datasets
(counterpart of ``scenesplat_tpu/engines/test.py``).

``ZeroShotSemSegTester``: per scene, accumulate sigmoid class probabilities
over complementary voxel fragments into a full-scene buffer, threshold,
inverse-map to the original points, kNN-vote onto the evaluation point
cloud, and report mIoU / fg_mIoU. One process evaluates every scene; the
other testers of the JAX package are not ported yet.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from scenesplat_tpu_torch.data import build_dataset
from scenesplat_tpu_torch.data.transforms import seed_transforms
from scenesplat_tpu_torch.engines.eval import (
    ZeroShotMetric,
    load_class_names,
    load_text_embeddings,
)
from scenesplat_tpu_torch.engines.infer import FeatureExtractor
from scenesplat_tpu_torch.utils.logger import get_root_logger
from scenesplat_tpu_torch.utils.misc import clustering_voting, neighbor_voting
from scenesplat_tpu_torch.utils.registry import Registry

TESTERS = Registry("testers")


def partition_indices(n: int) -> range:
    """The scenes this process evaluates: all of them (the port runs one
    process; the JAX package shards scenes round-robin over hosts)."""
    return range(n)


class TesterBase:
    def __init__(self, model, dataset_cfg, patch_size=1024, verbose=False, seed=0,
                 weights_fingerprint=None, device="cuda"):
        self.model = model
        self.device = torch.device(device)
        self.dataset = build_dataset(dict(dataset_cfg))
        self.extractor = FeatureExtractor(model, patch_size=patch_size, device=device)
        self.logger = get_root_logger()
        self.verbose = verbose
        self.seed = int(seed)  # transform-RNG seed for scene fetches
        # identifies the weights that produced any cached *_pred.npy at
        # save_path; a mismatch invalidates the resume cache
        self.weights_fingerprint = weights_fingerprint

    def _pred_cache_usable(self, save_path) -> bool:
        """True if cached predictions at ``save_path`` may be reused.

        Cached *_pred.npy files carry no provenance of their own, so a
        sidecar records the weights fingerprint; rerunning with different
        weights at the same save_path invalidates (and re-stamps) the cache
        instead of silently reporting stale predictions."""
        if not save_path:
            return False
        os.makedirs(save_path, exist_ok=True)
        sidecar = os.path.join(save_path, "pred_cache_weights.txt")
        fp = getattr(self, "weights_fingerprint", None)
        if not fp:
            self.logger.warning("no weights fingerprint available: cached *_pred.npy at "
                                f"{save_path} (if any) will be reused unverified")
            return True
        prior = None
        if os.path.isfile(sidecar):
            with open(sidecar) as f:
                prior = f.read().strip()
        if prior is not None and prior != fp:
            # delete the stale cache before re-stamping the sidecar: were the
            # sidecar updated with the old files still on disk, a crash
            # mid-eval would leave them behind a now-matching fingerprint
            stale = glob.glob(os.path.join(save_path, "*_pred.npy"))
            for p in stale:
                os.remove(p)
            self.logger.warning(f"{save_path} held {len(stale)} predictions from different "
                                f"weights ({prior} != {fp}); deleted")
            with open(sidecar, "w") as f:
                f.write(fp + "\n")
            return False
        with open(sidecar, "w") as f:
            f.write(fp + "\n")
        return True


@TESTERS.register_module()
class ZeroShotSemSegTester(TesterBase):
    def __init__(self, class_names, text_embeddings, excluded_classes=(),
                 enable_voting: bool = True, vote_k: int = 25,
                 confidence_threshold: float = 0.1, ignore_index: int = -1,
                 pred_label_mapping: Optional[dict] = None, top3: Optional[bool] = None,
                 save_feat: bool = False, skip_eval: bool = False,
                 save_path: Optional[str] = None, save_submission: bool = False,
                 max_scenes: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        if save_submission:
            raise NotImplementedError("the submission writers are not ported")
        self.class_names = load_class_names(class_names)
        self.text_emb = load_text_embeddings(text_embeddings)
        if self.text_emb.shape[0] != len(self.class_names):
            raise ValueError(f"{self.text_emb.shape[0]} text embeddings for "
                             f"{len(self.class_names)} class names")
        self.excluded_classes = excluded_classes
        self.enable_voting = enable_voting
        self.vote_k = vote_k
        self.confidence_threshold = confidence_threshold
        self.ignore_index = ignore_index
        self.pred_label_mapping = pred_label_mapping
        if top3 is None:
            # the reference keys the protocol on the dataset type
            top3 = "ScanNetPP" in type(self.dataset).__name__
        self.top3 = bool(top3)
        self.save_feat = save_feat
        self.skip_eval = skip_eval
        self.save_path = save_path
        self.max_scenes = max_scenes
        # per scene: name, points, fragments and the seconds spent fetching,
        # extracting features, scoring them and voting; written to
        # <save_path>/scene_log.json
        self.scene_log = []

    def _update(self, metric, record, name, pred_eval, target):
        """Adds one scene to ``metric``; returns its own (intersection,
        union, target) and keeps them in ``record``."""
        before = (metric.intersection.copy(), metric.union.copy(), metric.target.copy())
        metric.update(pred_eval, target)
        scene = (metric.intersection - before[0], metric.union - before[1],
                 metric.target - before[2])
        record[name] = dict(zip(("intersection", "union", "target"), scene))
        return scene

    def test(self):
        metric = ZeroShotMetric(self.class_names, self.excluded_classes, self.ignore_index)
        record = {}  # per-scene (intersection, union, target)
        n_scenes = len(self.dataset)
        if self.max_scenes:
            n_scenes = min(n_scenes, self.max_scenes)
        cache_usable = self._pred_cache_usable(self.save_path)
        cache_hits = 0
        self.model.eval()
        for i in partition_indices(n_scenes):
            t_start = time.perf_counter()
            seed_transforms((self.seed, i))
            scene = self.dataset[i]
            t_fetch = time.perf_counter()
            name = scene.get("name", f"scene{i}")
            segment = np.asarray(scene["segment"]).reshape(-1)
            n = segment.shape[0]
            # resume support: a saved post-voting prediction skips inference
            # (feature saving and pc_coord-based eval need the features, so
            # those recompute)
            pred_save_path = (os.path.join(self.save_path, f"{name}_pred.npy")
                              if self.save_path else None)
            if (pred_save_path and cache_usable and os.path.isfile(pred_save_path)
                    and not self.save_feat and "pc_coord" not in scene):
                self.logger.info(f"{name}: loaded existing pred")
                cache_hits += 1
                pred_eval = np.load(pred_save_path)
                if pred_eval.ndim > 1:
                    pred_eval = pred_eval[:, 0]  # saved top-3
                target = (np.asarray(scene["origin_segment"]).reshape(-1)
                          if "origin_segment" in scene else segment)
                if not self.skip_eval and target is not None:
                    self._update(metric, record, name, pred_eval, target)
                continue
            prob = np.zeros((n, len(self.class_names)), np.float32)
            feat_sum = (np.zeros((n, self.text_emb.shape[1]), np.float32)
                        if self.save_feat else None)
            hits = np.zeros(n, np.int32)
            extract_s = score_s = 0.0
            for frag in scene["fragment_list"]:
                t0 = time.perf_counter()
                feat = self.extractor(frag)  # ends with the copy to the host
                t1 = time.perf_counter()
                logits = feat @ self.text_emb.T
                p = 1.0 / (1.0 + np.exp(-logits))
                idx = np.asarray(frag["index"]).reshape(-1)
                prob[idx] += p
                hits[idx] += 1
                if feat_sum is not None:
                    feat_sum[idx] += feat
                extract_s += t1 - t0
                score_s += time.perf_counter() - t1
            if self.save_feat and self.save_path:
                os.makedirs(self.save_path, exist_ok=True)
                np.save(os.path.join(self.save_path, f"{name}_feat.npy"),
                        feat_sum / np.maximum(hits[:, None], 1))
            t_vote = time.perf_counter()
            if self.top3:
                # ScanNet++ protocol: [N, 3] top-class indices, best first,
                # no confidence threshold
                k3 = min(3, prob.shape[1])
                pred = np.argsort(-prob, axis=1, kind="stable")[:, :k3].astype(np.int32)
            else:
                pred = prob.argmax(axis=1).astype(np.int32)
                conf = prob.max(axis=1) / np.maximum(hits, 1)
                pred[conf < self.confidence_threshold] = self.ignore_index

            # inverse-map to original resolution when available
            valid = np.ones(n, bool)
            coord = np.asarray(scene["coord"])
            if "origin_segment" in scene and "inverse" in scene:
                pred = pred[np.asarray(scene["inverse"]).reshape(-1)]
                segment = np.asarray(scene["origin_segment"]).reshape(-1)
                coord = np.asarray(scene["origin_coord"])
                valid = (np.asarray(scene["origin_feat_mask"]).astype(bool)
                         if "origin_feat_mask" in scene else np.ones(len(pred), bool))

            if self.pred_label_mapping:
                for src_label, dst in self.pred_label_mapping.items():
                    pred[pred == int(src_label)] = int(dst)

            if self.top3 and pred.ndim > 1:
                pred = np.ascontiguousarray(pred[:, 0])  # top-1 for voting and metrics

            if self.enable_voting and "pc_coord" in scene:
                pred_eval = neighbor_voting(
                    coord, pred, self.vote_k, valid & (pred != self.ignore_index),
                    len(self.class_names), query_coord=np.asarray(scene["pc_coord"]),
                    ignore_index=self.ignore_index, device=self.device)
                target = np.asarray(scene["pc_segment"]).reshape(-1)
            else:
                pred_eval, target = pred, segment
            if "origin_instance" in scene:
                pred_eval = clustering_voting(pred_eval, np.asarray(scene["origin_instance"]),
                                              self.ignore_index)
            if pred_save_path:
                os.makedirs(self.save_path, exist_ok=True)
                np.save(pred_save_path, pred_eval)
            t_end = time.perf_counter()
            self.scene_log.append(dict(
                name=name, points=int(len(pred)), fragments=len(scene["fragment_list"]),
                fragment_points=[int(np.asarray(f["index"]).size)
                                 for f in scene["fragment_list"]],
                fetch_s=t_fetch - t_start, extract_s=extract_s, score_s=score_s,
                vote_s=t_end - t_vote, total_s=t_end - t_start))
            if not self.skip_eval and target is not None:
                i_, u_, t_ = self._update(metric, record, name, pred_eval, target)
                # running per-scene log
                scene_iou = (i_ / (u_ + 1e-10))[u_ != 0]
                run_iou = (metric.intersection / (metric.union + 1e-10))[metric.union != 0]
                self.logger.info(
                    f"Test: {name} [{i + 1}/{n_scenes}]-{len(target)} "
                    f"Accuracy {i_.sum() / (t_.sum() + 1e-10):.4f} "
                    f"mIoU {scene_iou.mean() if scene_iou.size else 0.0:.4f} "
                    f"({run_iou.mean() if run_iou.size else 0.0:.4f})")
        if cache_hits:
            self.logger.warning(f"{cache_hits} scene(s) reported from cached predictions at "
                                f"{self.save_path} (delete *_pred.npy to force recompute)")
        if self.save_path and self.scene_log:
            with open(os.path.join(self.save_path, "scene_log.json"), "w") as f:
                json.dump(self.scene_log, f)
        results = metric.results(protocol="tester") if not self.skip_eval else {}
        if results:
            self._log_final_metrics(results)
        return results

    def _log_final_metrics(self, results):
        """The final metric report, also written to ``eval_results.txt``."""
        excluded = [i for i, nm in enumerate(self.class_names)
                    if nm in set(self.excluded_classes)]
        lines = ["Val result: mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}".format(
            results["mIoU"], results["mAcc"], results["allAcc"])]
        if excluded:
            lines.append("Foreground Val result (excluding {} classes): "
                         "mIoU/mAcc/allAcc {:.4f}/{:.4f}/{:.4f}".format(
                             len(excluded), results["fg_mIoU"], results["fg_mAcc"],
                             results["fg_allAcc"]))
        iou, acc = results["iou_per_class"], results["acc_per_class"]
        per_class = ["Class_{}-{} Result: iou/accuracy {:.4f}/{:.4f}".format(
            ci, cname, iou[ci], acc[ci]) for ci, cname in enumerate(self.class_names)]
        for line in lines + per_class:
            self.logger.info(line)
        if not self.save_path:
            return
        os.makedirs(self.save_path, exist_ok=True)
        with open(os.path.join(self.save_path, "eval_results.txt"), "w") as f:
            f.write("\n".join(lines) + "\n\nPer-class results:\n" + "\n".join(per_class) + "\n")
            if excluded:
                f.write("\nExcluded classes:\n")
                for idx in excluded:
                    f.write(f"Class_{idx}-{self.class_names[idx]}\n")


def build_tester(cfg, model, dataset_cfg, patch_size=1024, seed=0,
                 weights_fingerprint=None, device="cuda"):
    return TESTERS.build(dict(cfg), model=model, dataset_cfg=dataset_cfg,
                         patch_size=patch_size, seed=seed,
                         weights_fingerprint=weights_fingerprint, device=device)
