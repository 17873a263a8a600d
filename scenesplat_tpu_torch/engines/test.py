"""Testers: full-benchmark inference over fragmented test datasets
(counterpart of ``scenesplat_tpu/engines/test.py``).

``ZeroShotSemSegTester``: per scene, accumulate sigmoid class probabilities
over complementary voxel fragments into a full-scene buffer, threshold,
inverse-map to the original points, kNN-vote onto the evaluation point
cloud, and report mIoU / fg_mIoU. ``SemSegTester`` does the same with a
segmentor's logits (summed over the fragments of every test-time
augmentation, no threshold, no kNN vote) and reports mIoU. Under data
parallel (``torchrun``) each process tests its round-robin share of the
scenes (``parallel/dist_eval.py``), writes its scenes' predictions, and the
per-scene records or the confusion sums are merged over the processes as
in the JAX package, so every process reports the one-process metrics; rank
0 writes ``eval_results.txt`` and ``scene_log.json`` (every process's
scenes). With ``save_submission`` both write each scene's benchmark file
(``_write_submission``) under ``<save_path>/submit``.

``ClsTester``, ``ClsVotingTester`` (softmax probabilities summed over
repeats of the test augmentations, the best repeat's record) and
``PartSegTester`` (instance and category mIoU over each shape category's
parts) score a classifier's or a part segmenter's objects as the JAX
package's testers do.
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
from scenesplat_tpu_torch.models.ppt import PAD_LOGIT
from scenesplat_tpu_torch.parallel.dist import rank
from scenesplat_tpu_torch.parallel.dist_eval import (
    allgather_pyobjects,
    allreduce_sum_arrays,
    broadcast_pyobject,
    partition_indices,
)
from scenesplat_tpu_torch.utils.logger import get_root_logger
from scenesplat_tpu_torch.utils.misc import (
    clustering_voting,
    intersection_and_union,
    neighbor_voting,
)
from scenesplat_tpu_torch.utils.registry import Registry

TESTERS = Registry("testers")


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
        instead of silently reporting stale predictions. Rank 0 checks and
        cleans; every process takes its answer once it is done."""
        return broadcast_pyobject(self._check_pred_cache(save_path) if rank() == 0 else None)

    def _check_pred_cache(self, save_path) -> bool:
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


    def _write_scene_log(self):
        """``<save_path>/scene_log.json``: every process's scene records, in
        rank order, written by rank 0."""
        scene_log = allgather_pyobjects(self.scene_log)
        if self.save_path and scene_log and rank() == 0:
            with open(os.path.join(self.save_path, "scene_log.json"), "w") as f:
                json.dump(scene_log, f)


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
        self.save_submission = save_submission
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

            if self.save_submission and self.save_path:
                _write_submission(self.save_path, name, pred, type(self.dataset).__name__,
                                  getattr(self.dataset, "class2id", None))

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
        self._write_scene_log()
        # the totals anew from every process's per-scene records, in rank
        # order (the JAX tester's merge)
        merged = dict(allgather_pyobjects(list(record.items())))
        if not self.skip_eval and merged:
            for key in ("intersection", "union", "target"):
                setattr(metric, key, np.sum([v[key] for v in merged.values()],
                                            axis=0).astype(np.float64))
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
        if not self.save_path or rank() != 0:
            return
        os.makedirs(self.save_path, exist_ok=True)
        with open(os.path.join(self.save_path, "eval_results.txt"), "w") as f:
            f.write("\n".join(lines) + "\n\nPer-class results:\n" + "\n".join(per_class) + "\n")
            if excluded:
                f.write("\nExcluded classes:\n")
                for idx in excluded:
                    f.write(f"Class_{idx}-{self.class_names[idx]}\n")


@TESTERS.register_module()
class SemSegTester(TesterBase):
    """Supervised fragment-voting tester: per scene, the logits of every
    fragment of every test-time augmentation are summed by point, the
    argmax (or, for a ScanNet++ dataset, the top 3 in order, of which the
    first is scored) is mapped back through the deduplicating GridSample's
    inverse to ``origin_segment``, and intersection and union add up over
    the scenes. With ``save_path`` each scene's scored prediction goes to
    ``<name>_pred.npy`` and the per-scene seconds (fetch, extract, vote)
    to ``scene_log.json``; with ``save_submission`` too, the benchmark file
    of the prediction before the top-1 is taken. A Point Prompt Training
    model runs each fragment on the ``condition`` its pipeline's ``Add``
    names and gives logits in that condition's class space, padded to its
    widest condition with -1e9: the first ``num_classes`` columns are
    scored, and the others must be that padding."""

    def __init__(self, num_classes: int, ignore_index: int = -1,
                 max_scenes: Optional[int] = None, top3: Optional[bool] = None,
                 save_path: Optional[str] = None, save_submission: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.max_scenes = max_scenes
        if top3 is None:
            top3 = "ScanNetPP" in type(self.dataset).__name__
        self.top3 = bool(top3)
        self.save_path = save_path
        self.save_submission = save_submission
        self.scene_log = []

    def test(self):
        inter = np.zeros(self.num_classes, np.float64)
        union = np.zeros(self.num_classes, np.float64)
        target_area = np.zeros(self.num_classes, np.float64)
        n_scenes = len(self.dataset)
        if self.max_scenes:
            n_scenes = min(n_scenes, self.max_scenes)
        self.model.eval()
        for i in partition_indices(n_scenes):
            t_start = time.perf_counter()
            seed_transforms((self.seed, i))
            scene = self.dataset[i]
            t_fetch = time.perf_counter()
            name = scene.get("name", f"scene{i}")
            segment = np.asarray(scene["segment"]).reshape(-1)
            logits_sum = np.zeros((segment.shape[0], self.num_classes), np.float32)
            extract_s = 0.0
            for frag in scene["fragment_list"]:
                t0 = time.perf_counter()
                logits = self.extractor(frag)  # ends with the copy to the host
                extract_s += time.perf_counter() - t0
                if logits.shape[1] > self.num_classes:  # a PPT condition's padding
                    if not (logits[:, self.num_classes:] <= PAD_LOGIT / 2).all():
                        raise ValueError(f"{logits.shape[1]} logits for {self.num_classes} "
                                         "classes, and the others are no padding")
                    logits = logits[:, :self.num_classes]
                logits_sum[np.asarray(frag["index"]).reshape(-1)] += logits
            t_vote = time.perf_counter()
            if self.top3:  # ScanNet++ protocol: the 3 best classes, best first
                pred = np.argsort(-logits_sum, axis=1, kind="stable")[
                    :, :min(3, self.num_classes)].astype(np.int32)
            else:
                pred = logits_sum.argmax(axis=1).astype(np.int32)
            if "origin_segment" in scene and "inverse" in scene:
                pred = pred[np.asarray(scene["inverse"]).reshape(-1)]
                segment = np.asarray(scene["origin_segment"]).reshape(-1)
            if self.save_submission and self.save_path:
                _write_submission(self.save_path, name, pred, type(self.dataset).__name__,
                                  getattr(self.dataset, "class2id", None),
                                  getattr(self.dataset, "learning_map_inv", None))
            if pred.ndim > 1:
                pred = np.ascontiguousarray(pred[:, 0])  # the top-1 is scored
            i_, u_, t_ = intersection_and_union(pred, segment, self.num_classes,
                                                self.ignore_index)
            inter, union, target_area = inter + i_, union + u_, target_area + t_
            if self.save_path:
                os.makedirs(self.save_path, exist_ok=True)
                np.save(os.path.join(self.save_path, f"{name}_pred.npy"), pred)
            t_end = time.perf_counter()
            self.scene_log.append(dict(
                name=name, points=int(len(pred)), fragments=len(scene["fragment_list"]),
                fragment_points=[int(np.asarray(f["index"]).size)
                                 for f in scene["fragment_list"]],
                fetch_s=t_fetch - t_start, extract_s=extract_s, vote_s=t_end - t_vote,
                total_s=t_end - t_start))
            run_iou = (inter / (union + 1e-10))[union != 0]
            self.logger.info(
                f"Test: {name} [{i + 1}/{n_scenes}]-{len(segment)} "
                f"Accuracy {i_.sum() / (t_.sum() + 1e-10):.4f} "
                f"mIoU ({run_iou.mean() if run_iou.size else 0.0:.4f})")
        self._write_scene_log()
        inter, union, target_area = allreduce_sum_arrays((inter, union, target_area))
        iou = inter / np.maximum(union, 1e-10)
        seen = target_area > 0
        miou = float(iou[seen].mean()) if seen.any() else 0.0
        self.logger.info(f"test mIoU {miou:.4f}")
        return {"mIoU": miou, "iou_per_class": iou}


def _softmax(logits: np.ndarray) -> np.ndarray:
    """Softmax over the last axis, in the JAX testers' arithmetic."""
    logits = logits - logits.max(-1, keepdims=True)
    e = np.exp(logits)
    return e / e.sum(-1, keepdims=True)


def _object_logits(logits: np.ndarray) -> np.ndarray:
    """One object's [C] logits: a classifier's as they are, per-point
    logits [n, C] averaged over the points."""
    if logits.ndim == 2 and logits.shape[0] > 1:
        return logits.mean(axis=0)
    return logits


def _category(sample) -> int:
    return int(np.asarray(sample["category"]).reshape(-1)[0])


@TESTERS.register_module()
class ClsTester(TesterBase):
    """Object classification: each sample (its transforms seeded by (seed,
    index)) through the model, the argmax of its logits against its
    ``category``; reports ``allAcc``, the share right over every process's
    samples."""

    def __init__(self, num_classes: int, max_scenes: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.max_scenes = max_scenes

    def test(self):
        correct = total = 0
        n = len(self.dataset)
        if self.max_scenes:
            n = min(n, self.max_scenes)
        self.model.eval()
        for i in partition_indices(n):
            seed_transforms((self.seed, i))
            sample = self.dataset[i]
            pred = int(np.argmax(_object_logits(self.extractor(sample))))
            correct += int(pred == _category(sample))
            total += 1
        correct, total = (int(v) for v in allreduce_sum_arrays((correct, total)))
        acc = correct / max(total, 1)
        self.logger.info(f"cls accuracy: {acc:.4f} ({correct}/{total})")
        return {"allAcc": acc}


@TESTERS.register_module()
class ClsVotingTester(TesterBase):
    """Classification by voting over ``num_repeat`` repeats of the test
    augmentations: repeat r draws sample i's transforms from (seed, r, i)
    (or the sample's ``voting_list`` gives its variants), each object's
    softmax probabilities add up over the repeats, and after each repeat
    ``allAcc`` and ``mAcc`` of the running sums are taken over every
    process's objects; returns the record of the repeat best by
    ``metric``."""

    def __init__(self, num_classes: int, num_repeat: int = 100, metric: str = "allAcc",
                 max_scenes: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.num_repeat = num_repeat
        self.metric = metric
        self.max_scenes = max_scenes

    def _scene_prob(self, sample):
        def prob_of(s):
            return _softmax(_object_logits(self.extractor(s)))

        if "voting_list" in sample:
            return np.sum([prob_of(s) for s in sample["voting_list"]], axis=0)
        return prob_of(sample)

    def test(self):
        n = len(self.dataset)
        if self.max_scenes:
            n = min(n, self.max_scenes)
        prob_acc = {}
        best = {self.metric: -1.0}
        shard = partition_indices(n)
        self.model.eval()
        for rep in range(self.num_repeat):
            inter = np.zeros(self.num_classes)
            target = np.zeros(self.num_classes)
            for i in shard:
                seed_transforms((self.seed, rep, i))
                sample = self.dataset[i]
                prob_acc[i] = prob_acc.get(i, 0) + self._scene_prob(sample)
                pred, label = int(np.argmax(prob_acc[i])), _category(sample)
                if 0 <= label < self.num_classes:
                    target[label] += 1
                    if pred == label:
                        inter[label] += 1
            inter, target = allreduce_sum_arrays((inter, target))
            acc_cls = inter / np.maximum(target, 1e-10)
            record = {
                "allAcc": float(inter.sum() / max(target.sum(), 1e-10)),
                "mAcc": float(acc_cls[target > 0].mean()) if (target > 0).any() else 0.0,
            }
            if record[self.metric] > best[self.metric]:
                best = record
            self.logger.info(f"vote {rep + 1}/{self.num_repeat}: allAcc {record['allAcc']:.4f} "
                             f"mAcc {record['mAcc']:.4f} "
                             f"(best {self.metric} {best[self.metric]:.4f})")
        return best


@TESTERS.register_module()
class PartSegTester(TesterBase):
    """Part segmentation: per object the softmax probabilities of its
    variants (``voting_list``, or the sample itself) add up by point, and
    each part of its shape category (the dataset's ``categories`` and
    ``category2part``, the sample's ``cls_token``) scores its IoU, 1 where
    neither label nor prediction holds it. Reports ``ins_mIoU`` (over the
    objects) and ``cat_mIoU`` (over the categories' means), the sums over
    every process's objects. The reference's ``pred_part.total`` (no such
    method) is a sum, as the JAX package has it."""

    def __init__(self, num_classes: int, max_scenes: Optional[int] = None, **kwargs):
        super().__init__(**kwargs)
        self.num_classes = num_classes
        self.max_scenes = max_scenes

    def test(self):
        ds = self.dataset
        categories = list(ds.categories)
        category2part = dict(ds.category2part)
        iou_category = np.zeros(len(categories))
        iou_count = np.zeros(len(categories))
        n = len(ds)
        if self.max_scenes:
            n = min(n, self.max_scenes)
        self.model.eval()
        for i in partition_indices(n):
            sample = ds[i]
            label = np.asarray(sample["segment"]).reshape(-1)
            prob = np.zeros((label.shape[0], self.num_classes), np.float32)
            for v in sample.get("voting_list", [sample]):
                prob += _softmax(self.extractor(v))
            pred = prob.argmax(-1)
            cat_idx = int(np.asarray(sample["cls_token"]).reshape(-1)[0])
            parts = category2part[categories[cat_idx]]
            parts_iou = np.zeros(len(parts))
            for j, part in enumerate(parts):
                if (label == part).sum() == 0 and (pred == part).sum() == 0:
                    parts_iou[j] = 1.0
                else:
                    inter = ((label == part) & (pred == part)).sum()
                    union = ((label == part) | (pred == part)).sum()
                    parts_iou[j] = inter / (union + 1e-10)
            iou_category[cat_idx] += parts_iou.mean()
            iou_count[cat_idx] += 1
        iou_category, iou_count = allreduce_sum_arrays((iou_category, iou_count))
        ins_miou = iou_category.sum() / (iou_count.sum() + 1e-10)
        cat_miou = float((iou_category / (iou_count + 1e-10)).mean())
        self.logger.info(f"part seg ins.mIoU/cat.mIoU {ins_miou:.4f}/{cat_miou:.4f}")
        return {"ins_mIoU": float(ins_miou), "cat_mIoU": cat_miou}


def _write_submission(save_path, name, pred, dataset_type, class2id=None,
                      learning_map_inv=None):
    """One scene's benchmark file under ``<save_path>/submit``, byte for byte
    the JAX package's: ScanNet-20 and ScanNet200 a text column of benchmark
    ids; KITTI-360 a uint32 ``.label``; SemanticKITTI
    ``sequences/<seq>/predictions/<frame>.label`` through the inverse
    label map; nuScenes ``lidarseg/test/<name>_lidarseg.bin``, classes from
    1 in uint8; the others (ScanNet++, Matterport3D, HoliCity) the labels
    as text, a ScanNet++ top-3 prediction three comma-separated columns."""
    submit_dir = os.path.join(save_path, "submit")
    os.makedirs(submit_dir, exist_ok=True)
    if dataset_type in ("ScanNetGSDataset", "ScanNet200GSDataset") and class2id is not None:
        mapped = np.where(pred >= 0, class2id[np.clip(pred, 0, len(class2id) - 1)], 0)
        np.savetxt(os.path.join(submit_dir, f"{name}.txt"), mapped.reshape(-1, 1), fmt="%d")
    elif dataset_type == "KITTI360GSDataset":
        pred.astype(np.uint32).tofile(os.path.join(submit_dir, f"{name}.label"))
    elif dataset_type == "SemanticKITTIDataset":
        seq, frame = name.split("_")
        d = os.path.join(submit_dir, "sequences", seq, "predictions")
        os.makedirs(d, exist_ok=True)
        out = pred.astype(np.uint32)
        if learning_map_inv is not None:
            out = np.vectorize(learning_map_inv.__getitem__)(out).astype(np.uint32)
        out.tofile(os.path.join(d, f"{frame}.label"))
    elif dataset_type == "NuScenesDataset":
        d = os.path.join(submit_dir, "lidarseg", "test")
        os.makedirs(d, exist_ok=True)
        (pred.astype(np.int64) + 1).astype(np.uint8).tofile(
            os.path.join(d, f"{name}_lidarseg.bin"))
    else:
        np.savetxt(os.path.join(submit_dir, f"{name}.txt"), pred.astype(np.int32),
                   delimiter=",", fmt="%d")


def build_tester(cfg, model, dataset_cfg, patch_size=1024, seed=0,
                 weights_fingerprint=None, device="cuda"):
    return TESTERS.build(dict(cfg), model=model, dataset_cfg=dataset_cfg,
                         patch_size=patch_size, seed=seed,
                         weights_fingerprint=weights_fingerprint, device=device)
