"""Chip smoke test of the PyTorch/CUDA port (scenesplat_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card, and the kernels' build from this checkout's sources
     (one nvcc per source, started together);
  2. kernel: the flash-window attention kernel against its plain version at
     every (window, channels, heads) signature of the flagship backbone and
     of configs/test_lang_inference.py and at windows on both sides of the
     bf16 variants' thresholds (windows of 16 to 64 on the one-pass
     bf16_small, 65 and 4160 on bf16_tiled, 128 to 1024 on bf16_large),
     fp32 and bf16, with partial and fully padded windows, a ragged last
     window and valid prefixes that end inside a key tile, on a tile edge and
     one past it; in bf16 also the log-sum-exp against the plain one and the
     output with and without it (equal bits);
  3. serve: the zero-shot serving path (FeatureExtractor -> flagship
     LangPretrainer in bf16 -> zero_shot_predict against the ScanNet200
     SigLIP2 table) at 196,608 points of a seeded synthetic room, a few
     requests, with the kernel's launches counted;
  4. timing: at the shapes and valid counts phase 3 gave each launch, the
     kernel against its plain version in bf16, then the times of the
     kernel, the plain version and scaled_dot_product_attention (the
     library yardstick, used nowhere in the port), with the least time the
     card could take for the same work, the TFLOP/s reached and which
     variant ran;
  5. shipped: one forward of the shipped inference backbone (decoder
     windows of 48, ragged at every stage, on bf16_small) at 65,536 points;
  6. agree: fp32 forward with the kernel against the same forward with the
     plain attention at 49,152 points;
  7. kernel_bwd: the attention backward kernels (through the autograd
     Function) against autograd through the plain version at every
     signature of phase 2, fp32 and bf16 (both bf16 variants: windows on
     both sides of the backward's threshold of 64), with zero gradients in
     padded windows;
  8. train: scenesplat_tpu_torch.train's trainer on the flagship config
     (configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py, read
     through the port's Config) over a synthetic 3DGS dataset written to a
     temporary directory: flagship widths, losses, optimizer, schedule,
     transforms, Mix3D and 196,608 points, batch 2, epoch 1 so the
     contrastive term is live, and the file's own hooks (the evaluator
     over one small validation scene per dataset logs val*/fg_mIoU, the
     saver writes model_best.pth, PreciseEvaluator finds no tester); 1 + 5
     steps with K1 and K2 launches counted (and each variant's: the
     decoder's windows of 48 on bf16_small, the encoder's on bf16_large),
     step times, loader waits, peak memory and one profiled step;
  9. timing_bwd: at the train step's stage shapes, the forward with
     log-sum-exp and the backward kernel against the plain version (bf16
     noise-floor rule, zeros in padded windows), then their times against
     the plain version, scaled_dot_product_attention's forward and backward
     (the library yardstick, used nowhere in the port) and the least time
     the card could take;
 10. train_agree: one fp32 train step of the flagship config file's model at
     49,152 points with the kernels and one with the plain attention, same
     weights and generator seeds;
 11. ddp_train: data parallel, the train phase's run once more through
     DistributedDataParallel under a one-process NCCL group, as torchrun
     starts one (the same data, batch 2, 1 + 5 steps, the file's hooks with
     the evaluator on the scene-sharded path, K1 and K2 launches, step
     times, loader waits, peak memory, beside the train phase's), its
     checkpoint loaded strictly into a one-process model; then one fp32
     step at 49,152 points under DDP against the same step without it
     (losses to 1e-5, gradients to 1e-4 relative);
 12. ddp_agree: two ranks on the one card over gloo (NCCL refuses two ranks
     on one card), spawned after the kernels are built: one fp32 step of a
     global batch of 2 rows of 49,152 points (drop-path 0.3, the
     contrastive term on) against one process's step over both rows (the
     loss to 1e-5, the gradient norm, every gradient and every BatchNorm
     running statistic to 1e-4 relative, equal gradients on both ranks),
     then the zero-shot test entry over 3 scenes on the ddp_train
     checkpoint, the ranks' metrics and predictions equal to one
     process's (both under deterministic algorithms); the ranks' K1 and K2
     launches go into the kernels line;
 13. kernel_sort: the bitonic row sort K3 against its plain version, exact,
     at 2 and 3 operands, 1 to 3 keys, rows of 1000 to 2^20, 1 to 12 rows,
     random and heavily tied keys, and against torch.sort (equal keys;
     with the index as last key, the stable order); int64 codes with a
     sentinel tail through sort_int64 with the switch on (K3's int64 entry)
     against its plain version and against torch.sort(stable=True), rows
     of 1, 3 and 4, lengths that are no power of two;
 14. test: scenesplat_tpu_torch.test's main on the flagship config file
     plus test= and data.test= (the fragment test pipeline of
     configs/_base_/gs_pipelines.py), bf16, the train phase's checkpoint,
     over two synthetic ScanNet200-layout scenes of 320,001 Gaussians at
     1 cm spacing (2 fragments of 160,001 points each); once with
     torch.sort and once with SCENESPLAT_BITONIC_SORT=1, both under
     torch.use_deterministic_algorithms: equal predictions and metrics, K3
     launches 0 then as reckoned, K1 18 per fragment (the decoder's 6 on
     bf16_small); then once more with torch.sort and without the
     deterministic mode, as a user runs it, for the times per scene;
 15. timing_sort: sort_int64 with the switch on (K3 as the sort sites call
     it), torch.sort and the plain version by CUDA events at the eight sort
     shapes of one fragment forward;
 16. timing_test: at the shapes and valid counts the test phase gave the
     decoder's K1 calls (windows of 48, without lse) in one fragment
     forward, the kernel against its plain version in bf16, then the times
     of the kernel, the plain version and scaled_dot_product_attention, with
     the bound, per call and per fragment forward;
 17. ssl_train: the trainer on the SimDINO file
     configs/scannet/ssl-pretrain-scannet-all-base.py as it is
     (SimDINOSSL over a 5-stage PT-v3m1 with its mask token, windows of
     1024 in the encoder and 48 in the decoder, the DINO, iBOT and MAE
     heads, the EMA teacher, 2 global crops of 102,400 points with patch
     token masks and 3 local crops of 25,600, the multi-crop transforms
     with the voxel blur, AdamW + OneCycle, its own hooks) at batch 2 (the
     file's 24 is 6 a card on 4 cards) for 6 steps over 4 synthetic
     unlabeled rooms: step times, loader waits, peak memory, every loss
     term (finite), pooling overflow per stage and crop kind (none allowed
     past the first pooling, where the file's capacities overflow on dense
     rooms, as they do unseen in the JAX package), K1 launches
     of each variant with and without lse for the student and the teacher
     apart, K2 launches of each variant, the teacher held to m t + (1 - m) s
     at every step within fp32 rounding and its mask token unmoved; then
     ssl_timing_bwd, timing_bwd at the student's stage shapes (the first
     global crop's twice, the first local crop's three times, the locals'
     decoder forward only), and ssl_timing_teacher, timing at the teacher's
     shapes (its two passes over the global crops, K1 without lse);
 18. ssl_agree: one fp32 SSL loss and its gradients of that model at one
     block a stage with mean pooling (the file's max pooling makes the
     gradient a discontinuous function of the features), batch 2, global
     crops of 24,576 points with injected token masks and local crops of
     6,144, with the kernels and with the plain attention: the loss to
     1e-5, the gradient of each term apart, each tensor and the whole to
     1e-4 relative (the MCR expansion's from one cotangent at the student's
     DINO heads, given to both paths: its own is ill-conditioned);
 19. warm_start: python -m scenesplat_tpu_torch.rename_ckpt on ssl_train's
     checkpoint for the teacher and the student (each backbone bit for bit
     as backbone.*, no mask token); the train phase's flagship checkpoint
     into the semseg file's model and the extracted teacher into the
     flagship file's, as the files' non-strict CheckpointLoader loads them
     (every encoder tensor of stages 0-3 loaded bit for bit, every other
     tensor skipped or kept at its initialization, each one named in the
     log);
 20. semseg_train: the trainer on the semantic-segmentation file
     configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py as it is
     (DefaultSegmentorV2 over a 5-stage PT-v3m1, 32 heads at stage 4,
     in_channels 14, 205,824 points, CE + Lovasz, Mix3D 0.8, its own hooks:
     SemSegEvaluator, CheckpointSaver, PreciseEvaluator with the file's
     SemSegTester and 9 test-time views), started with weight= the
     extracted teacher (every backbone tensor but the stem, 11 vs 14
     channels, equal to the teacher's bit for bit after the file's
     CheckpointLoader; the stem and seg_head at their initialization; the
     log names them), at batch 2 for 6 steps over 4 synthetic ScanNet-layout
     scenes with normals and 20 classes and one validation scene: step
     times, loader waits, peak memory, val/mIoU, K1 and K2 launches of each
     variant a step, pooling overflow per stage (none allowed); then
     semseg_timing_bwd, timing_bwd at its stage shapes;
 21. semseg_agree: one fp32 train step of that model at one block a stage
     and 49,152 points with the kernels and with the plain attention
     (losses to 1e-5, gradients to 1e-4 relative);
 22. semseg_test: scenesplat_tpu_torch.test's main on the semseg file with
     the semseg_train checkpoint over two synthetic scenes of 320,000
     Gaussians, 9 views each: torch.sort and K3 under deterministic
     algorithms (equal predictions and mIoU), then as a user runs it, for
     the seconds per scene (fetch, extract, vote); then semseg_timing_test
     (every K1 call of the first fragment forward, bf16_large and
     bf16_small without lse) and semseg_timing_sort (K3 at that forward's
     sort shapes);
 23. semseg_ddp_agree and ssl_ddp_agree: two ranks sharing the card over
     gloo, one row each, against one process over both rows, fp32, the
     files' models at one block a stage: semseg at 2 rows of 49,152 points,
     drop-path 0.3, CE + Lovasz over the gathered global batch (the loss
     to 1e-5, every gradient to 1e-4 of its norm, the BatchNorm statistics
     to 1e-6); SSL at crops of 24,576 and 6,144 with mean pooling and token
     masks drawn at the global shape (every loss term to 1e-5, every
     student gradient to 1e-4, the statistics to 1e-6, after the SGD step
     and the EMA the teacher bit-equal on both ranks and within 1e-6 of one
     process's, its mask token unmoved); K1 with lse and K2 on each rank;
 24. remat_agree: one fp32 train step of the flagship file's model at its
     widths, 2 rows of 49,152 points, with remat_blocks off and on, under
     deterministic algorithms: the loss bit-equal, every gradient to 1e-5
     of its norm, each run's peak memory and K1 / K2 launches a step (the
     recompute launches K1 with lse once more a block).
The kernel and kernel_bwd phases also hold K1 and K2 at a local crop's
encoder stage shapes (25,600 to 2,048 slots, whole windows of 1024).
Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises; without a CUDA card the script exits non-zero.

    python3 chip_smoke.py --cards N [flagship] [semseg] [ssl] [fit]

runs data parallel across N cards of one host instead (not the one-card
smoke test): the kernels' build, then the phases named (all but fit by
default): flagship, ddp_cards_train, the flagship file at its own global
batch of 8 as 2 rows a card on N = 4 cards (each rank a spawned process on
its card over NCCL, the train phase's rooms, one epoch's steps and one
sharded validation; the same losses on every rank), and ddp_cards_agree,
ddp_agree with one rank a card over NCCL on that run's checkpoint; semseg
and ssl, cards_semseg and cards_ssl, those files at their own global
batches of 48 and 24 (12 and 6 rows a card on 4), remat_blocks as
CARDS_REMAT says, for a few steps over 4 rooms (every card's warm step,
peak memory, loader wait and NCCL time; the same losses on every rank);
fit, cards_fit, on one card, those rows a card with remat_blocks off and
on, down to the largest batch that fits.
"""

from __future__ import annotations

import contextlib
import gc
import inspect
import json
import logging
import math
import multiprocessing as mp
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from scenesplat_tpu_torch.engines.eval import load_text_embeddings, zero_shot_predict
from scenesplat_tpu_torch import test as test_entry
from scenesplat_tpu_torch.data import metadata
from scenesplat_tpu_torch.engines.hooks import HookBase
from scenesplat_tpu_torch.engines.hooks.misc import PreciseEvaluator
from scenesplat_tpu_torch.engines.infer import FeatureExtractor, bucket_size
from scenesplat_tpu_torch.engines.pretrain import (
    SSLObjective,
    build_ssl_model,
    ssl_loss,
    ssl_train_step,
)
from scenesplat_tpu_torch.engines.train import build_trainer
from scenesplat_tpu_torch.engines.train_step import lang_loss, semseg_loss, train_step
from scenesplat_tpu_torch.entry import (
    FLAGSHIP_BACKBONE,
    SHIPPED_INFERENCE_BACKBONE,
    build_lang_model,
)
from scenesplat_tpu_torch.models import PointBatch, build_criteria, build_model
from scenesplat_tpu_torch.models.ptv3 import PointTransformerV3, _round_capacity
from scenesplat_tpu_torch.models.ssl import generate_token_masks
from scenesplat_tpu_torch.ops import bitonic_sort as bs
from scenesplat_tpu_torch.ops import flash_window_attn as fwa
from scenesplat_tpu_torch.ops import window_attention as window_attention_module
from scenesplat_tpu_torch.ops.knn import knn
from scenesplat_tpu_torch.ops.serialization import SENTINEL
from scenesplat_tpu_torch.parallel.dist import (
    all_reduce_sum,
    data_parallel,
    init_distributed,
    local_batch_slice,
    process_group,
    world,
)
from scenesplat_tpu_torch.utils.config import Config

FLAGSHIP_CONFIG = "configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py"
PIPELINES = "configs/_base_/gs_pipelines.py"

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 rate
GRID = 0.02  # metres per voxel
FP32_ATOL = 1e-4
BF16_NOISE_FACTOR = 2.5
# fp32 features with the kernel vs the plain attention, unit-norm 768-d rows:
# each attention call agrees to ~1e-6 (fp32 summation order), and 18 blocks
# of LayerNorm'd residual updates carry that far below this bound
AGREE_ATOL = 1e-3
AGREE_ARGMAX = 0.99
# backward, fp32: each gradient within 1e-4 of the plain gradient's largest
# magnitude (the kernel and autograd sum in other orders)
BWD_FP32_RTOL = 1e-4
# one fp32 train step, kernels vs plain attention: losses to 1e-5 relative,
# each parameter gradient to 1e-4 relative L2 of its own norm. A gradient
# that is zero in exact arithmetic (the bias of a linear layer whose every
# consumer is a BatchNorm, which the batch mean cancels) is rounding noise on
# both sides, below ZERO_GRAD of the global gradient norm; the other tensors
# lie above 1e-6 of it
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
ZERO_GRAD = 1e-7
TRAIN_POINTS = 196608
TRAIN_CLASSES = 20
LANG_DIM = 768
SEMSEG_CONFIG = "configs/scannet/semseg-gs-scannet-all-w-normal-fixed-xyz.py"
SSL_CONFIG = "configs/scannet/ssl-pretrain-scannet-all-base.py"


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_k1_counts():
    """K1's launch count and each variant's to 0, as just before a path is
    driven."""
    fwa.flash_window_attention.launches = 0
    for counts in (fwa.flash_window_attention.variant_launches,
                   fwa.flash_window_attention.lse_variant_launches):
        counts.update(dict.fromkeys(counts, 0))


def k1_variants():
    """K1's launches of each variant since the last reset."""
    return dict(fwa.flash_window_attention.variant_launches)


def k1_lse_variants():
    """K1's launches with the log-sum-exp, of each variant, since the last
    reset."""
    return dict(fwa.flash_window_attention.lse_variant_launches)


def depth_split(backbone):
    """(encoder blocks, decoder blocks) of a backbone config: the K1
    launches a forward makes at the encoder's and at the decoder's
    windows."""
    return sum(backbone["enc_depths"]), sum(backbone["dec_depths"])


def room_scene(rng, n, size_m, thickness=1):
    """n unique 2 cm voxels on the floor and the four walls of a room of
    ``size_m`` metres, surfaces ``thickness`` voxels thick, with 11 Gaussian
    features (colour, opacity, unit quaternion, scale) -> (coord, feat,
    grid_coord)."""
    ex, ey, ez = (int(round(s / GRID)) for s in size_m)
    x, y, z = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij")
    t = thickness
    surface = (z < t) | (x < t) | (x >= ex - t) | (y < t) | (y >= ey - t)
    vox = np.stack([x[surface], y[surface], z[surface]], -1)
    check(len(vox) >= n, f"room {size_m} holds {len(vox)} voxels < {n}")
    grid = vox[rng.choice(len(vox), n, replace=False)].astype(np.int64)
    coord = ((grid + 0.5) * GRID).astype(np.float32)
    quat = rng.normal(size=(n, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    feat = np.concatenate([
        rng.uniform(-1, 1, (n, 3)),  # colour
        rng.uniform(0, 1, (n, 1)),  # opacity
        quat,
        rng.uniform(0, 0.05, (n, 3)),  # scale
    ], axis=1).astype(np.float32)
    return coord, feat, grid


def cuda_ms(fn, reps, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libraries = (fwa.LIBRARY, fwa.LIBRARY_SMALL, fwa.LIBRARY_LARGE, fwa.LIBRARY_BWD, bs.LIBRARY)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per source, together
        build_s = dict(zip((lib.source.name for lib in libraries),
                           pool.map(lambda lib: lib.build(), libraries)))
    wall_s = time.perf_counter() - t0
    ptxas = {}
    for lib in libraries:
        lib.load()
        ptxas[lib.source.name] = [
            ln.split("ptxas info    : ")[-1] for ln in lib.log_path().read_text().splitlines()
            if "registers" in ln or "spill" in ln][:40]
    emit(dict(phase="device", nvidia_smi=smi, torch=torch.__version__,
              cuda=torch.version.cuda, kind=torch.cuda.get_device_name(0),
              cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
              build_s=build_s, build_wall_s=wall_s, ptxas=ptxas))
    return smi


def check_noise_floor(err, floor, what, shape):
    """The noise-floor rule of tests/test_attention.py: the kernel's relative
    error on bf16 input against the plain version run in fp32 may be at
    most BF16_NOISE_FACTOR times the plain bf16 version's own."""
    check(floor > 1e-4, f"bf16 path not exercised ({what}) at {shape}")
    check(err <= BF16_NOISE_FACTOR * floor,
          f"bf16 {what} error {err} > {BF16_NOISE_FACTOR} x {floor} at {shape}")


def check_bf16(x16, valid, k, h, out=None):
    """The kernel's bf16 output (``out``, else the inference launch's) under
    the noise-floor rule. Returns both errors."""
    chunk = max(8, 16384 // k)  # windows per plain chunk: the result is the same
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h,
                                             patch_chunk=chunk)[valid]

    def rel(o):
        return ((o[valid].float() - truth).norm() / truth.norm()).item()

    if out is None:
        out = fwa.flash_window_attention(x16, valid, k, h)
    err = rel(out)
    floor = rel(fwa.flash_window_attention_plain(x16, valid, k, h, patch_chunk=chunk))
    check_noise_floor(err, floor, "output", ("N, K, C, H", x16.shape[1], k, x16.shape[3], h))
    return err, floor


SIGNATURES = sorted({
    (k, c, h)
    for k in (1024, 48)
    for c, h in ((768, 16), (512, 16), (256, 16))
} | {(1024, c, h) for c, h in ((32, 2), (64, 4), (128, 8), (256, 16))}
  # windows on both sides of the bf16 variants' thresholds (forward 64 and
  # 128, backward 64)
  | {(k, c, h) for k in (16, 32, 64, 65, 128, 192, 256)
     for c, h in ((768, 16), (512, 16), (32, 2))}
  # above the large-window forward's 4096: the tiled forward again
  | {(4160, 32, 2)}
  # the semseg files' backbone: 32 heads at encoder stage 4, and the
  # decoder's 4 heads at C = 64 and 8 at C = 128 at windows of 48
  | {(1024, 512, 32), (48, 64, 4), (48, 128, 8)})
# the encoder stages of a local crop of the SSL file (25,600 points, windows
# of 1024: whole windows, two at stage 4): (N, K, C, H), checked beside
# SIGNATURES at their own N
SSL_LOCAL_STAGES = ((25600, 1024, 32, 2), (13312, 1024, 64, 4), (7168, 1024, 128, 8),
                    (4096, 1024, 256, 16), (2048, 1024, 512, 32))
KERNEL_CASES = [(k, c, h, None) for k, c, h in SIGNATURES] + [
    (k, c, h, n) for n, k, c, h in SSL_LOCAL_STAGES]
# the bf16 forward variant each of these windows of SIGNATURES must take
VARIANT_WINDOWS = {"bf16_small": {16, 32, 48, 64}, "bf16_tiled": {65, 4160},
                   "bf16_large": {128, 192, 256, 1024}}
LSE_ATOL = 1e-4  # bf16 forward: fp32 log-sum-exp against the plain one


def signature_inputs(gen, k, c, batch=2, n=None):
    """qkv [batch, N, 3, c] fp32 and valid prefixes for windows of k, by
    default N with a ragged last window: a partial window, then fully padded
    windows; with batch 4 also prefixes that end on a 64-key tile edge and
    one past it."""
    n = n or 3 * k + k // 2 + 5
    valid = torch.zeros(batch, n, dtype=torch.bool, device="cuda")
    valid[0, : int(0.8 * n)] = True  # ends inside a key tile
    valid[1, : k + 7] = True  # then fully padded windows
    if batch > 2:
        valid[2, : k + 64] = True
        valid[3, : k + 65] = True
    qkv = torch.randn(batch, n, 3, c, generator=gen, device="cuda")
    p = -(-n // k)
    slot0 = torch.nn.functional.pad(valid, (0, p * k - n)).view(batch, p, k)[:, :, :1]
    dead = ~slot0.expand(batch, p, k).reshape(batch, p * k)[:, :n]  # windows of padding
    return n, qkv, valid, dead


def plain_lse(qkv, valid, k, h):
    """The natural-log log-sum-exp of each row's scaled scores over the valid
    keys of its window, [B, N, H] fp32, in plain torch ops."""
    b, n, _, c = qkv.shape
    d, p = c // h, -(-n // k)
    pad = p * k - n
    qkv = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    blk = qkv.view(b, p, k, 3, h, d).permute(3, 0, 1, 4, 2, 5)
    scores = (blk[0] * d ** -0.5).float() @ blk[1].float().transpose(-1, -2)
    scores = torch.where(valid.view(b, p, 1, 1, k), scores, float("-inf"))
    return torch.logsumexp(scores, -1).permute(0, 1, 3, 2).reshape(b, p * k, h)[:, :n]


def phase_kernel():
    """Kernel vs plain at every signature; returns the fp32 max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst32, rows = 0.0, []
    for k, c, h, n_case in KERNEL_CASES:
        n, qkv, valid, dead = signature_inputs(gen, k, c, batch=4, n=n_case)
        out32 = fwa.flash_window_attention(qkv, valid, k, h)
        ref32 = fwa.flash_window_attention_plain(qkv, valid, k, h)
        torch.cuda.synchronize()
        check(torch.isfinite(out32).all().item(), f"non-finite output at {k, c, h}")
        err32 = (out32 - ref32)[valid].abs().max().item()
        check((out32[dead] == 0).all().item(), f"padded windows not zero at {k, c, h}")

        x16 = qkv.bfloat16()
        variant = fwa.forward_variant(x16.dtype, k, c // h)
        out16, lse16 = fwa._launch_fwd(x16, valid, k, h, (c // h) ** -0.5, True)
        err16, floor16 = check_bf16(x16, valid, k, h, out=out16)
        check((out16[dead] == 0).all().item(), f"bf16 padded windows not zero at {k, c, h}")
        check(torch.equal(out16, fwa.flash_window_attention(x16, valid, k, h)),
              f"bf16 output differs with and without the log-sum-exp at {k, c, h}")
        lse_err = (lse16 - plain_lse(x16, valid, k, h))[~dead].abs().max().item()
        check(lse_err <= LSE_ATOL, f"bf16 log-sum-exp error {lse_err} at {k, c, h}")
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err=err32, bf16_variant=variant,
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16,
                         bf16_lse_max_abs_err=lse_err))
        check(err32 <= FP32_ATOL, f"fp32 error {err32} > {FP32_ATOL} at {k, c, h}")
        worst32 = max(worst32, err32)
    for variant, windows in VARIANT_WINDOWS.items():
        took = {r["K"] for r in rows if r["bf16_variant"] == variant}
        check(took == windows, f"bf16 {variant} took windows {sorted(took)}, expected "
              f"{sorted(windows)}")
    emit(dict(phase="kernel", fp32_atol=FP32_ATOL, bf16_noise_factor=BF16_NOISE_FACTOR,
              bf16_lse_atol=LSE_ATOL, cases=rows))
    return worst32


def stage_shapes(backbone, sizes):
    """(N, valid, K, C, H, launches) of every attention call of one forward,
    grouped by stage, from each stage's (slots, valid count) in ``sizes``;
    what the config leaves out (the flagship file's ``dec_patch_size``)
    takes the backbone's default."""
    params = inspect.signature(PointTransformerV3.__init__).parameters.values()
    backbone = {**{p.name: p.default for p in params if p.default is not p.empty},
                **backbone}
    enc_c, enc_h = backbone["enc_channels"], backbone["enc_num_head"]
    shapes = [(n, v, backbone["enc_patch_size"][s], enc_c[s], enc_h[s],
               backbone["enc_depths"][s]) for s, (n, v) in enumerate(sizes)]
    for s in reversed(range(len(sizes) - 1)):
        n, v = sizes[s]
        shapes.append((n, v, backbone["dec_patch_size"][s], backbone["dec_channels"][s],
                       backbone["dec_num_head"][s], backbone["dec_depths"][s]))
    return shapes


def serve(model, sample, text, reps):
    """One cold and ``reps`` warm requests (feature extraction, then
    zero-shot prediction on the host). Returns features, predictions, the
    plans of the last forward and per request the milliseconds of
    extraction and of prediction, on the host clock."""
    plans = []

    def keep_plans(out):
        plans[:] = out.plans
        return out.feat

    extractor = FeatureExtractor(model, patch_size=1024, device="cuda",
                                 output_fn=keep_plans)
    times = []
    for _ in range(1 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feat = extractor(sample)  # ends with the copy to the host
        t1 = time.perf_counter()
        pred, _ = zero_shot_predict(feat, text)
        times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3))
    return feat, pred, plans, times


def device_kernels(prof):
    """A profile's device work by name: kernels and copies, not the ranges
    that code annotates (an annotated range's device time, such as
    DistributedDataParallel.forward's or the optimizer step's, repeats its
    kernels' time)."""
    return [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0 and not e.is_user_annotation]


def device_profile(model, point):
    """Device time of one forward by kernel, from torch.profiler: the busy
    time, the wall time of the forward and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model(point)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms if wall_ms else None,
                top_kernels=[dict(name=e.key[:90], calls=e.count,
                                  ms=e.self_device_time_total / 1e3) for e in top])


def check_features(feat, n, name):
    check(feat.shape == (n, 768), f"{name}: feature shape {feat.shape}")
    check(np.isfinite(feat).all(), f"{name}: non-finite features")
    norms = np.linalg.norm(feat, axis=1)
    check(np.abs(norms - 1).max() < 1e-2, f"{name}: features not L2-normalized")


def phase_serve(text):
    n, reps = 196608, 3
    rng = np.random.default_rng(0)
    coord, feat_in, grid = room_scene(rng, n, (6.0, 6.0, 3.0))
    backbone = dict(FLAGSHIP_BACKBONE)
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    sample = dict(coord=coord, feat=feat_in, grid_coord=grid)
    torch.cuda.reset_peak_memory_stats()
    reset_k1_counts()
    feat, pred, plans, times = serve(model, sample, text, reps)
    launches, variants = fwa.flash_window_attention.launches, k1_variants()
    check(variants["bf16_large"] == launches,
          f"the serve path's launches (bf16, windows of 1024) did not all take the "
          f"large-window kernel: {variants}")
    check_features(feat, n, "serve")
    overflow = [int(p.n_overflow.max()) for p in plans]
    clusters = [int(p.n_clusters.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
    check(launches == 18 * (1 + reps), f"{launches} kernel launches for {1 + reps} "
          "forwards, expected 18 each")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    # the forward alone, on a batch already on the card (196,608 is a bucket)
    point = PointBatch(
        coord=torch.from_numpy(coord)[None].cuda(),
        feat=torch.from_numpy(feat_in)[None].cuda(),
        grid_coord=torch.from_numpy(grid)[None].cuda(),
        mask=torch.ones(1, n, dtype=torch.bool, device="cuda"))
    with torch.inference_mode():
        forward_ms = cuda_ms(lambda: model(point), reps=3, warmup=1)
    profile = device_profile(model, point)

    uniq, counts = np.unique(pred, return_counts=True)
    emit(dict(phase="serve", points=n, dtype="bfloat16", requests=1 + reps,
              cold_extract_ms=times[0][0], warm_extract_ms=[t[0] for t in times[1:]],
              zero_shot_ms=[t[1] for t in times], forward_ms=forward_ms,
              kernel_launches=launches, launches_per_forward=launches / (1 + reps),
              variant_launches=variants,
              n_clusters=clusters, n_overflow=overflow, peak_mem_gib=peak_gib,
              classes_predicted=len(uniq),
              class_histogram=dict(zip(uniq.tolist(), counts.tolist())),
              profile=profile))
    sizes = [(n, n)] + [(p.out_mask.shape[1], int(p.out_mask.sum())) for p in plans]
    return stage_shapes(backbone, sizes), launches, variants


def bound_ms(n, n_valid, k, c):
    """Least time for one bf16 call, as (ops_ms, bytes_ms): the needed work
    (valid query rows against the valid keys of their window) at the bf16
    peak, and the bytes (qkv of live windows read once, the output written
    once, the mask read once) at the memory rate."""
    ops, rows_live = 0, 0
    for w0 in range(0, n, k):
        v = max(0, min(n_valid, w0 + k) - w0)
        ops += 4 * v * v * c
        rows_live += min(k, n - w0) if v else 0
    nbytes = 2 * (3 * c * rows_live + c * n) + n
    return ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_timing(shapes, phase="timing"):
    """Kernel against plain (bf16 noise-floor rule), then kernel, plain and
    library times per call at the main path's shapes, and the times' sums
    over one forward. A shape's valid count is one row's, or a list of the
    rows' (a batch)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    by_variant = {}  # the sums over each variant's calls
    for n, n_valid, k, c, h, count in shapes:
        valids = n_valid if isinstance(n_valid, (list, tuple)) else [n_valid]
        b = len(valids)
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
        err16, floor16 = check_bf16(qkv, valid, k, h)
        ms = cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps=10)
        plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                           reps=3, warmup=1)
        p, d = -(-n // k), c // h
        pad = p * k - n
        qkv_w = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], 1) if pad else qkv
        valid_w = torch.cat([valid, valid.new_zeros(b, pad)], 1) if pad else valid
        q, kk, v = qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid_w.view(b * p, 1, 1, k)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps=10)
        ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms)
        tflops = ops_ms * PEAK_BF16_FLOPS / ms / 1e12  # needed operations over the time
        rows.append(dict(N=n, valid=n_valid, K=k, C=c, H=h, launches=count, **row,
                         bound_ms=max(ops_ms, bytes_ms), bf16_rel_err=err16,
                         bf16_plain_rel_err=floor16,
                         variant=fwa.forward_variant(qkv.dtype, k, d), tflops=tflops,
                         library_tflops=ops_ms * PEAK_BF16_FLOPS / lib_ms / 1e12,
                         share_of_bf16_peak=ops_ms / ms))
        part = by_variant.setdefault(rows[-1]["variant"], dict.fromkeys(tot, 0.0))
        for key, val in row.items():
            tot[key] += count * val
            part[key] += count * val
        part["launches"] = part.get("launches", 0) + count
        del qkv, qkv_w, q, kk, v
    for t in (tot, *by_variant.values()):
        t["bound_ms"] = max(t["ops_ms"], t["bytes_ms"])
        t["bound_by"] = "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes"
    tot["by_variant"] = by_variant
    emit(dict(phase=phase, dtype="bfloat16", per_call=rows, per_forward=tot))
    return tot


def phase_shipped(text):
    n = 65536
    rng = np.random.default_rng(1)
    coord, feat_in, grid = room_scene(rng, n, (3.0, 3.0, 3.0))
    backbone = dict(SHIPPED_INFERENCE_BACKBONE)
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    reset_k1_counts()
    feat, pred, plans, times = serve(
        model, dict(coord=coord, feat=feat_in, grid_coord=grid), text, reps=0)
    launches, variants = fwa.flash_window_attention.launches, k1_variants()
    enc, dec = depth_split(backbone)
    check(variants["bf16_large"] == enc and variants["bf16_small"] == dec,
          f"shipped: variant launches {variants}, expected {enc} bf16_large (windows of "
          f"1024) and {dec} bf16_small (windows of 48)")
    check_features(feat, n, "shipped")
    overflow = [int(p.n_overflow.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
    check(launches == 18, f"{launches} kernel launches, expected 18")
    sizes = [n] + [p.out_mask.shape[1] for p in plans]
    ragged = [s for s in sizes[:-1] if s % 48]
    check(len(ragged) == len(sizes) - 1, f"decoder stages {sizes[:-1]} not all ragged")
    emit(dict(phase="shipped", points=n, dec_window=48, stage_sizes=sizes,
              ragged_decoder_stages=ragged, extract_ms=times[0][0], kernel_launches=launches,
              variant_launches=variants,
              n_overflow=overflow, classes_predicted=int(len(np.unique(pred)))))
    return launches


def phase_agree(text):
    n = 49152
    rng = np.random.default_rng(2)
    coord, feat_in, grid = room_scene(rng, n, (3.0, 3.0, 3.0))
    sample = dict(coord=coord, feat=feat_in, grid_coord=grid)
    model_k = build_lang_model(FLAGSHIP_BACKBONE, dtype="float32", device="cuda", seed=1)
    model_p = build_model(dict(type="LangPretrainer", backbone=dict(
        FLAGSHIP_BACKBONE, dtype="float32", use_kernel=False))).to("cuda").eval()
    model_p.load_state_dict(model_k.state_dict(), strict=True)
    before = fwa.flash_window_attention.launches
    feat_k = FeatureExtractor(model_k, patch_size=1024, device="cuda")(sample)
    check(fwa.flash_window_attention.launches == before + 18, "kernel path not taken")
    feat_p = FeatureExtractor(model_p, patch_size=1024, device="cuda")(sample)
    check(fwa.flash_window_attention.launches == before + 18, "plain path launched")
    check_features(feat_k, n, "agree/kernel")
    pred_k, _ = zero_shot_predict(feat_k, text)
    pred_p, _ = zero_shot_predict(feat_p, text)
    diff = float(np.abs(feat_k - feat_p).max())
    same = float((pred_k == pred_p).mean())
    emit(dict(phase="agree", points=n, dtype="float32", max_abs_diff=diff,
              atol=AGREE_ATOL, argmax_agreement=same, min_agreement=AGREE_ARGMAX))
    check(diff <= AGREE_ATOL, f"kernel vs plain features differ by {diff}")
    check(same >= AGREE_ARGMAX, f"argmax agreement {same}")


def grads_of(fn, qkv, valid, k, h, dout):
    """(output, d output / d qkv) of ``fn`` for output gradient ``dout``."""
    x = qkv.detach().clone().requires_grad_(True)
    out = fn(x, valid, k, h)
    out.backward(dout)
    return out.detach(), x.grad


def phase_kernel_bwd():
    """Backward kernel vs autograd through the plain version at every
    signature; returns the fp32 max abs gradient error and that of the
    forward with log-sum-exp (the Function's forward)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, worst_fwd, rows = 0.0, 0.0, []
    for k, c, h, n_case in KERNEL_CASES:
        n, qkv, valid, dead = signature_inputs(gen, k, c, n=n_case)
        dout = torch.randn(2, n, c, generator=gen, device="cuda")
        out32, g32 = grads_of(fwa.flash_window_attention, qkv, valid, k, h, dout)
        ref_out, ref32 = grads_of(fwa.flash_window_attention_plain, qkv, valid, k, h, dout)
        torch.cuda.synchronize()
        check(torch.isfinite(g32).all().item(), f"non-finite gradient at {k, c, h}")
        err_fwd = (out32 - ref_out)[valid].abs().max().item()
        check(err_fwd <= FP32_ATOL, f"fp32 forward-with-lse error {err_fwd} at {k, c, h}")
        worst_fwd = max(worst_fwd, err_fwd)
        errs = [(g32[:, :, i] - ref32[:, :, i]).abs().max().item() for i in range(3)]
        scale = [ref32[:, :, i].abs().max().item() for i in range(3)]
        check((g32[dead] == 0).all().item(), f"padded windows' gradients not zero at {k, c, h}")

        x16, d16 = qkv.bfloat16(), dout.bfloat16()
        _, truth = grads_of(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                            d16.float())

        def rel(g):
            return ((g.float() - truth).norm() / truth.norm()).item()

        variant = fwa.backward_variant(x16.dtype, k, c // h)
        before = fwa.flash_window_attention_bwd.variant_launches[variant]
        g16 = grads_of(fwa.flash_window_attention, x16, valid, k, h, d16)[1]
        check(fwa.flash_window_attention_bwd.variant_launches[variant] == before + 1,
              f"the {variant} backward did not run at {k, c, h}")
        check((g16[dead] == 0).all().item(), f"bf16 padded windows' gradients not zero at "
              f"{k, c, h}")
        err16 = rel(g16)
        floor16 = rel(grads_of(fwa.flash_window_attention_plain, x16, valid, k, h, d16)[1])
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err_dq_dk_dv=errs,
                         fp32_max_abs_grad=scale, fp32_fwd_lse_max_abs_err=err_fwd,
                         bf16_variant=variant, bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        for name, e, m in zip(("dq", "dk", "dv"), errs, scale):
            check(e <= BWD_FP32_RTOL * m, f"fp32 {name} error {e} > {BWD_FP32_RTOL} x {m} "
                  f"at {k, c, h}")
        check_noise_floor(err16, floor16, "gradient", ("K, C, H", k, c, h))
        worst = max(worst, *errs)
    check({r["bf16_variant"] for r in rows} == {"bf16_small", "bf16_large"},
          "the signatures do not reach both bf16 backward variants")
    emit(dict(phase="kernel_bwd", fp32_rtol=BWD_FP32_RTOL,
              bf16_noise_factor=BF16_NOISE_FACTOR, cases=rows))
    return worst, worst_fwd


def shell_normals(grid, extent, thickness):
    """Unit normals of the voxels of a room's shell (room_scene's floor and
    walls, ``extent`` voxels a side): up on the floor, into the room on the
    walls."""
    normal = np.zeros((len(grid), 3), np.float32)
    for axis, sign, on in ((0, 1, grid[:, 0] < thickness),
                           (0, -1, grid[:, 0] >= extent[0] - thickness),
                           (1, 1, grid[:, 1] < thickness),
                           (1, -1, grid[:, 1] >= extent[1] - thickness),
                           (2, 1, grid[:, 2] < thickness)):
        normal[on] = 0
        normal[on, axis] = sign
    return normal


def write_gs_scenes(root, n_scenes, n, seed, size_m=(3.6, 3.6, 2.6), pc_points=0,
                    semseg=False):
    """``n_scenes`` synthetic 3DGS scenes of ``n`` unique 2 cm voxels on the
    4 cm thick floor and walls of a room of ``size_m`` metres (81% of its
    247,072 surface voxels at the default size), in the GS datasets'
    layout (root/scene/<asset>.npy): colour, opacity, quaternion, scale, 20
    classes by angle around the room's centre and height, 768-d fp16
    lang_feat (the class's unit embedding plus noise) and valid_feat_mask;
    with ``semseg`` the semseg files' assets instead of the last two:
    normals and the labels as ``segment20``. Dense shells keep the pooled
    stages inside their capacities after Mix3D merges two rooms and halves
    each one's density. With ``pc_points`` a scene also gets an evaluation
    point cloud (that many of its points, moved by a few millimetres, with
    their labels)."""
    rng = np.random.default_rng(seed)
    if not semseg:
        emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        noise = (0.05 * rng.standard_normal((n, LANG_DIM), dtype=np.float32))
    dirs = []
    for i in range(n_scenes):
        coord, _, grid = room_scene(rng, n, size_m, thickness=2)
        angle = np.arctan2(coord[:, 1] - size_m[1] / 2, coord[:, 0] - size_m[0] / 2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = (seg + 10 * (coord[:, 2] > 1.0)).astype(np.int16)
        scene = os.path.join(root, f"scene{i:04d}")
        os.makedirs(scene)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32))
        if semseg:
            extent = [int(round(m / GRID)) for m in size_m]
            assets.update(segment20=seg, normal=shell_normals(grid, extent, 2))
        else:
            assets.update(
                segment=seg, segment200=seg,
                lang_feat=(emb[seg] + np.roll(noise, i, axis=0)).astype(np.float16),
                valid_feat_mask=rng.random(n) > 0.1)
        if pc_points:
            pick = rng.choice(n, pc_points, replace=False)
            assets["pc_coord"] = (coord[pick] + rng.normal(0, 0.003, (pc_points, 3))
                                  ).astype(np.float32)
            assets["pc_segment"] = assets["pc_segment200"] = seg[pick].astype(np.int32)
        for key, value in assets.items():
            np.save(os.path.join(scene, f"{key}.npy"), value)
        dirs.append(scene)
    return dirs


def write_meta(meta_root):
    """The label files and torch ``.pt`` text tables the flagship config's
    evaluator hook and the test config name under SCENESPLAT_META_ROOT, cut
    from the port's built-in ScanNet200 table (its first 100 and 160 rows
    stand in for the ScanNet++ and Matterport tables)."""
    os.makedirs(meta_root)
    names = metadata.class_labels("scannet200")
    table = torch.from_numpy(metadata.text_embeddings("scannet200"))
    for labels, emb, rows in (
            ("scannetpp_top100_labels.txt", "scannetpp_top100_text_embeddings_siglip2.pt", 100),
            ("scannet200_labels.txt", "scannet200_text_embeddings_siglip2.pt", 200),
            ("matterport_nyu160_labels.txt", "matterport-nyu160_text_embeddings_siglip2.pt",
             160)):
        with open(os.path.join(meta_root, labels), "w") as f:
            f.write("\n".join(names[:rows]) + "\n")
        torch.save(table[:rows].clone(), os.path.join(meta_root, emb))


class StepProbe(HookBase):
    """CUDA-event time of every step, and a torch.profiler trace of step
    ``profile_step``."""

    def __init__(self, profile_step):
        self.profile_step = profile_step
        self.events, self.prof, self.profile = [], None, None

    def before_step(self):
        if self.trainer.storage.iter == self.profile_step:
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        self.events.append([start, None])

    def after_step(self):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.events[-1][1] = end
        if self.prof is not None:
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - self.t0) * 1e3
            self.prof.__exit__(None, None, None)
            kernels = device_kernels(self.prof)
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            # DDP's gradient all-reduce (NCCL's kernels, on a stream of their own)
            nccl = sum(e.self_device_time_total for e in kernels if "nccl" in e.key.lower())
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
            self.profile = dict(step=self.profile_step, wall_ms=wall_ms, device_busy_ms=busy,
                                idle_share=1 - busy / wall_ms, nccl_ms=nccl / 1e3,
                                top_kernels=[dict(name=e.key[:90], calls=e.count,
                                                  ms=e.self_device_time_total / 1e3)
                                             for e in top])
            self.prof = None

    def step_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def flagship_train_config(root, exp, batch_size):
    """The flagship config file as it is, its hooks included (the label and
    text-table files come from SCENESPLAT_META_ROOT), with the data roots,
    epoch 1 (so the contrastive term's last_75 gate is open) and the batch
    size set."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    for ds in list(cfg.data.train.datasets) + list(cfg.data.val):
        ds["data_root"] = root[ds["type"]]
    return cfg


def run_training(cfg, before=None):
    """Trains the config's epoch (``before(trainer)`` called first); returns
    the trainer, its probe, the per-step records of the training forward
    (pooling overflow, stage sizes and valid counts) and, read from K1's
    counter around every forward, the forwards and K1 launches of the train
    steps and of the hooks' validation and testing, with the largest
    pooling overflow of each of those forwards."""
    trainer = build_trainer(cfg, device="cuda")
    if before is not None:
        before(trainer)
    steps = len(trainer.train_loader)
    probe = StepProbe(profile_step=steps - 1)
    probe.trainer = trainer
    trainer.hooks.append(probe)
    records = []
    k1 = dict(train_forwards=0, train_launches=0, val_forwards=0, val_launches=0,
              train_variants=dict.fromkeys(fwa.VARIANTS, 0),
              val_variants=dict.fromkeys(fwa.VARIANTS, 0), val_overflow=[])
    forward = trainer.model.forward

    def recording_forward(point, generator=None):
        before, variants = fwa.flash_window_attention.launches, k1_variants()
        out = forward(point, generator=generator)
        mode = "train" if trainer.model.training else "val"
        k1[mode + "_forwards"] += 1
        k1[mode + "_launches"] += fwa.flash_window_attention.launches - before
        for v, n in k1_variants().items():
            k1[mode + "_variants"][v] += n - variants[v]
        if mode == "val":
            k1["val_overflow"].append(max((int(p.n_overflow.max()) for p in out.plans),
                                          default=0))
            return out
        records.append(dict(
            overflow=[p.n_overflow for p in out.plans],
            sizes=[(point.mask.shape[1], point.mask.sum(1))]
            + [(p.out_mask.shape[1], p.out_mask.sum(1)) for p in out.plans]))
        return out

    trainer.model.forward = recording_forward
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    return trainer, probe, records, k1


def write_flagship_data(tmp, scene_points=200000, room=(3.6, 3.6, 2.6), val_points=40000,
                        copies=1):
    """The flagship file's three training sets over 4 synthetic rooms (each
    listed ``copies`` times) and one small validation scene each, under
    ``tmp``; returns the data roots by dataset type and the seconds the
    writing took."""
    t0 = time.perf_counter()
    scenes = write_gs_scenes(os.path.join(tmp, "scenes"), 4, scene_points, seed=4,
                             size_m=room)
    (val_scene,) = write_gs_scenes(os.path.join(tmp, "val_scenes"), 1, val_points, seed=9,
                                   size_m=(2.4, 2.4, 2.0), pc_points=val_points // 4)
    # Matterport (loop 3): 4 scenes -> 3 batches; ScanNet++ (loop 2): 4
    # -> 2; ScanNet200 (loop 2): 2 -> 1 (Mix3D: 4 samples a batch). One
    # validation scene per dataset.
    root, splits = {}, {"Matterport3D_160_GSDataset": (
        "train_grid1.0cm_chunk6x6_stride3x3_filtered", 4,
        "test_grid1.0cm_chunk6x6_stride3x3_filtered"),
        "ScanNetPPGSDataset": ("train_grid1.0cm_chunk6x6_stride3x3", 4, "val"),
        "ScanNet200GSDataset": ("train_grid1.0cm_chunk6x6_stride3x3", 2, "val")}
    for name, (split, count, val_split) in splits.items():
        root[name] = os.path.join(tmp, name)
        os.makedirs(os.path.join(root[name], split))
        for copy in range(copies):
            for scene in scenes[:count]:
                os.symlink(scene, os.path.join(root[name], split,
                                               f"{os.path.basename(scene)}_{copy}"))
        os.makedirs(os.path.join(root[name], val_split))
        os.symlink(val_scene, os.path.join(root[name], val_split, "scene_val"))
    return root, time.perf_counter() - t0


def reset_k2_counts():
    fwa.flash_window_attention_bwd.launches = 0
    counts = fwa.flash_window_attention_bwd.variant_launches
    counts.update(dict.fromkeys(counts, 0))


def check_flagship_run(phase, trainer, probe, records, k1_counts):
    """What both flagship trainer phases hold of run_training's run (the
    counts reset just before it): at least 1 + 5 finite steps, K1 with lse
    and K2 once a block in every step's forward and backward, K1 without
    lse once a block in one validation forward per set (the encoder's on
    bf16_large, the decoder's windows of 48 on bf16_small), no pooling
    overflow, the file's own hooks' work done (each set's fg_mIoU logged
    once, model_last.pth and model_best.pth written, PreciseEvaluator with
    no tester). Returns the run's record."""
    backbone = trainer.cfg.model.backbone
    enc, dec = depth_split(backbone)
    blocks = enc + dec  # 18
    # K1 with lse: the launches counted inside the train steps' forwards;
    # the evaluator hook's validation forwards launch K1 without lse
    k1, k1_val = k1_counts["train_launches"], k1_counts["val_launches"]
    val_forwards = k1_counts["val_forwards"]
    k2 = fwa.flash_window_attention_bwd.launches
    k2_variants = dict(fwa.flash_window_attention_bwd.variant_launches)
    step_ms = probe.step_ms()
    hist = trainer.storage.history
    losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
    steps = len(losses)
    check(steps >= 6, f"{phase}: {steps} train steps, expected at least 1 + 5")
    check(all(math.isfinite(v) for v in losses + grad_norms),
          f"{phase}: non-finite loss or grad_norm: {losses} {grad_norms}")
    check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
          and k2 == blocks * steps,
          f"{phase}: {k1} forward and {k2} backward kernel launches in {steps} steps "
          f"({k1_counts['train_forwards']} forwards), expected {blocks} each per step")
    check(val_forwards == len(trainer.cfg.data.val) and k1_val == blocks * val_forwards,
          f"{phase}: {k1_val} kernel launches in {val_forwards} validation forwards, "
          f"expected {blocks} each, one forward per validation set")
    # bf16: the encoder's windows of 1024 take the large-window backward,
    # the decoder's windows of 48 the one-pass one
    check(k2_variants["bf16_small"] > 0 and k2_variants["bf16_large"] > 0
          and k2_variants["bf16_small"] + k2_variants["bf16_large"] == k2,
          f"{phase}: backward variant launches {k2_variants} of {k2}")
    check(fwa.flash_window_attention.launches == k1 + k1_val,
          f"{phase}: K1 launched {fwa.flash_window_attention.launches} times, {k1} + "
          f"{k1_val} of them inside a forward")
    # K1 in bf16: the encoder's windows of 1024 on the large-window
    # forward, the decoder's windows of 48 on the one-pass one
    for mode, forwards in (("train", steps), ("val", val_forwards)):
        got = {v: n for v, n in k1_counts[mode + "_variants"].items() if n}
        check(got == dict(bf16_large=enc * forwards, bf16_small=dec * forwards),
              f"{phase}: {mode} K1 variant launches {got} in {forwards} forwards, expected "
              f"{enc} bf16_large and {dec} bf16_small each")
    overflow = [int(max(int(o.max()) for o in r["overflow"])) for r in records]
    check(all(o == 0 for o in overflow), f"{phase}: pooling overflow {overflow}")
    model_dir = os.path.join(trainer.cfg.save_path, "model")
    check(os.path.exists(os.path.join(model_dir, "model_last.pth")),
          f"{phase}: no checkpoint written")
    # the file's own hooks: the evaluator logged each validation set's
    # fg_mIoU, the saver kept the best epoch, PreciseEvaluator had no tester
    val = {f"val{i}/{m}": hist(f"val{i}/{m}").values()
           for i in range(len(trainer.cfg.data.val)) for m in ("mIoU", "fg_mIoU")}
    check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in val.values()),
          f"{phase}: validation metrics not logged once per set: {val}")
    check(trainer.comm_info.get("current_metric_name") == "fg_mIoU",
          f"{phase}: the evaluator hook set no checkpoint metric")
    check(os.path.exists(os.path.join(model_dir, "model_best.pth")),
          f"{phase}: no model_best.pth")
    precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
    check(len(precise) == 1 and precise[0].results == [],
          f"{phase}: PreciseEvaluator ran a tester the config does not name")
    sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
    return dict(points=TRAIN_POINTS, steps=steps, loss=losses, grad_norm=grad_norms,
                lr=hist("lr").values(), cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                k1_launches=k1, k2_launches=k2, k2_variant_launches=k2_variants,
                k1_variant_launches=k1_counts["train_variants"],
                validation_forwards=val_forwards, validation_k1_launches=k1_val,
                validation_k1_variant_launches=k1_counts["val_variants"],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                n_overflow=overflow, stage_slots_valid=sizes[-1],
                validation={k: v[0] for k, v in val.items()},
                best_metric=trainer.comm_info.get("best_metric_value"),
                profile=probe.profile)


def phase_train(work):
    """The flagship trainer, its own hooks included, for 1 + 5 steps and one
    validation; returns the train-step stage shapes, the K1 / K2 launch
    counts, the best checkpoint, copied into ``work``, and the run's
    record."""
    with tempfile.TemporaryDirectory() as tmp:
        root, data_s = write_flagship_data(tmp)
        reset_k1_counts()
        reset_k2_counts()
        batch, oom, result = 2, None, None
        try:
            result = run_training(flagship_train_config(root, os.path.join(tmp, "exp"), batch))
        except torch.cuda.OutOfMemoryError as e:
            oom = dict(batch_size=batch, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                       error=str(e)[:600])
        if result is None:  # the reference's 2 per card did not fit: 1 per card
            gc.collect()
            torch.cuda.empty_cache()
            batch = 1
            reset_k1_counts()
            reset_k2_counts()
            result = run_training(flagship_train_config(root, os.path.join(tmp, "exp1"), batch))
        trainer, probe, records, k1_counts = result
        backbone = trainer.cfg.model.backbone
        record = check_flagship_run("train", trainer, probe, records, k1_counts)
        checkpoint = shutil.copy(os.path.join(trainer.cfg.save_path, "model", "model_best.pth"),
                                 os.path.join(work, "model_best.pth"))
        emit(dict(phase="train", batch_size=batch, oom=oom, dataset_write_s=data_s, **record))
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    k1_vars = dict(train=k1_counts["train_variants"], validation=k1_counts["val_variants"])
    return (shapes, record["k1_launches"], record["validation_k1_launches"], k1_vars,
            record["k2_variant_launches"], checkpoint, record)


def bwd_bound_ms(n, valids, k, c, h):
    """Least time of one bf16 backward call, as (ops_ms, bytes_ms,
    design_bytes_ms): 10 v^2 C operations per window of v valid slots (the
    five products, the recompute of S included) at the bf16 peak; the bytes
    of the function K2 replaces (qkv and dO of live windows and the mask
    read once, dqkv written once) at the memory rate; and those bytes plus
    what this design's backward also reads of live windows: lse, and O at
    windows above the one-pass variant's (delta from dO and O)."""
    ops, rows_live = 0, 0
    for nv in valids:
        for w0 in range(0, n, k):
            v = max(0, min(nv, w0 + k) - w0)
            ops += 10 * v * v * c
            rows_live += min(k, n - w0) if v else 0
    nbytes = rows_live * (2 * 3 * c + 2 * c) + len(valids) * n * (2 * 3 * c + 1)
    design = nbytes + rows_live * ((2 * c if k > fwa.BWD_SMALL_MAX else 0) + 4 * h)
    return (ops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3,
            design / PEAK_BYTES * 1e3)


def fwd_lse_bound_ms(n, valids, k, c, h):
    """Least time of one bf16 forward with log-sum-exp, as (ops_ms,
    bytes_ms): ``bound_ms`` of each batch row, plus the fp32 lse written."""
    ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
    return ops_ms, bytes_ms + len(valids) * n * 4 * h / PEAK_BYTES * 1e3


def backward_ms(make_out, x_list, dout, reps):
    """Device time of the backward alone: a fresh forward per rep outside the
    timed span, CUDA events around torch.autograd.grad. Returns the time and
    the last rep's gradients."""
    total = 0.0
    for i in range(reps + 1):
        out = make_out()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        grads = torch.autograd.grad(out, x_list, dout)
        end.record()
        torch.cuda.synchronize()
        if i:  # the first is a warm-up
            total += start.elapsed_time(end)
        del out
    return total / reps, grads


def phase_timing_bwd(shapes, phase="timing_bwd"):
    """At the train step's shapes, (N, valid counts, K, C, H, forward
    launches a step[, backward launches a step]): the forward with
    log-sum-exp and the backward kernel against the plain version under the
    bf16 noise-floor rule (gradients against autograd through the plain
    version run in fp32), with zero output and gradients in windows whose
    slot 0 is padding; then each kernel's time per call and per step against
    the plain version, the library call and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               design_bytes_ms=0.0, fwd_lse_ms=0.0, fwd_plain_ms=0.0,
               fwd_library_ms=0.0, fwd_ops_ms=0.0, fwd_bytes_ms=0.0)
    fwd_keys = ("fwd_lse_ms", "fwd_plain_ms", "fwd_library_ms", "fwd_ops_ms", "fwd_bytes_ms")
    by_variant = {}  # the forward's per-step sums for each of its variants
    # what the autograd Function keeps beyond the JAX package's residuals
    # (qkv, valid): the bf16 output and the fp32 log-sum-exp of every call
    shapes = [tuple(sh) + (sh[5],) * (7 - len(sh)) for sh in shapes]
    saved_gib = sum(count * len(valids) * n * (2 * c + 4 * h)
                    for n, valids, k, c, h, count, _ in shapes) / 2 ** 30
    for n, valids, k, c, h, count, bwd_count in shapes:
        b, d, scale = len(valids), c // h, (c // h) ** -0.5
        shape = ("N, valid, K, C, H", n, valids, k, c, h)
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
        dout = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        dead = torch.zeros_like(valid)
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
            dead[i, -(-nv // k) * k:] = True
        out, lse = fwa._launch_fwd(qkv, valid, k, h, scale, True)
        dqkv = fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h, scale)
        torch.cuda.synchronize()
        check(torch.isfinite(dqkv).all().item(), f"non-finite gradient at {shape}")
        check((out[dead] == 0).all().item() and (dqkv[dead] == 0).all().item(),
              f"padded windows' output or gradients not zero at {shape}")
        fwd_err, fwd_floor = check_bf16(qkv, valid, k, h, out=out)

        fwd_ms = cuda_ms(lambda: fwa._launch_fwd(qkv, valid, k, h, scale, True), reps=10)
        fwd_plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                               reps=2, warmup=1)
        ms = cuda_ms(lambda: fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h,
                                                            scale), reps=10)
        x = qkv.detach().clone().requires_grad_(True)
        plain_ms, (g_plain,) = backward_ms(
            lambda: fwa.flash_window_attention_plain(x, valid, k, h), [x], dout, reps=2)
        chunk = max(8, 16384 // k)  # windows per plain chunk: the result is the same
        _, truth = grads_of(
            lambda t, m, kk, hh: fwa.flash_window_attention_plain(t, m, kk, hh,
                                                                  patch_chunk=chunk),
            qkv.float(), valid, k, h, dout.float())

        def rel(g):
            return ((g.float() - truth).norm() / truth.norm()).item()

        err16, floor16 = rel(dqkv), rel(g_plain)
        check_noise_floor(err16, floor16, "gradient", shape)
        del truth, g_plain, x

        p = -(-n // k)
        pad = p * k - n
        qkv_w = torch.cat([qkv, qkv.new_zeros(b, pad, 3, c)], 1) if pad else qkv
        valid_w = torch.cat([valid, valid.new_zeros(b, pad)], 1) if pad else valid
        q, kk, v = [t.detach().requires_grad_(True) for t in
                    qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()]
        mask = valid_w.view(b * p, 1, 1, k)
        dout_w = (torch.cat([dout, dout.new_zeros(b, pad, c)], 1) if pad else dout)
        dout_w = dout_w.view(b * p, k, h, d).transpose(1, 2).contiguous()

        def library():
            return torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=mask)

        with torch.no_grad():
            fwd_lib_ms = cuda_ms(library, reps=10)
        lib_ms, _ = backward_ms(library, [q, kk, v], dout_w, reps=5)
        ops_ms, bytes_ms, design_bytes_ms = bwd_bound_ms(n, valids, k, c, h)
        fwd_ops_ms, fwd_bytes_ms = fwd_lse_bound_ms(n, valids, k, c, h)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms, design_bytes_ms=design_bytes_ms, fwd_lse_ms=fwd_ms,
                   fwd_plain_ms=fwd_plain_ms, fwd_library_ms=fwd_lib_ms,
                   fwd_ops_ms=fwd_ops_ms, fwd_bytes_ms=fwd_bytes_ms)
        fwd_variant = fwa.forward_variant(qkv.dtype, k, d)
        rows.append(dict(N=n, B=b, valid=valids, K=k, C=c, H=h, launches=count,
                         bwd_launches=bwd_count,
                         variant=fwa.backward_variant(qkv.dtype, k, d),
                         fwd_variant=fwd_variant, **row,
                         bound_ms=max(ops_ms, bytes_ms),
                         fwd_bound_ms=max(fwd_ops_ms, fwd_bytes_ms),
                         bf16_grad_rel_err=err16, bf16_grad_plain_rel_err=floor16,
                         bf16_fwd_lse_rel_err=fwd_err, bf16_fwd_plain_rel_err=fwd_floor))
        for key, val in row.items():
            tot[key] += (count if key.startswith("fwd_") else bwd_count) * val
        part = by_variant.setdefault(fwd_variant, dict.fromkeys(fwd_keys, 0.0))
        for key in fwd_keys:
            part[key] += count * row[key]
        del qkv, dout, out, lse, dqkv, q, kk, v, qkv_w, dout_w
        torch.cuda.empty_cache()
    for pre in ("", "fwd_"):
        ops_ms, bytes_ms = tot[pre + "ops_ms"], tot[pre + "bytes_ms"]
        tot[pre + "bound_ms"] = max(ops_ms, bytes_ms)
        tot[pre + "bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    tot["design_bound_ms"] = max(tot["ops_ms"], tot["design_bytes_ms"])
    for part in by_variant.values():
        part["fwd_bound_ms"] = max(part["fwd_ops_ms"], part["fwd_bytes_ms"])
        part["fwd_bound_by"] = ("operations" if part["fwd_ops_ms"] >= part["fwd_bytes_ms"]
                                else "bytes")
    tot["fwd_by_variant"] = by_variant
    emit(dict(phase=phase, dtype="bfloat16", bf16_noise_factor=BF16_NOISE_FACTOR,
              per_call=rows, per_step=tot, saved_out_lse_gib=saved_gib,
              worst_bf16_grad_ratio=max(r["bf16_grad_rel_err"] / r["bf16_grad_plain_rel_err"]
                                        for r in rows),
              worst_bf16_fwd_lse_ratio=max(r["bf16_fwd_lse_rel_err"]
                                           / r["bf16_fwd_plain_rel_err"] for r in rows)))
    return tot


def compare_train_steps(phase, step, blocks, **record):
    """``step(use_kernel)`` -> (loss, or the loss terms with the composed
    one under "loss", gradients by name, pooling overflow of each stage)
    runs one train step from fixed weights and generator seeds; it runs
    with the kernels (``blocks`` K1 and K2 launches, or a pair of counts
    (K1, K2)) and with the plain attention (none); compare_steps holds the
    two. Emits ``phase`` with ``record``."""
    before = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    kernel = step(None)
    after = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    k1, k2 = blocks if isinstance(blocks, tuple) else (blocks, blocks)
    check(after == (before[0] + k1, before[1] + k2),
          f"{phase}: kernel path not taken: {before} {after}, expected {k1} and {k2} more")
    plain = step(False)
    check((fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
          == after, f"{phase}: plain path launched a kernel")
    compare_steps(phase, kernel, plain, **record)


def compare_steps(phase, got, ref, names=("kernel", "plain"), **record):
    """Holds one train step's (loss or loss terms, gradients by name, pooling
    overflow) ``got`` to ``ref``: the losses to TRAIN_LOSS_RTOL (each
    term's difference is recorded) and each gradient to TRAIN_GRAD_RTOL of
    its own norm (or both zero, see ZERO_GRAD), the whole gradient too; no
    stage may overflow. Gradients named ``<term>/<parameter>`` are one loss
    term's: each term is its own whole gradient. Emits ``phase`` with
    ``record``, the two losses under loss_<names>."""
    loss_k, grads_k, overflow_k = got
    loss_p, grads_p, overflow_p = ref
    term = {name: name.split("/")[0] if "/" in name else "" for name in grads_p}
    total = {t: torch.linalg.vector_norm(torch.stack(
        [g.norm() for name, g in grads_p.items() if term[name] == t])).item()
        for t in set(term.values())}
    worst, zero, by_share, diff_sq = 0.0, [], {}, dict.fromkeys(total, 0.0)
    check(sorted(grads_k) == sorted(grads_p), f"{phase}: gradients of other parameters")
    for name, gp in grads_p.items():
        gk, whole = grads_k[name], total[term[name]]
        check(torch.isfinite(gk).all().item(), f"{phase}: non-finite gradient {name}")
        norm, diff = gp.norm().item(), (gk - gp).norm().item()
        diff_sq[term[name]] += diff ** 2
        # per decade of the tensor's share of its whole gradient's norm: how
        # many tensors, and their worst error relative to their own norm
        decade = f"1e{math.floor(math.log10(norm / whole))}" if norm else "0"
        count, own = by_share.get(decade, (0, 0.0))
        by_share[decade] = (count + 1, max(own, diff / norm if norm else diff))
        if norm < ZERO_GRAD * whole:
            zero.append(name)
            check(gk.norm().item() < ZERO_GRAD * whole,
                  f"{phase}: gradient of {name} is zero on the {names[1]} path only")
            continue
        worst = max(worst, diff / norm)
        check(diff / norm <= TRAIN_GRAD_RTOL,
              f"{phase}: gradient of {name} differs by {diff / norm} (relative L2)")
    losses_k, losses_p = (loss_k, loss_p) if isinstance(loss_p, dict) else (
        dict(loss=loss_k), dict(loss=loss_p))
    loss_rel = {k: abs(losses_k[k] - v) / abs(v) for k, v in losses_p.items()}
    whole_rel = {t: math.sqrt(diff_sq[t]) / total[t] for t in total}
    emit(dict(phase=phase, dtype="float32", **record, n_overflow=[overflow_k, overflow_p],
              **{f"loss_{names[0]}": loss_k, f"loss_{names[1]}": loss_p},
              loss_rel_diff=loss_rel["loss"], term_rel_diff=loss_rel,
              loss_rtol=TRAIN_LOSS_RTOL, grad_tensors=len(grads_p), worst_grad_rel_l2=worst,
              grad_rtol=TRAIN_GRAD_RTOL, zero_grad_tensors=zero,
              global_grad_norm=total[""] if "" in total else total,
              global_grad_rel_l2=whole_rel[""] if "" in whole_rel else whole_rel,
              worst_own_rel_l2_by_share=dict(sorted(by_share.items()))))
    check(loss_rel["loss"] <= TRAIN_LOSS_RTOL,
          f"{phase}: losses differ by {loss_rel['loss']} relative")
    check(max(whole_rel.values()) <= TRAIN_GRAD_RTOL,
          f"{phase}: the whole gradient differs by {whole_rel}")
    check(not any(overflow_k + overflow_p), f"{phase}: pooling overflow {overflow_k}")


def agree_rows(n, seeds):
    """One batch row of ``n`` points per seed: a room small enough that its
    4 cm cells fit the first pooling's capacity (a 3 m room's 24,891 would
    overflow 0.5 x 49,152), 20 classes by angle and height, 768-d fp16
    lang_feat (a unit embedding per class plus noise) and valid_feat_mask;
    numpy arrays [rows, n, ...]."""
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coord, feat_in, grid = room_scene(rng, n, (2.4, 2.4, 2.4))
        angle = np.arctan2(coord[:, 1] - 1.2, coord[:, 0] - 1.2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = seg + 10 * (coord[:, 2] > 1.0)
        emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)  # SigLIP2 features are unit rows
        lang = emb[seg] + 0.05 * rng.normal(size=(n, LANG_DIM)).astype(np.float32)
        rows.append(dict(coord=coord, feat=feat_in, grid_coord=grid, mask=np.ones(n, bool),
                         segment=seg, lang_feat=lang.astype(np.float16),
                         valid_feat_mask=rng.random(n) > 0.1))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def cuda_batch(rows):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in rows.items()}


def flagship_fp32_model(**backbone):
    """The flagship config file's LangPretrainer in fp32 from seed 1, on the
    card in train mode, and the file's criteria."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    model = build_model(dict(type="LangPretrainer", backbone=dict(
        cfg.model.backbone, dtype="float32", seed=1, **backbone)))
    return model.cuda().train(), build_criteria(cfg.model.criteria)


def phase_train_agree(n=49152):
    """One fp32 train step of the flagship config file's model (decoder
    windows of 48, ragged) at ``n`` points with the kernels and one with the
    plain attention, from the same weights and generator seeds."""
    backbone = dict(Config.fromfile(FLAGSHIP_CONFIG).model.backbone)
    batch = cuda_batch(agree_rows(n, (7,)))

    def step(use_kernel):
        model, criteria = flagship_fp32_model(use_kernel=use_kernel)
        gen = torch.Generator(device="cuda").manual_seed(11)
        loss, out = lang_loss(model, criteria, batch, gen, epoch_progress=1.0)
        loss.backward()
        return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                [int(p.n_overflow.max()) for p in out.plans])

    compare_train_steps("train_agree", step, sum(depth_split(backbone)), points=n,
                        dec_patch_size=backbone.get("dec_patch_size", "default (48)"))


# ---- data parallel ---------------------------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def torchrun_env(rank, world, port, local_rank=0):
    """The environment torchrun gives a process, for the block (the ranks
    that share the one card all have LOCAL_RANK 0)."""
    env = dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    os.environ.update(env)
    try:
        yield
    finally:
        for key in env:
            os.environ.pop(key, None)


def train_step_fp32(batch, wrap=lambda m: m, build=flagship_fp32_model, task="lang", seed=11,
                    **backbone):
    """One train_step of task ``task`` of ``build(**backbone)``'s fp32 model
    (the flagship file's by default; drop-path 0.3, the curve shuffle and
    the contrastive split drawn from a generator seeded ``seed``; SGD at lr
    0, so the step leaves the weights) on ``batch``, the model wrapped by
    ``wrap``. Returns (loss, grad_norm, gradients and BatchNorm running
    statistics by name, each stage's pooling overflow)."""
    model, criteria = build(**backbone)
    overflow, forward = [], model.forward

    def recording(point, generator=None):
        out = forward(point, generator=generator)
        overflow.extend(int(p.n_overflow.max()) for p in out.plans)
        return out

    model.forward = recording
    metrics = train_step(wrap(model), criteria, torch.optim.SGD(model.parameters(), lr=0.0),
                         None, batch, generator=torch.Generator(device="cuda").manual_seed(seed),
                         epoch_progress=1.0, task=task)
    stats = {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return (metrics["loss"].item(), metrics["grad_norm"].item(),
            {k: p.grad for k, p in model.named_parameters()}, stats, overflow)


def phase_ddp_train(work, plain, n_agree=49152):
    """The flagship trainer as phase_train runs it (its data, batch 2, 1 + 5
    steps, its own hooks with the evaluator on the scene-sharded path),
    under a one-process NCCL group, so through DistributedDataParallel,
    beside phase_train's plain trainer; then one fp32 step at ``n_agree``
    points under DDP against the same step without it. Returns the run's
    record and its best checkpoint, copied into ``work``."""
    with torchrun_env(0, 1, free_port()), process_group("cuda"):
        check(torch.distributed.get_backend() == "nccl" and world() == 1,
              "ddp_train: no one-process NCCL group")
        with tempfile.TemporaryDirectory() as tmp:
            root, data_s = write_flagship_data(tmp)
            reset_k1_counts()
            reset_k2_counts()
            trainer, probe, records, k1_counts = run_training(
                flagship_train_config(root, os.path.join(tmp, "exp"), 2))
            check(isinstance(trainer.train_model, torch.nn.parallel.DistributedDataParallel),
                  "ddp_train: the trainer's step does not run under DDP")
            record = check_flagship_run("ddp_train", trainer, probe, records, k1_counts)
            best = os.path.join(trainer.cfg.save_path, "model", "model_best.pth")
            state = torch.load(best, map_location="cpu", weights_only=False)["state_dict"]
            check(not any(k.startswith("module.") for k in state),
                  "ddp_train: the checkpoint holds DDP's names")
            model_cfg = dict(trainer.cfg.model)
            model_cfg.pop("criteria")
            build_model(model_cfg).load_state_dict(state, strict=True)
            checkpoint = shutil.copy(best, os.path.join(work, "ddp_model_best.pth"))
            del trainer
        torch.cuda.empty_cache()
        warm, plain_warm = (float(np.mean(r["warm_step_ms"])) for r in (record, plain))
        emit(dict(phase="ddp_train", world=1, backend="nccl", batch_size=2,
                  dataset_write_s=data_s, **record, warm_step_ms_mean=warm,
                  plain=dict({k: plain[k] for k in (
                      "steps", "loss", "cold_step_ms", "warm_step_ms", "data_wait_s",
                      "peak_mem_gib")}, warm_step_ms_mean=plain_warm),
                  ddp_over_plain_warm_step=warm / plain_warm))

        batch = cuda_batch(agree_rows(n_agree, (7,)))
        loss, norm, grads, _, overflow = train_step_fp32(
            batch, data_parallel)
        got = (loss, grads, overflow)
        loss, plain_norm, grads, _, overflow = train_step_fp32(batch)
        compare_steps("ddp_train_agree", got, (loss, grads, overflow), names=("ddp", "plain"),
                      points=n_agree, world=1, backend="nccl", grad_norm=[norm, plain_norm])
        check(abs(norm - plain_norm) <= TRAIN_GRAD_RTOL * plain_norm,
              f"ddp_train_agree: gradient norms {norm} and {plain_norm}")
    return record, checkpoint


def rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm().clamp(min=1e-30)).item()


def spawn_ranks(target, world, job_file, timeout_s=600):
    """Runs ``target(rank, world, port, job_file)`` in ``world`` spawned
    processes and waits for them (killed past ``timeout_s``); fails unless
    every one exits 0. Returns the seconds they took."""
    ctx = mp.get_context("spawn")
    port = free_port()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, world, port, job_file)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f"{target.__name__}: rank exit codes {[p.exitcode for p in procs]}")
    return time.perf_counter() - t0


def ddp_agree_rank(rank, world, port, job_file):
    """One rank of phase_ddp_agree (a spawned process): its row of the
    global batch through the fp32 step under DDP, then the zero-shot test
    entry on its share of the scenes; writes what it saw, with its K1 and
    K2 launches, to the job's ``out`` file. On one card the ranks share it
    over gloo, on CUDA tensors (NCCL refuses two ranks on one card); on
    several, each has its own over NCCL."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    cards = job["cards"]
    with torchrun_env(rank, world, port, local_rank=rank if cards > 1 else 0):
        init_distributed("cuda", backend="nccl" if cards > 1 else "gloo")
        try:
            reset_k1_counts()
            reset_k2_counts()
            rows = {k: v[local_batch_slice(len(v))] for k, v in job["rows"].items()}
            loss, norm, grads, stats, overflow = train_step_fp32(cuda_batch(rows),
                                                                  data_parallel)
            out = dict(loss=loss, grad_norm=norm, overflow=overflow,
                       grads={k: g.cpu() for k, g in grads.items()},
                       stats={k: v.cpu() for k, v in stats.items()},
                       k1_step=fwa.flash_window_attention.launches,
                       k1_step_variants=k1_lse_variants(),
                       k2_step=fwa.flash_window_attention_bwd.launches,
                       k2_step_variants=dict(fwa.flash_window_attention_bwd.variant_launches))
            del grads
            gc.collect()
            torch.cuda.empty_cache()
            reset_k1_counts()
            torch.use_deterministic_algorithms(True, warn_only=True)
            (out["test"],) = test_entry.main(job["test_argv"])
            out.update(k1_test=fwa.flash_window_attention.launches, k1_test_variants=k1_variants())
            torch.save(out, job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


def phase_ddp_agree(work, checkpoint, meta_root, n=49152, n_voxels=20000, world=2, cards=1):
    """``world`` ranks (one row each) against one process on the first
    card: the fp32 step of a global batch of ``world`` rows of ``n`` points
    (drop-path 0.3, the contrastive term on) and the zero-shot test entry
    over 3 scenes with ``checkpoint`` (at 4 ranks one draws no scene). The
    ranks share the one card over gloo, or with ``cards`` > 1 each has a
    card over NCCL. Returns the ranks' K1 and K2 launches."""
    phase = "ddp_agree" if cards == 1 else "ddp_cards_agree"
    backend = "gloo" if cards == 1 else "nccl"
    rows = agree_rows(n, tuple(range(7, 7 + world)))
    loss, norm, grads, stats, overflow = train_step_fp32(cuda_batch(rows))
    ref = (loss, {k: g.cpu() for k, g in grads.items()}, overflow)
    del grads
    gc.collect()
    torch.cuda.empty_cache()

    data_root = os.path.join(work, f"{phase}_scenes")
    n_points = write_test_scenes(data_root, 3, n_voxels, seed=21, pc_points=n_voxels // 2)
    cfg_file = os.path.join(work, f"{phase}_test.py")
    with open(cfg_file, "w") as f:
        f.write(TEST_CONFIG.format(flagship=os.path.abspath(FLAGSHIP_CONFIG),
                                   pipelines=os.path.abspath(PIPELINES),
                                   data_root=data_root, meta_root=meta_root))
    argv = ["--config-file", cfg_file, "--options", f"weight={checkpoint}", "bitonic_sort=False"]
    one_dir, two_dir = (os.path.join(work, f"{phase}_{name}") for name in ("one", "ranks"))
    # the pooling's scatter-adds in one order in every run (see run_test_entry)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_k1_counts()
        (one,) = test_entry.main(argv + [f"test.save_path={one_dir}"])
        k1_one = fwa.flash_window_attention.launches
    finally:
        torch.use_deterministic_algorithms(False)

    job_file = os.path.join(work, f"{phase}_job.pt")
    torch.save(dict(rows=rows, test_argv=argv + [f"test.save_path={two_dir}"], cards=cards,
                    out=os.path.join(work, f"{phase}_rank{{rank}}.pt")), job_file)
    ranks_s = spawn_ranks(ddp_agree_rank, world, job_file)
    ranks = [torch.load(os.path.join(work, f"{phase}_rank{r}.pt"), weights_only=False)
             for r in range(world)]

    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    for r, got in enumerate(ranks):
        compare_steps(f"{phase}_rank{r}", (got["loss"], got["grads"], got["overflow"]), ref,
                      names=("ranks", "one"), points=n, rows=world, world=world,
                      backend=backend, grad_norm=[got["grad_norm"], norm])
        check(abs(got["grad_norm"] - norm) <= TRAIN_GRAD_RTOL * norm,
              f"{phase}: rank {r}'s gradient norm {got['grad_norm']} against {norm}")
        stat_err = {k: rel_l2(v, stats[k].cpu()) for k, v in got["stats"].items()}
        check(sorted(stat_err) == sorted(stats) and max(stat_err.values()) <= TRAIN_GRAD_RTOL,
              f"{phase}: rank {r}'s BatchNorm statistics differ by {max(stat_err.values())}")
        check(got["k1_step"] == got["k2_step"] == blocks,
              f"{phase}: rank {r} launched K1 {got['k1_step']} and K2 {got['k2_step']} "
              f"times in its step, expected {blocks}")
        got["stat_worst_rel_l2"] = max(stat_err.values())
        for key, g in ranks[0]["grads"].items():
            check(torch.equal(g, got["grads"][key]), f"{phase}: rank {r}'s {key} gradient "
                  "differs from rank 0's")

    one_preds = {f: np.load(os.path.join(one_dir, f)) for f in os.listdir(one_dir)
                 if f.endswith("_pred.npy")}
    two_preds = {f: np.load(os.path.join(two_dir, f)) for f in os.listdir(two_dir)
                 if f.endswith("_pred.npy")}
    check(len(one_preds) == 3 and sorted(one_preds) == sorted(two_preds),
          f"{phase}: scenes {sorted(one_preds)} and {sorted(two_preds)}")
    for name, pred in one_preds.items():
        check(np.array_equal(pred, two_preds[name]), f"{phase}: {name} predictions differ")
    for r, got in enumerate(ranks):
        check(sorted(got["test"]) == sorted(one) and all(
            np.array_equal(got["test"][k], one[k]) for k in one),
              f"{phase}: rank {r}'s test metrics differ from one process's")
        check((got["k1_test"] > 0) == (r < 3), f"{phase}: rank {r} launched K1 "
              f"{got['k1_test']} times in testing (3 scenes round-robin)")
    k1_test = sum(got["k1_test"] for got in ranks)
    check(k1_test == k1_one, f"{phase}: the ranks launched K1 "
          f"{[got['k1_test'] for got in ranks]} times in testing, one process {k1_one}")
    with open(os.path.join(two_dir, "scene_log.json")) as f:
        check(len(json.load(f)) == 3, f"{phase}: rank 0's scene log lacks scenes")
    emit(dict(phase=phase, world=world, backend=backend, cards=cards, points=n, rows=world,
              dtype="float32", drop_path=0.3, loss=[got["loss"] for got in ranks],
              loss_one=loss, grad_norm=[got["grad_norm"] for got in ranks], grad_norm_one=norm,
              stat_worst_rel_l2=[got["stat_worst_rel_l2"] for got in ranks],
              stat_tensors=len(stats), ranks_s=ranks_s,
              k1_step=[got["k1_step"] for got in ranks],
              k2_step=[got["k2_step"] for got in ranks],
              test_scenes=3, test_points_per_scene=n_points,
              test_metrics={k: one[k] for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")},
              test_metrics_equal=True, predictions_equal=True,
              k1_test=[got["k1_test"] for got in ranks], k1_test_one_process=k1_one))
    return dict(k1_lse=sum(got["k1_step"] for got in ranks),
                k2=sum(got["k2_step"] for got in ranks), k1_test=k1_test,
                k1_lse_variants=sum_counts(got["k1_step_variants"] for got in ranks),
                k2_variants=sum_counts(got["k2_step_variants"] for got in ranks),
                k1_test_variants=sum_counts(got["k1_test_variants"] for got in ranks))


def ddp_train_rank(rank, world, port, job_file):
    """One rank of phase_ddp_cards_train (a spawned process, its own card,
    NCCL): the flagship trainer at the job's global batch; writes its
    per-step losses, gradient norms, step times, loader waits, peak memory,
    K1 / K2 launches, pooling overflow, validation and profile."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda")
        try:
            reset_k1_counts()
            reset_k2_counts()
            trainer, probe, records, k1_counts = run_training(flagship_train_config(
                job["root"], job["exp"], job["batch_size"]))
            hist = trainer.storage.history
            step_ms = probe.step_ms()
            torch.save(dict(
                loss=hist("loss").values(), grad_norm=hist("grad_norm").values(),
                data_wait_s=hist("data_time").values(), cold_step_ms=step_ms[0],
                warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                k1=k1_counts["train_launches"], k1_val=k1_counts["val_launches"],
                val_forwards=k1_counts["val_forwards"],
                k2=fwa.flash_window_attention_bwd.launches,
                overflow=[int(max(int(o.max()) for o in r["overflow"])) for r in records],
                validation={k: hist(k).values() for k in ("val0/fg_mIoU", "val/fg_mIoU")},
                profile=probe.profile, train_steps=len(trainer.train_loader)),
                job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


def phase_ddp_cards_train(work, cards):
    """The flagship file as it ships it: its global batch of 8, 2 rows a
    card on ``cards`` cards, each rank a spawned process on its own card
    over NCCL, at 196,608 points over the train phase's rooms (each listed
    4 times, so that every dataset fills batches of 16 Mix3D samples), for
    its steps of one epoch and one sharded validation. Every rank holds the
    same loss and gradient norm at every step, K1 and K2 launch once a block
    a step, rank 0 alone writes the checkpoint. Each rank's pooling
    overflow is recorded, not refused: with 16 Mix3D samples a batch some
    rank draws a pair of augmented rooms whose 4 cm clusters overflow the
    file's first capacity (497 over 98,304 in one run), as one card would
    with these draws."""
    with tempfile.TemporaryDirectory() as tmp:
        root, data_s = write_flagship_data(tmp, copies=4)
        exp = os.path.join(tmp, "exp")
        job_file = os.path.join(work, "ddp_cards_train_job.pt")
        torch.save(dict(root=root, exp=exp, batch_size=2 * cards,
                        out=os.path.join(work, "ddp_cards_train_rank{rank}.pt")), job_file)
        ranks_s = spawn_ranks(ddp_train_rank, cards, job_file, timeout_s=900)
        ranks = [torch.load(os.path.join(work, f"ddp_cards_train_rank{r}.pt"),
                            weights_only=False) for r in range(cards)]
        best = os.path.join(exp, "model", "model_best.pth")
        check(os.path.exists(best), "ddp_cards_train: no checkpoint")
        checkpoint = shutil.copy(best, os.path.join(work, "ddp_cards_model_best.pth"))
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    steps = len(ranks[0]["loss"])
    emit(dict(phase="ddp_cards_train", world=cards, backend="nccl", batch_size=2 * cards,
              rows_per_card=2, points=TRAIN_POINTS, steps=steps, dataset_write_s=data_s,
              ranks_s=ranks_s, loss=ranks[0]["loss"], grad_norm=ranks[0]["grad_norm"],
              validation=ranks[0]["validation"],
              per_rank=[dict({k: got[k] for k in (
                  "cold_step_ms", "warm_step_ms", "profiled_step_ms", "data_wait_s",
                  "peak_mem_gib", "k1", "k1_val", "val_forwards", "k2", "overflow")},
                  profile={k: v for k, v in (got["profile"] or {}).items()
                           if k != "top_kernels"}) for got in ranks]))
    check(steps >= 6, f"ddp_cards_train: {steps} steps")
    for r, got in enumerate(ranks):
        check(got["loss"] == ranks[0]["loss"] and got["grad_norm"] == ranks[0]["grad_norm"],
              f"ddp_cards_train: rank {r}'s losses {got['loss']} against rank 0's")
        check(all(math.isfinite(v) for v in got["loss"] + got["grad_norm"]),
              f"ddp_cards_train: rank {r}: non-finite losses")
        check(got["k1"] == got["k2"] == blocks * steps,
              f"ddp_cards_train: rank {r} launched K1 {got['k1']} and K2 {got['k2']} times "
              f"in {steps} steps")
        check(got["validation"] == ranks[0]["validation"],
              f"ddp_cards_train: rank {r}'s validation differs from rank 0's")
    return dict(k1_lse=sum(got["k1"] for got in ranks), k2=sum(got["k2"] for got in ranks),
                k1_val=sum(got["k1_val"] for got in ranks)), checkpoint


# the semseg and SSL files' global batches, and whether their runs on
# ``--cards`` cards recompute the blocks (remat_blocks): cards_fit on an
# H100 80GB (700 W) held 8 semseg and 4 SSL rows a card without it, 12
# and 6 with it, so the files' 12 and 6 rows a card on 4 cards need it
CARDS_TASKS = dict(semseg=(SEMSEG_CONFIG, 48), ssl=(SSL_CONFIG, 24))
CARDS_REMAT = dict(semseg=True, ssl=True)
CARDS_STEPS = 4


def task_train_config(task, root, exp, batch_size, steps, remat):
    """The task's file as semseg_train / ssl_train read it, at
    ``batch_size`` for ``steps`` steps over 4 rooms, ``remat_blocks`` as
    given, with the timer and the writer for hooks only (no evaluation, no
    checkpoint: a run of steps)."""
    make = semseg_train_config if task == "semseg" else ssl_train_config
    cfg = make(root, exp, batch_size, steps, 4)
    cfg.model.backbone["remat_blocks"] = remat
    cfg.hooks = [h for h in cfg.hooks if h["type"] in ("IterationTimer", "InformationWriter")]
    return cfg


def run_task_steps(task, cfg):
    """Trains ``cfg``'s steps on the card (under DDP in a group) with a
    StepProbe that profiles the last step; returns the run's record."""
    reset_k1_counts()
    reset_k2_counts()
    trainer = build_trainer(cfg, device="cuda")
    probe = StepProbe(profile_step=len(trainer.train_loader) - 1)
    probe.trainer = trainer
    trainer.hooks.append(probe)
    torch.cuda.reset_peak_memory_stats()
    trainer.train()
    hist = trainer.storage.history
    step_ms = probe.step_ms()
    record = dict(task=task, world=trainer.world, batch_size=cfg.batch_size,
                  rows_per_card=cfg.batch_size // trainer.world,
                  remat_blocks=cfg.model.backbone["remat_blocks"],
                  loss=hist("loss").values(), grad_norm=hist("grad_norm").values(),
                  data_wait_s=hist("data_time").values(), cold_step_ms=step_ms[0],
                  warm_step_ms=step_ms[1:-1], profiled_step_ms=step_ms[-1],
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                  k1_lse=sum(k1_lse_variants().values()),
                  k1=fwa.flash_window_attention.launches,
                  k2=fwa.flash_window_attention_bwd.launches,
                  profile={k: v for k, v in (probe.profile or {}).items() if k != "top_kernels"},
                  top_kernels=(probe.profile or {}).get("top_kernels", [])[:8])
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return record


def cards_task_rank(rank, world, port, job_file):
    """One rank of phase_cards_task (a spawned process on its own card over
    NCCL): the job's task at its global batch; writes the run's record."""
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port, local_rank=rank):
        init_distributed("cuda")
        try:
            cfg = task_train_config(job["task"], job["root"], job["exp"], job["batch_size"],
                                    CARDS_STEPS, job["remat"])
            torch.save(run_task_steps(job["task"], cfg), job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


def write_task_rooms(tmp):
    """4 synthetic rooms of 200,000 2 cm voxels with normals and 20
    classes (semseg_train's), under tmp/rooms/train."""
    root = os.path.join(tmp, "rooms")
    write_gs_scenes(os.path.join(root, "train"), 4, 200000, seed=21, semseg=True)
    return root


def phase_cards_task(work, cards, task):
    """cards_semseg / cards_ssl: the task's file at its own global batch
    (semseg 48, 12 rows a card; SSL 24, 6 a card) on ``cards`` cards, each
    rank a spawned process on its card over NCCL, ``remat_blocks`` as
    CARDS_REMAT says, for CARDS_STEPS steps over 4 rooms at the file's
    points: every card's warm step, peak memory, loader wait and NCCL time
    (the profiled last step), and the same losses on every rank."""
    config, batch = CARDS_TASKS[task]
    phase = f"cards_{task}"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = write_task_rooms(tmp)
        data_s = time.perf_counter() - t0
        job_file = os.path.join(work, f"{phase}_job.pt")
        torch.save(dict(task=task, root=root, exp=os.path.join(tmp, "exp"), batch_size=batch,
                        remat=CARDS_REMAT[task],
                        out=os.path.join(work, f"{phase}_rank{{rank}}.pt")), job_file)
        ranks_s = spawn_ranks(cards_task_rank, cards, job_file, timeout_s=1500)
        ranks = [torch.load(os.path.join(work, f"{phase}_rank{r}.pt"), weights_only=False)
                 for r in range(cards)]
    emit(dict(phase=phase, config=config, world=cards, backend="nccl", batch_size=batch,
              rows_per_card=batch // cards, remat_blocks=CARDS_REMAT[task],
              dataset_write_s=data_s, ranks_s=ranks_s, loss=ranks[0]["loss"],
              grad_norm=ranks[0]["grad_norm"],
              per_rank=[{k: v for k, v in got.items() if k not in ("loss", "grad_norm")}
                        for got in ranks]))
    for r, got in enumerate(ranks):
        check(len(got["loss"]) == CARDS_STEPS, f"{phase}: rank {r} took {len(got['loss'])} steps")
        check(got["loss"] == ranks[0]["loss"] and got["grad_norm"] == ranks[0]["grad_norm"],
              f"{phase}: rank {r}'s losses {got['loss']} against rank 0's {ranks[0]['loss']}")
        check(all(math.isfinite(v) for v in got["loss"] + got["grad_norm"]),
              f"{phase}: rank {r}: non-finite losses")
        check(got["k1_lse"] > 0 and got["k2"] > 0, f"{phase}: rank {r} launched no K1 / K2")
    return dict(k1_lse=sum(got["k1_lse"] for got in ranks), k2=sum(got["k2"] for got in ranks),
                k1=sum(got["k1"] - got["k1_lse"] for got in ranks))


def phase_cards_fit(work, cards):
    """cards_fit, on one card: the rows a card the semseg and SSL files'
    global batches give on ``cards`` cards (12 and 6 on 4), trained for 2
    steps in one process with remat_blocks off and on; when a batch runs out
    of the card's memory, the next smaller even batch, down to the largest
    that fits. Records each try's peak memory and step times. (One process:
    under DDP a card also holds the gradient buckets, and the semseg Lovasz
    sort spans every card's rows.)"""
    tries = []
    with tempfile.TemporaryDirectory() as tmp:
        root = write_task_rooms(tmp)
        for task, (config, batch) in CARDS_TASKS.items():
            target = batch // cards
            for remat in (False, True):
                for b in range(target, 0, -2):
                    cfg = task_train_config(task, root, os.path.join(tmp, f"{task}_{b}_{remat}"),
                                            b, 2, remat)
                    try:
                        rec = dict(run_task_steps(task, cfg), fits=True)
                    except torch.cuda.OutOfMemoryError as e:
                        rec = dict(task=task, batch_size=b, rows_per_card=b, remat_blocks=remat,
                                   fits=False, error=str(e).splitlines()[0][:200])
                    gc.collect()
                    torch.cuda.empty_cache()
                    emit(dict(phase="cards_fit_try", **{k: v for k, v in rec.items()
                                                        if k != "top_kernels"}))
                    tries.append(rec)
                    if rec["fits"]:
                        break
    largest = {f"{task}_remat_{remat}": max(
        [t["rows_per_card"] for t in tries if t["task"] == task and t["remat_blocks"] == remat
         and t["fits"]], default=0) for task in CARDS_TASKS for remat in (False, True)}
    emit(dict(phase="cards_fit", cards=cards, targets={t: b // cards for t, (_, b)
                                                       in CARDS_TASKS.items()},
              largest_rows_per_card=largest))


def main_cards(cards, phases=()) -> int:
    """``python3 chip_smoke.py --cards N [phase ...]``: data parallel across
    ``N`` cards of one host (not the one-card smoke test): the kernels'
    build, then the phases asked for (all but ``fit`` by default):
    ``flagship``, the flagship file at its global batch of 8
    (ddp_cards_train) and N ranks over NCCL against one process
    (ddp_cards_agree, whose one-process test runs on ddp_cards_train's
    checkpoint); ``semseg`` and ``ssl``, those files at their global
    batches of 48 and 24 (cards_semseg, cards_ssl); ``fit``, on one card,
    the rows a card those batches give on N cards, with remat_blocks off
    and on (cards_fit)."""
    phases = tuple(phases) or ("flagship", "semseg", "ssl")
    unknown = set(phases) - {"flagship", "semseg", "ssl", "fit"}
    check(not unknown, f"--cards: unknown phases {sorted(unknown)}")
    if set(phases) - {"fit"}:
        check(torch.cuda.device_count() >= cards,
              f"--cards {cards}: {torch.cuda.device_count()} cards")
    t0 = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as work:
        meta_root = os.path.join(work, "metadata")
        write_meta(meta_root)
        os.environ["SCENESPLAT_META_ROOT"] = meta_root
        smi = phase_device()
        if "fit" in phases:
            phase_cards_fit(work, cards)
        if "flagship" in phases:
            train, checkpoint = phase_ddp_cards_train(work, cards)
            agree = phase_ddp_agree(work, checkpoint, meta_root, world=cards, cards=cards)
            launches["flagship"] = dict(k1_lse=train["k1_lse"] + agree["k1_lse"],
                                        k2=train["k2"] + agree["k2"], k1_test=agree["k1_test"])
        for task in ("semseg", "ssl"):
            if task in phases:
                launches[task] = phase_cards_task(work, cards, task)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)
    emit(dict(cards=cards, phases=list(phases), launches=launches))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def sum_counts(dicts):
    out = {}
    for d in dicts:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return out


SORT_ROWS = (1000, 1024, 5000, 4095, 4097, 24576, 196608, 1 << 20)
# (operands, keys, heavy ties): the last operand is the element index
SORT_SIGNATURES = ((2, 1, False), (2, 2, True), (3, 1, True), (3, 2, False), (3, 3, True))


def combined_key(keys):
    """int64 whose signed order is the unsigned lexicographic order of one
    or two int32 bit patterns."""
    out = torch.zeros_like(keys[0], dtype=torch.int64)
    for k in keys:
        out = (out << 32) | (k.to(torch.int64) & 0xFFFFFFFF)
    return out ^ -(1 << 63) if len(keys) == 2 else out


def sort_max_abs_diff(got, ref):
    """The largest |got - ref| over every operand, keys and payloads."""
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def sort_switch(on):
    """Sets the sort switch as the entry points' bitonic_sort option does."""
    bs.apply_sort_switch(dict(bitonic_sort=on))


def phase_kernel_sort():
    """K3 against its plain version, exact, payloads included (both run one
    network on identically padded rows), and against torch.sort."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    cases, checked, worst = [], 0, 0
    for n in SORT_ROWS:
        for b in (1, 4, 12):
            if b * n > (1 << 20) and b > (4 if n < (1 << 20) else 1):
                continue  # long rows: fewer of them
            for num_ops, num_keys, ties in SORT_SIGNATURES:
                lo, hi = (0, 8) if ties else (-2 ** 31, 2 ** 31 - 1)
                ops = [torch.randint(lo, hi, (b, n), generator=gen, device="cuda",
                                     dtype=torch.int32) for _ in range(num_ops - 1)]
                ops.append(torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n))
                kept = [o.clone() for o in ops]
                got = bs.bitonic_sort(ops, num_keys)
                ref = bs.bitonic_sort_reference(ops, num_keys)
                torch.cuda.synchronize()
                what = f"B={b} n={n} operands={num_ops} keys={num_keys} ties={ties}"
                worst = max(worst, sort_max_abs_diff(got, ref))
                check(all(torch.equal(g, r) for g, r in zip(got, ref)),
                      f"K3 differs from its plain version at {what}")
                check(all(torch.equal(o, k) for o, k in zip(ops, kept)),
                      f"K3 changed its inputs at {what}")
                data_keys = num_keys - (num_keys == num_ops)  # without the index
                if data_keys <= 2:
                    want = torch.sort(combined_key(ops[:data_keys]), dim=-1, stable=True)
                    check(torch.equal(combined_key(got[:data_keys]), want.values),
                          f"K3 keys differ from torch.sort at {what}")
                    if num_keys == num_ops:  # the index as last key: the stable order
                        check(torch.equal(got[-1].long(), want.indices),
                              f"K3 order differs from the stable torch.sort at {what}")
                checked += 1
            cases.append(dict(B=b, n=n, padded=bs.padded_length(n),
                              kernel_launches=bs.kernel_launches(n)))
    # int64 codes with duplicates and a sentinel tail, as the sort sites see
    # them: K3's int64 entry (sort_int64 with the switch on) against its plain
    # version on the codes' halves and the index, and against torch.sort
    int64_shapes = ((4, 1, 196608), (3, 2, 24576), (393216,), (1, 5000), (3, 70000), (4, 1000),
                    (1, 1 << 20))
    for shape in int64_shapes:
        code = torch.randint(0, 1 << 28, shape, generator=gen, device="cuda")
        code[..., -(shape[-1] // 7):] = SENTINEL
        sort_switch(False)
        values, order = bs.sort_int64(code)
        calls, kernels = bs.bitonic_sort.launches, bs.bitonic_sort.kernel_launches
        sort_switch(True)
        values_on, order_on = bs.sort_int64(code)
        sort_switch(False)
        check(bs.bitonic_sort.launches == calls + 1 and bs.bitonic_sort.kernel_launches
              == kernels + bs.kernel_launches(shape[-1]),
              f"sort_int64 with the switch on did not make one K3 call of "
              f"{bs.kernel_launches(shape[-1])} launches at {shape}")
        check(torch.equal(values, values_on) and torch.equal(order, order_on),
              f"sort_int64 with the switch on differs from torch.sort at {shape}")
        halves = code.view(torch.int32).view(*shape, 2)
        iota = torch.arange(shape[-1], dtype=torch.int32, device="cuda").expand(shape)
        hi, lo, idx = bs.bitonic_sort_reference((halves[..., 1], halves[..., 0], iota), 3)
        plain = ((hi.long() << 32) | (lo.long() & 0xFFFFFFFF), idx.long())
        worst = max(worst, sort_max_abs_diff((values_on, order_on), plain))
        check(torch.equal(values_on, plain[0]) and torch.equal(order_on, plain[1]),
              f"K3's int64 entry differs from its plain version at {shape}")
        checked += 1
    check(bs.kernel_launches(1 << 18) <= 10, "a row of 2^18 takes more than 10 launches")
    emit(dict(phase="kernel_sort", exact=True, signatures=checked, max_abs_err=worst,
              int64_shapes=int64_shapes, launches_at_2_18=bs.kernel_launches(1 << 18),
              rows=cases))
    return worst


def write_test_scenes(root, n_scenes, n_voxels, seed, pc_points=100000, semseg=False):
    """``n_scenes`` ScanNet-layout scenes under root/val: ``n_voxels``
    unique 2 cm voxels on the floor and walls of a 6 x 6 x 3 m room, each
    holding two Gaussians 1 cm apart on its diagonal, plus one Gaussian at
    height 0 in a voxel of its own, so that the 1 cm deduplication keeps all
    2 n + 1 and the 2 cm test voxelisation, whose cells line up with the
    voxels after CenterShift, gives 2 fragments of n + 1 points. With 200
    classes by position as ``segment200``, valid_feat_mask and an
    evaluation point cloud of ``pc_points`` of the Gaussians moved by a few
    millimetres; with ``semseg`` the semseg files' assets instead: normals
    and 20 classes by angle and height as ``segment20``. Returns the
    Gaussians a scene holds."""
    rng = np.random.default_rng(seed)
    extent = [int(round(m / GRID)) for m in (6.0, 6.0, 3.0)]
    ex, ey, _ = extent
    x, y, z = np.meshgrid(*(np.arange(e) for e in extent), indexing="ij")
    surface = (z < 1) | (x < 1) | (x >= ex - 1) | (y < 1) | (y >= ey - 1)
    vox = np.stack([x[surface], y[surface], z[surface]], -1)
    for i in range(n_scenes):
        perm = rng.permutation(len(vox))
        grid = vox[perm[:n_voxels]]
        rest = vox[perm[n_voxels:]]
        anchor = rest[np.flatnonzero((rest[:, 2] == 0) & (rest[:, 0] > 0) & (rest[:, 0] < ex - 1)
                                     & (rest[:, 1] > 0) & (rest[:, 1] < ey - 1))[0]]
        coord = np.concatenate([(grid + 0.25) * GRID, (grid + 0.75) * GRID,
                                [[(anchor[0] + 0.5) * GRID, (anchor[1] + 0.5) * GRID, 0.0]]]
                               ).astype(np.float32)
        n = len(coord)
        angle = np.arctan2(coord[:, 1] - 3.0, coord[:, 0] - 3.0)
        if semseg:
            seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
            seg = (seg + 10 * (coord[:, 2] > 1.5)).astype(np.int16)
        else:
            seg = ((angle + np.pi) / (2 * np.pi) * 20).astype(np.int64).clip(0, 19)
            seg = (seg * 10 + (coord[:, 2] / 3.0 * 10).astype(np.int64).clip(0, 9)
                   ).astype(np.int16)
            pick = rng.choice(n, pc_points, replace=False)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32))
        if semseg:
            cells = np.concatenate([grid, grid, anchor[None]])
            assets.update(segment20=seg, normal=shell_normals(cells, extent, 1))
        else:
            assets.update(
                segment200=seg, valid_feat_mask=rng.random(n) > 0.1,
                pc_coord=(coord[pick] + rng.normal(0, 0.002, (pc_points, 3))).astype(np.float32),
                pc_segment200=seg[pick].astype(np.int32))
        scene = os.path.join(root, "val", f"scene{i:04d}_00")
        os.makedirs(scene)
        for key, value in assets.items():
            np.save(os.path.join(scene, f"{key}.npy"), value)
    return 2 * n_voxels + 1

TEST_CONFIG = """# The flagship config file plus the tester and its data: test= and
# data.test= of configs/scannet/lang-pretrain-scannet-mcmc-wo-normal-contrastive.py
# with the fragment test pipeline of configs/_base_/gs_pipelines.py (loaded
# by path). is_train=False, as the flagship file's validation sets have it,
# loads the evaluation point cloud, so the tester votes onto it.
import importlib.util

_base_ = [{flagship!r}]
_spec = importlib.util.spec_from_file_location("gs_pipelines", {pipelines!r})
_gp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_gp)
del _spec

_gs_keys = ("coord", "color", "opacity", "quat", "scale", "segment",
            "lang_feat", "valid_feat_mask")
_test_transform, _test_cfg = _gp.lang_test_transform_and_cfg(_gs_keys)

data = dict(
    test=dict(
        type="ScanNet200GSDataset",
        split="val",
        data_root={data_root!r},
        is_train=False,
        transform=_test_transform,
        test_mode=True,
        test_cfg=_test_cfg,
    ),
)

test = dict(
    type="ZeroShotSemSegTester",
    class_names={meta_root!r} + "/scannet200_labels.txt",
    text_embeddings={meta_root!r} + "/scannet200_text_embeddings_siglip2.pt",
    excluded_classes=["wall", "floor", "ceiling"],
    enable_voting=True,
    vote_k=25,
    confidence_threshold=0.1,
)
"""


def forward_sort_sizes(backbone, n_points):
    """Row lengths of the 8 sorts of one forward of ``n_points`` through the
    FeatureExtractor: the bucket (4 curves, then the stem's conv plan) and
    each pooled stage's capacity (its 3 re-sorted curves, then its conv
    plan). Returns [(rows, length), ...]."""
    n0 = bucket_size(n_points, max(backbone["enc_patch_size"]))
    curves = len(backbone["order"])
    sizes = [(curves, n0), (1, n0)]
    for s, frac in enumerate(backbone["stage_capacity"]):
        cap = _round_capacity(n0, frac, backbone["enc_patch_size"][s + 1])
        sizes += [(curves - 1, cap), (1, cap)]
    return sizes


class WindowCalls:
    """Records (N, valid count of each batch row, K, C, H) of the first
    ``limit`` K1 calls at windows of at most ``max_window`` slots (by
    default FWD_SMALL_MAX: the decoder's) while it is entered, then passes
    each call on unchanged."""

    def __init__(self, limit, max_window=fwa.FWD_SMALL_MAX):
        self.limit, self.max_window, self.calls = limit, max_window, []

    def __enter__(self):
        real = self.real = window_attention_module.flash_window_attention

        def recording(qkv, valid, patch_size, num_heads, scale=None):
            if len(self.calls) < self.limit and patch_size <= self.max_window:
                self.calls.append((qkv.shape[1], tuple(valid.sum(1).tolist()), patch_size,
                                   qkv.shape[3], num_heads))
            return real(qkv, valid, patch_size, num_heads, scale)

        window_attention_module.flash_window_attention = recording
        return self

    def __exit__(self, *exc):
        window_attention_module.flash_window_attention = self.real

    def shapes(self):
        """(N, valids, K, C, H, calls) of each distinct call, in call order."""
        order = list(dict.fromkeys(self.calls))
        return [(*call, self.calls.count(call)) for call in order]


def run_test_entry(work, prefix, args, calls):
    """The test entry point's main with ``args`` three times: sort switch
    off and on under deterministic algorithms, whose predictions and
    metrics the caller holds equal, then off as a user runs it (no
    deterministic mode), whose times are the ones to quote per scene.
    ``calls`` (a WindowCalls) records K1's calls in the first run. Returns
    each run ("off", "on", "timed"): its results, scene log, predictions by
    scene, seconds, K3 sort calls and kernel launches, K1 launches and K1
    launches by variant."""
    runs = {}
    try:
        for name, switch, deterministic in (("off", False, True), ("on", True, True),
                                            ("timed", False, False)):
            # scatter-adds of the pooling sum in an order that changes from
            # run to run, and a last-bit difference can flip an argmax: the
            # two runs that are compared use the deterministic forms
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            save = os.path.join(work, f"{prefix}_{name}")
            bs.bitonic_sort.launches = bs.bitonic_sort.kernel_launches = 0
            reset_k1_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run_args = args + [f"test.save_path={save}", f"bitonic_sort={switch}"]
            with calls if name == "off" else contextlib.nullcontext():
                (res,) = test_entry.main(run_args)
            seconds = time.perf_counter() - t1
            with open(os.path.join(save, "scene_log.json")) as f:
                scenes = json.load(f)
            runs[name] = dict(
                res=res, scenes=scenes, seconds=seconds,
                preds={sc["name"]: np.load(os.path.join(save, f"{sc['name']}_pred.npy"))
                       for sc in scenes},
                sort_calls=bs.bitonic_sort.launches, sort_kernels=bs.bitonic_sort.kernel_launches,
                k1=fwa.flash_window_attention.launches, k1_variants=k1_variants())
    finally:
        torch.use_deterministic_algorithms(False)
        sort_switch(False)
    return runs


def check_test_runs(phase, runs, n_scenes, n_points, backbone):
    """What both test phases hold of run_test_entry's runs: every scene of
    ``n_points`` predicted in each run, equal predictions and metrics with
    the sort switch off and on, K3 launched only with the switch on and
    then for every sort of every fragment forward (reckoned from the
    fragments' sizes), and K1 once a block in every fragment forward, the
    encoder's on bf16_large and the decoder's windows of 48 on bf16_small.
    Returns the fragments' point counts and each fragment forward's sort
    sizes."""
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    check(len(off["preds"]) == n_scenes
          and sorted(off["preds"]) == sorted(on["preds"]) == sorted(timed["preds"]),
          f"{phase}: predicted scenes {sorted(off['preds'])}, {sorted(on['preds'])} and "
          f"{sorted(timed['preds'])}")
    for sc in on["scenes"]:
        check(sc["points"] == n_points, f"{phase}: scene {sc['name']} has {sc['points']} points")
    for key, pred in off["preds"].items():
        check(pred.ndim == 1, f"{phase}: {key} predictions of shape {pred.shape}")
        check(np.array_equal(pred, on["preds"][key]),
              f"{phase}: {key}: predictions differ with the sort switch on")
    for key, value in off["res"].items():
        check(np.array_equal(value, on["res"][key]),
              f"{phase}: metric {key} differs with the sort switch on")
    fragment_points = [p for sc in on["scenes"] for p in sc["fragment_points"]]
    fragments = len(fragment_points)
    # the sorts of each fragment forward: the bucket's curves and conv plan,
    # and each pooled stage's
    sizes = [forward_sort_sizes(backbone, p) for p in fragment_points]
    want_calls = sum(len(sz) for sz in sizes)
    want_kernels = sum(bs.kernel_launches(length) for sz in sizes for _, length in sz)
    check(off["sort_calls"] == off["sort_kernels"] == timed["sort_calls"] == 0,
          f"{phase}: K3 launched with the sort switch off")
    check(on["sort_calls"] == want_calls and on["sort_kernels"] == want_kernels,
          f"{phase}: K3 {on['sort_calls']} sorts and {on['sort_kernels']} kernels, reckoned "
          f"{want_calls} and {want_kernels}")
    enc, dec = depth_split(backbone)
    for name, run in runs.items():
        got = {v: n for v, n in run["k1_variants"].items() if n}
        check(run["k1"] == (enc + dec) * fragments
              and got == dict(bf16_large=enc * fragments, bf16_small=dec * fragments),
              f"{phase}: run {name}: K1 launches {run['k1']} {got} in {fragments} fragment "
              f"forwards, expected {enc} bf16_large and {dec} bf16_small each")
    return fragment_points, sizes


def scene_split(run):
    """Each scene's points, fragments and seconds (fetch, extract, score
    where the tester scores, vote, total) from a run's scene log."""
    keys = ("fetch_s", "extract_s", "score_s", "vote_s", "total_s")
    return [dict(name=sc["name"], points=sc["points"], fragments=sc["fragments"],
                 fragment_points=sc["fragment_points"], **{k: sc[k] for k in keys if k in sc})
            for sc in run["scenes"]]


def phase_test(work, checkpoint, meta_root, n_voxels=160000, n_scenes=2):
    """The zero-shot test entry point on the flagship file's tester, three
    times through run_test_entry. Returns the K3 counts of the run with the
    switch on, its fragment forwards, the sort sizes of one, K1's variant
    launches in that run and the shapes of the decoder's K1 calls in the
    first fragment forward."""
    t0 = time.perf_counter()
    data_root = os.path.join(work, "scannet_test")
    n_points = write_test_scenes(data_root, n_scenes, n_voxels, seed=12)
    cfg_file = os.path.join(work, "flagship_test.py")
    with open(cfg_file, "w") as f:
        f.write(TEST_CONFIG.format(flagship=os.path.abspath(FLAGSHIP_CONFIG),
                                   pipelines=os.path.abspath(PIPELINES),
                                   data_root=data_root, meta_root=meta_root))
    write_s = time.perf_counter() - t0
    backbone = Config.fromfile(cfg_file).model.backbone
    enc, dec = depth_split(backbone)
    # the compared run's decoder call shapes, for timing_test
    small_calls = WindowCalls(limit=dec)
    runs = run_test_entry(work, "test", ["--config-file", cfg_file, "--options",
                                         f"weight={checkpoint}"], small_calls)
    fragment_points, sizes = check_test_runs("test", runs, n_scenes, n_points, backbone)
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    fragments = len(fragment_points)
    for s in on["scenes"]:
        check(s["fragments"] >= 2 and min(s["fragment_points"]) >= 150000,
              f"scene {s['name']}: {s['fragments']} fragments of {s['fragment_points']}")
    for name, pred in off["preds"].items():  # voted onto the evaluation cloud
        check(len(pred) > 50000, f"{name}: shape {pred.shape}")
    check(all(np.isfinite(off["res"][k]) for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")),
          "non-finite metrics")
    check(len(small_calls.calls) == dec and all(k == 48 for _, _, k, _, _ in small_calls.calls),
          f"the first fragment's decoder calls: {small_calls.calls}")
    agreement = float(np.mean([np.mean(pred == timed["preds"][name])
                               for name, pred in off["preds"].items()]))

    # the voting's neighbour search alone, at the last scene's sizes
    rng = np.random.default_rng(3)
    data = rng.uniform(0, 6, (int(0.9 * n_points), 3)).astype(np.float32)
    query = rng.uniform(0, 6, (100000, 3)).astype(np.float32)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    knn(data, query, 25, device="cuda")
    knn_s = time.perf_counter() - t1

    record = dict(
        phase="test", dtype="bfloat16", scenes=n_scenes, points_per_scene=n_points,
        fragments=fragments, dataset_write_s=write_s, sort_sizes=sizes[0],
        switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                        per_scene=scene_split(off), k1_launches=off["k1"],
                        sort_calls=off["sort_calls"]),
        switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                       per_scene=scene_split(on), k1_launches=on["k1"],
                       k1_variant_launches=on["k1_variants"],
                       sort_calls=on["sort_calls"], sort_kernel_launches=on["sort_kernels"]),
        as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                               seconds=timed["seconds"], per_scene=scene_split(timed),
                               k1_launches=timed["k1"],
                               predictions_equal_to_deterministic_run=agreement,
                               metrics={k: timed["res"][k]
                                        for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")}),
        predictions_equal=True, metrics_equal=True,
        metrics={k: off["res"][k] for k in ("mIoU", "fg_mIoU", "mAcc", "fg_mAcc", "allAcc")},
        classes_predicted=int(len(np.unique(np.concatenate(list(off["preds"].values()))))),
        knn_s=knn_s, knn_data=len(data), knn_queries=len(query))
    record["decoder_k1_calls_first_fragment"] = small_calls.shapes()
    emit(record)
    return (on["sort_calls"], on["sort_kernels"], fragments, sizes[0], on["k1_variants"],
            small_calls.shapes())

def phase_timing_sort(sizes, phase="timing_sort"):
    """At the 8 sort shapes of one fragment forward: sort_int64 with the
    switch on (K3's int64 entry, as the sort sites call it), the plain
    version and torch.sort(stable=True) on the int64 codes, by CUDA events;
    the bound is every operand read once and written once at the memory
    rate."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, worst = [], 0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, kernel_launches=0)
    for b, n in sizes:
        code = torch.randint(0, 1 << 30, (b, n), generator=gen, device="cuda")
        code[:, -(n // 5):] = SENTINEL  # padding slots
        halves = code.view(torch.int32).view(b, n, 2)
        ops = (halves[..., 1].contiguous(), halves[..., 0].contiguous(),
               torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n).contiguous())
        sort_switch(True)
        try:
            got = bs.sort_int64(code)
            ms = cuda_ms(lambda: bs.sort_int64(code), reps=20)
        finally:
            sort_switch(False)
        hi, lo, idx = bs.bitonic_sort_reference(ops, 3)
        ref = ((hi.long() << 32) | (lo.long() & 0xFFFFFFFF), idx.long())
        want = torch.sort(code, dim=-1, stable=True)
        torch.cuda.synchronize()
        worst = max(worst, sort_max_abs_diff(got, ref))
        check(all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"K3 differs from its plain version at {(b, n)}")
        check(torch.equal(got[0], want.values) and torch.equal(got[1], want.indices),
              f"K3 differs from the stable torch.sort at {(b, n)}")
        row = dict(
            ms=ms,
            plain_ms=cuda_ms(lambda: bs.bitonic_sort_reference(ops, 3), reps=2, warmup=1),
            library_ms=cuda_ms(lambda: torch.sort(code, dim=-1, stable=True), reps=20),
            bound_ms=2 * 3 * 4 * b * n / PEAK_BYTES * 1e3)
        rows.append(dict(B=b, n=n, padded=bs.padded_length(n),
                         kernel_launches=bs.kernel_launches(n), **row))
        for key, val in row.items():
            tot[key] += val
        tot["kernel_launches"] += bs.kernel_launches(n)
    tot["max_abs_err"] = worst
    emit(dict(phase=phase, operands=3, num_keys=3, entry="sort_int64, switch on",
              per_call=rows, per_forward=tot))
    return tot


def phase_timing_test(shapes, phase="timing_test"):
    """At the shapes and valid counts of K1's calls in one test fragment
    forward (the flagship's: the decoder's, windows of 48 on bf16_small; the
    semseg file's: every call), without lse: the kernel against its plain
    version (bf16 noise-floor rule, zeros where slot 0 is padding), then the
    kernel's, the plain version's and the library's times per call and per
    fragment forward, with the bound, in all and for each variant."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows, worst = [], 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    by_variant = {}
    for n, valids, k, c, h, count in shapes:
        b, d = len(valids), c // h
        qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
        dead = torch.zeros_like(valid)
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
            dead[i, -(-nv // k) * k:] = True
        variant = fwa.forward_variant(qkv.dtype, k, d)
        out = fwa.flash_window_attention(qkv, valid, k, h)
        torch.cuda.synchronize()
        check((out[dead] == 0).all().item(), f"padded windows not zero at {n, valids, k, c, h}")
        err16, floor16 = check_bf16(qkv, valid, k, h, out=out)
        plain16 = fwa.flash_window_attention_plain(qkv, valid, k, h, patch_chunk=16384 // k)
        worst = max(worst, (out.float() - plain16.float())[valid].abs().max().item())
        ms = cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps=10)
        plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                           reps=3, warmup=1)
        p = -(-n // k)
        pad = p * k - n
        qkv_w = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
        valid_w = torch.nn.functional.pad(valid, (0, pad))
        q, kk, v = qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid_w.view(b * p, 1, 1, k)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps=10)
        ops_ms, bytes_ms = (sum(x) for x in zip(*(bound_ms(n, nv, k, c) for nv in valids)))
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms)
        rows.append(dict(N=n, valid=list(valids), K=k, C=c, H=h, launches=count,
                         variant=variant, **row, bound_ms=max(ops_ms, bytes_ms),
                         bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        part = by_variant.setdefault(variant, dict.fromkeys(row, 0.0))
        for key, val in row.items():
            tot[key] += count * val
            part[key] += count * val
        del qkv, qkv_w, q, kk, v, out, plain16
    tot["max_abs_err"] = worst  # against the plain bf16 version
    for part in [tot] + list(by_variant.values()):
        part["bound_ms"] = max(part["ops_ms"], part["bytes_ms"])
        part["bound_by"] = "operations" if part["ops_ms"] >= part["bytes_ms"] else "bytes"
    tot["by_variant"] = by_variant
    emit(dict(phase=phase, dtype="bfloat16", lse=False, per_call=rows,
              per_fragment_forward=tot))
    return tot


def semseg_train_config(root, exp, batch_size, steps, scenes):
    """The ScanNet-20 semseg file as it is, its hooks included, with the
    data roots (train, val and the post-training test all under ``root``),
    epoch 1, the batch size, and a train loop that gives ``steps`` steps
    over ``scenes`` scenes (Mix3D: two samples a batch slot). The
    post-training tester writes its scene log under ``exp``."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    samples = steps * batch_size * (2 if cfg.mix_prob > 0 else 1)
    check(samples % scenes == 0, f"{samples} samples over {scenes} scenes")
    cfg.data.train.update(data_root=root, loop=samples // scenes)
    cfg.data.val.data_root = cfg.data.test.data_root = root
    cfg.test["save_path"] = os.path.join(exp, "precise_test")
    return cfg


def phase_semseg_train(work, weight, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6),
                       val_points=40000):
    """The semseg trainer on configs/scannet/semseg-gs-scannet-all-w-normal-
    fixed-xyz.py as it is (widths, 205,824 points, losses, optimizer,
    schedule, transforms, Mix3D 0.8 and its own hooks) at batch 2 for
    ``steps`` steps over 4 synthetic ScanNet-layout scenes with normals and
    20 classes, and one validation scene, which PreciseEvaluator's
    SemSegTester also runs after training with the file's 9 views; started
    from ``weight`` (the SSL teacher's backbone that warm_start extracted)
    through the file's CheckpointLoader, whose load WarmStartProbe checks.
    Returns the train-step stage shapes, the K1 / K2 launch counts and the
    best checkpoint, copied into ``work``."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "scannet_gs")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=21, size_m=room,
                        semseg=True)
        write_gs_scenes(os.path.join(root, "val"), 1, val_points, seed=22,
                        size_m=(2.4, 2.4, 2.0), semseg=True)
        data_s = time.perf_counter() - t0
        reset_k1_counts()
        fwa.flash_window_attention_bwd.launches = 0
        k2_variants = fwa.flash_window_attention_bwd.variant_launches
        k2_variants.update(dict.fromkeys(k2_variants, 0))
        cfg = semseg_train_config(root, os.path.join(tmp, "exp"), 2, steps, 4)
        cfg.weight = weight
        source = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
        warm = WarmStartProbe(source)
        trainer, probe, records, k1_counts = run_training(cfg, before=warm.insert)
        check(warm.record is not None, "semseg: the warm start was not checked")
        check(warm.record["kept"] == [STEM, "seg_head.bias", "seg_head.weight"]
              and warm.record["skipped"] == [STEM],
              f"semseg: from the teacher, kept {warm.record['kept']}, skipped "
              f"{warm.record['skipped']}: expected the stem (11 vs 14 channels) and seg_head")
        emit(dict(phase="warm_start_semseg_train", weight="ssl_train's teacher, extracted",
                  **warm.record))
        backbone = trainer.cfg.model.backbone
        enc, dec = depth_split(backbone)
        blocks = enc + dec  # 22
        k1, k1_val = k1_counts["train_launches"], k1_counts["val_launches"]
        k2 = fwa.flash_window_attention_bwd.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        n_steps = len(losses)
        check(n_steps == steps, f"semseg: {n_steps} train steps, expected {steps}")
        check(all(math.isfinite(v) for v in losses + grad_norms),
              f"semseg: non-finite loss or grad_norm: {losses} {grad_norms}")
        check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
              and k2 == blocks * steps,
              f"semseg: {k1} forward and {k2} backward kernel launches in {steps} steps, "
              f"expected {blocks} each per step")
        check(k2_variants == dict(k2_variants, bf16_small=dec * steps, bf16_large=enc * steps),
              f"semseg: backward variant launches {k2_variants}, expected {dec} bf16_small "
              f"(windows of 48) and {enc} bf16_large (windows of 1024) a step")
        got = {v: n for v, n in k1_counts["train_variants"].items() if n}
        check(got == dict(bf16_large=enc * steps, bf16_small=dec * steps),
              f"semseg: train K1 variant launches {got}, expected {enc} bf16_large and "
              f"{dec} bf16_small a step")
        # after training: one validation forward (the evaluator), then the
        # PreciseEvaluator's tester, one forward a fragment
        precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
        check(len(precise) == 1 and len(precise[0].results) == 1,
              "semseg: PreciseEvaluator did not run the file's tester")
        with open(os.path.join(cfg.test.save_path, "scene_log.json")) as f:
            test_fragments = sum(sc["fragments"] for sc in json.load(f))
        val_forwards = k1_counts["val_forwards"]
        check(val_forwards == 1 + test_fragments and k1_val == blocks * val_forwards,
              f"semseg: {k1_val} K1 launches in {val_forwards} evaluation forwards, expected "
              f"{blocks} in each of 1 validation and {test_fragments} test fragments")
        got = {v: n for v, n in k1_counts["val_variants"].items() if n}
        check(got == dict(bf16_large=enc * val_forwards, bf16_small=dec * val_forwards),
              f"semseg: evaluation K1 variant launches {got}")
        overflow = [[int(o.max()) for o in r["overflow"]] for r in records]
        check(not any(map(any, overflow)) and not any(k1_counts["val_overflow"]),
              f"semseg: pooling overflow {overflow} {k1_counts['val_overflow']}")
        miou = hist("val/mIoU").values()
        check(len(miou) == 1 and 0.0 <= miou[0] <= 1.0, f"semseg: val/mIoU {miou}")
        check(trainer.comm_info.get("current_metric_name") == "mIoU",
              "semseg: the evaluator set no checkpoint metric")
        test_miou = precise[0].results[0]["mIoU"]
        check(math.isfinite(test_miou), f"semseg: test mIoU {test_miou}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        check(os.path.exists(os.path.join(model_dir, "model_best.pth")),
              "semseg: no model_best.pth")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                 os.path.join(work, "semseg_model_best.pth"))
        sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
        emit(dict(phase="semseg_train", config=SEMSEG_CONFIG, batch_size=2,
                  points=cfg.data.num_points, steps=n_steps, loss=losses, grad_norm=grad_norms,
                  lr=hist("lr").values(), cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=peak_gib, val_miou=miou[0], precise_test_miou=test_miou,
                  precise_test_fragments=test_fragments,
                  k1_launches_per_step=k1 / steps, k2_launches_per_step=k2 / steps,
                  k1_variant_launches=k1_counts["train_variants"],
                  k2_variant_launches=dict(k2_variants),
                  evaluation_forwards=val_forwards, evaluation_k1_launches=k1_val,
                  evaluation_k1_variant_launches=k1_counts["val_variants"],
                  n_overflow_per_stage=overflow, evaluation_n_overflow=k1_counts["val_overflow"],
                  stage_slots_valid=sizes[-1], dataset_write_s=data_s, profile=probe.profile))
        print(f"semseg_train: val/mIoU {miou[0]:.4f} (after {n_steps} steps)", flush=True)
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    variants = dict(train=k1_counts["train_variants"], evaluation=k1_counts["val_variants"])
    return shapes, k1, variants, dict(k2_variants), checkpoint


def semseg_rows(n, seeds):
    """One semseg batch row of ``n`` points per seed: a room whose 4 cm
    cells fit the first pooling (see train_agree), 14 input channels (the
    Gaussian features and the shell's normals), 20 classes by angle and
    height, 5% ignored; numpy arrays [rows, n, ...]."""
    rows = []
    size_m = (2.4, 2.4, 2.4)
    for seed in seeds:
        rng = np.random.default_rng(seed)
        coord, feat_in, grid = room_scene(rng, n, size_m)
        normal = shell_normals(grid, [int(round(m / GRID)) for m in size_m], 1)
        angle = np.arctan2(coord[:, 1] - 1.2, coord[:, 0] - 1.2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = seg + 10 * (coord[:, 2] > 1.0)
        seg[rng.random(n) < 0.05] = -1  # ignored points
        rows.append(dict(coord=coord, feat=np.concatenate([feat_in, normal], 1).astype(
            np.float32), grid_coord=grid, mask=np.ones(n, bool), segment=seg))
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


def phase_semseg_agree(n=49152):
    """One fp32 train step of the semseg file's model at one block a stage
    (its widths, heads and windows kept) and ``n`` points, CE + Lovasz, with
    the kernels and with the plain attention."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4)
    batch = cuda_batch(semseg_rows(n, (13,)))
    model_cfg = dict(cfg.model)
    criteria = build_criteria(model_cfg.pop("criteria"))

    def step(use_kernel):
        model = build_model(dict(model_cfg, backbone=dict(
            backbone, dtype="float32", seed=1, use_kernel=use_kernel)))
        model = model.cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(12)
        loss, out = semseg_loss(model, criteria, batch, gen)
        loss.backward()
        return (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                [int(p.n_overflow.max()) for p in out.plans])

    compare_train_steps("semseg_agree", step, sum(depth_split(backbone)), points=n,
                        config=SEMSEG_CONFIG, enc_depths=backbone["enc_depths"],
                        dec_depths=backbone["dec_depths"], criteria=[
                            c["type"] for c in cfg.model.criteria])


def phase_semseg_test(work, checkpoint, n_voxels=160000, n_scenes=2):
    """``python -m scenesplat_tpu_torch.test`` on the semseg file as it is
    (SemSegTester with the file's 9 test-time views and fragment voting,
    bf16) with the semseg_train checkpoint, three times through
    run_test_entry; the per-scene seconds (fetch, extract, vote) of the run
    as a user makes it are the ones to quote. Returns K3's and K1's counts
    of the K3 run, the fragments, the sort sizes of the first fragment
    forward and the shapes of K1's calls in it."""
    t0 = time.perf_counter()
    data_root = os.path.join(work, "semseg_test")
    n_points = write_test_scenes(data_root, n_scenes, n_voxels, seed=23, semseg=True)
    write_s = time.perf_counter() - t0
    backbone = Config.fromfile(SEMSEG_CONFIG).model.backbone
    blocks = sum(depth_split(backbone))
    calls = WindowCalls(limit=blocks, max_window=max(backbone["enc_patch_size"]))
    runs = run_test_entry(work, "semseg_test", [
        "--config-file", SEMSEG_CONFIG, "--options", f"weight={checkpoint}",
        f"data.test.data_root={data_root}"], calls)
    fragment_points, sizes = check_test_runs("semseg_test", runs, n_scenes, n_points, backbone)
    off, on, timed = runs["off"], runs["on"], runs["timed"]
    for sc in on["scenes"]:
        check(sc["fragments"] >= 9, f"semseg_test: scene {sc['name']}: {sc['fragments']} "
              "fragments for 9 views")
    for key, pred in off["preds"].items():
        check(len(pred) == n_points, f"semseg_test: {key} {pred.shape}")
    check(np.isfinite(off["res"]["mIoU"]), f"semseg_test: mIoU {off['res']['mIoU']}")
    check(len(calls.calls) == blocks, f"semseg_test: first fragment's K1 calls {calls.calls}")
    emit(dict(phase="semseg_test", config=SEMSEG_CONFIG, dtype="bfloat16", scenes=n_scenes,
              points_per_scene=n_points, views=9, fragments=len(fragment_points),
              dataset_write_s=write_s,
              switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                              per_scene=scene_split(off), k1_launches=off["k1"]),
              switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                             per_scene=scene_split(on), k1_launches=on["k1"],
                             k1_variant_launches=on["k1_variants"], sort_calls=on["sort_calls"],
                             sort_kernel_launches=on["sort_kernels"]),
              as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                                     seconds=timed["seconds"], per_scene=scene_split(timed),
                                     mIoU=timed["res"]["mIoU"]),
              predictions_equal=True, mIoU=off["res"]["mIoU"],
              iou_per_class=off["res"]["iou_per_class"].tolist(),
              k1_calls_first_fragment=calls.shapes()))
    for sc in scene_split(timed):
        print(f"semseg_test: {sc['name']} {sc['points']} points, {sc['fragments']} fragments: "
              f"fetch {sc['fetch_s']:.2f} s, extract {sc['extract_s']:.2f} s, vote "
              f"{sc['vote_s']:.2f} s, total {sc['total_s']:.2f} s", flush=True)
    return on, len(fragment_points), sizes[0], calls.shapes()

def ssl_train_config(root, exp, batch_size, steps, scenes):
    """The ScanNet SSL file as it is, its hooks included, with the data
    root, epoch 1, the batch size and a train loop that gives ``steps``
    steps over ``scenes`` scenes."""
    cfg = Config.fromfile(SSL_CONFIG)
    cfg.merge_from_options(dict(save_path=exp, epoch=1, eval_epoch=1, batch_size=batch_size))
    samples = steps * batch_size
    check(samples % scenes == 0, f"{samples} samples over {scenes} scenes")
    cfg.data.train.update(data_root=root, loop=samples // scenes)
    return cfg


def record_passes(model):
    """Wraps the SSL model's student and teacher backbones: for each, the
    forwards, K1's launches of each variant inside them with and without the
    log-sum-exp, and per forward the pooling overflow and (slots, valid
    count) of each stage, kept as tensors (no host sync in the step)."""
    rec = {}
    for name, module in (("student", model.backbone), ("teacher", model.teacher)):
        r = rec[name] = dict(forwards=0, variants=dict.fromkeys(fwa.VARIANTS, 0),
                             lse_variants=dict.fromkeys(fwa.VARIANTS, 0), passes=[])

        def recording(point, generator=None, token_mask=None, return_enc=False,
                      _forward=module.forward, _r=r):
            before, before_lse = k1_variants(), k1_lse_variants()
            out = _forward(point, generator=generator, token_mask=token_mask,
                           return_enc=return_enc)
            _r["forwards"] += 1
            for v, n in k1_variants().items():
                _r["variants"][v] += n - before[v]
            for v, n in k1_lse_variants().items():
                _r["lse_variants"][v] += n - before_lse[v]
            dec = out[0] if return_enc else out
            _r["passes"].append(dict(
                masked=token_mask is not None, overflow=[p.n_overflow for p in dec.plans],
                clusters=[p.n_clusters for p in dec.plans],
                sizes=[(point.mask.shape[1], point.mask.sum(1))]
                + [(p.out_mask.shape[1], p.out_mask.sum(1)) for p in dec.plans]))
            return out

        module.forward = recording
    return rec


class EmaProbe(HookBase):
    """Holds the teacher to its EMA at every step: one teacher parameter
    after the step must equal m t + (1 - m) s, t its value before the step,
    s the student's after the optimizer step, m the step's momentum, within
    four fp32 roundings of |m t| + |(1 - m) s|; the teacher's mask token
    must never move."""

    PARAM = "enc.enc4.block1.attn.qkv.weight"

    def before_train(self):
        self.token = self.trainer.model.teacher.mask_token.detach().clone()
        self.errors = []

    def before_step(self):
        self.m = np.float32(self.trainer.momentum_schedule(self.trainer.storage.iter))
        self.t = self.trainer.model.teacher.get_parameter(self.PARAM).detach().clone()

    def after_step(self):
        model = self.trainer.model
        s = model.backbone.get_parameter(self.PARAM).detach()
        got = model.teacher.get_parameter(self.PARAM).detach()
        a, b = self.t * float(self.m), s * float(np.float32(1) - self.m)
        err = (got - (a + b)).abs()
        tol = 4 * torch.finfo(torch.float32).eps * (a.abs() + b.abs()) + 1e-30
        self.errors.append(dict(momentum=float(self.m), max_abs_err=err.max().item(),
                                worst_err_over_tol=(err / tol).max().item(),
                                moved=(got != self.t).any().item()))
        check((err <= tol).all().item(), f"ssl: teacher {self.PARAM} is not m t + (1 - m) s "
              f"at step {self.trainer.storage.iter}: {self.errors[-1]}")
        check(torch.equal(model.teacher.mask_token, self.token),
              "ssl: the teacher's mask token moved")


def ssl_stage_shapes(backbone, student, local_crop_num):
    """The timing phase's shapes from one step's student passes: the first
    global crop's stages for both globals (forward with lse and backward
    twice), the first local crop's for every local (the encoder forward and
    backward, the decoder forward only: its output takes no gradient)."""
    g0, _, local = student["passes"][-(2 + local_crop_num):][:3]  # the last step's
    check(g0["masked"] and not local["masked"], "ssl: the student's passes out of order")
    shapes = []
    for record, count, dec_bwd in ((g0, 2, 2), (local, local_crop_num, 0)):
        sizes = [(n, v.tolist()) for n, v in record["sizes"]]
        stages = stage_shapes(backbone, sizes)
        enc = len(sizes)
        shapes += [sh[:5] + (sh[5] * count, sh[5] * (count if i < enc else dec_bwd))
                   for i, sh in enumerate(stages)]
    return shapes


def phase_ssl_train(work, steps=6, scene_points=200000, room=(3.6, 3.6, 2.6)):
    """The SSL trainer on configs/scannet/ssl-pretrain-scannet-all-base.py as
    it is (SimDINOSSL at the shipped widths: 5 stages, windows of 1024 in
    the encoder, 48 in the decoder, 3 local crops, patch masks, MAE; AdamW,
    OneCycle, the EMA teacher, the multi-crop transforms with the voxel
    blur, 102,400 / 25,600 points a global / local crop, its own hooks) at
    batch 2 for ``steps`` steps over 4 synthetic unlabeled rooms of
    ``scene_points`` 2 cm voxels. Returns the timing phase's shapes and the
    launch counts."""
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        root = os.path.join(tmp, "ssl_gs")
        write_gs_scenes(os.path.join(root, "train"), 4, scene_points, seed=31, size_m=room,
                        semseg=True)
        data_s = time.perf_counter() - t0
        batch = 2  # the reference's 8 a card cut to 2
        reset_k1_counts()
        fwa.flash_window_attention_bwd.launches = 0
        k2_variants = fwa.flash_window_attention_bwd.variant_launches
        k2_variants.update(dict.fromkeys(k2_variants, 0))
        cfg = ssl_train_config(root, os.path.join(tmp, "exp"), batch, steps, 4)
        trainer = build_trainer(cfg, device="cuda")
        probe, ema = StepProbe(profile_step=steps - 1), EmaProbe()
        for hook in (probe, ema):
            hook.trainer = trainer
            trainer.hooks.append(hook)
        passes = record_passes(trainer.model)
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        backbone = trainer.cfg.model.backbone
        locals_ = trainer.loss_kwargs["local_crop_num"]
        enc, dec = depth_split(backbone)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        terms = ("loss", "grad_norm", "mcr_comp_loss", "mcr_expa_loss", "sim_dino_crops_loss",
                 "sim_ibot_patch_loss", "global_mae_loss")
        logged = {k: hist(k).values() for k in terms}
        check(all(len(v) == steps for v in logged.values()),
              f"ssl: {[len(v) for v in logged.values()]} logged steps, expected {steps}")
        check(all(math.isfinite(x) for v in logged.values() for x in v),
              f"ssl: non-finite loss terms {logged}")
        student, teacher = passes["student"], passes["teacher"]
        check(student["forwards"] == (2 + locals_) * steps and teacher["forwards"] == 2 * steps,
              f"ssl: {student['forwards']} student and {teacher['forwards']} teacher forwards "
              f"in {steps} steps")
        # K1: every student pass records a graph (lse), the teacher's none;
        # the encoder's windows of 1024 on bf16_large, the decoder's 48 on
        # bf16_small
        for name, r, forwards, lse in (("student", student, (2 + locals_) * steps, True),
                                       ("teacher", teacher, 2 * steps, False)):
            got = {v: n for v, n in r["variants"].items() if n}
            want = dict(bf16_large=enc * forwards, bf16_small=dec * forwards)
            check(got == want, f"ssl: {name} K1 variant launches {got}, expected {want}")
            got_lse = {v: n for v, n in r["lse_variants"].items() if n}
            check(got_lse == (want if lse else {}),
                  f"ssl: {name} K1 launches with lse {got_lse}")
        k1 = fwa.flash_window_attention.launches
        check(k1 == (enc + dec) * (4 + locals_) * steps,
              f"ssl: K1 launched {k1} times, not all inside the backbones' forwards")
        # K2: the globals' encoder and decoder, the locals' encoder (their
        # decoder output takes no gradient)
        k2_want = dict(bf16_large=enc * (2 + locals_) * steps, bf16_small=dec * 2 * steps)
        got = {v: n for v, n in k2_variants.items() if n}
        check(got == k2_want, f"ssl: K2 variant launches {got}, expected {k2_want}")
        # pooling overflow: the file's capacities (1/2 to 1/16 of the crop's
        # slots) against the clusters of each crop; the JAX package drops the
        # clusters past them unseen, the port counts them. Per crop kind and
        # stage: the most clusters lost in a row and their share
        overflow = {}
        for r in (student, teacher):
            for p in r["passes"]:
                kind = "global" if p["sizes"][0][0] == cfg.data.num_points else "local"
                rows = overflow.setdefault(kind, [[0, 0.0] for _ in p["overflow"]])
                for stage, (o, c) in enumerate(zip(p["overflow"], p["clusters"])):
                    rows[stage][0] = max(rows[stage][0], int(o.max()))
                    rows[stage][1] = max(rows[stage][1], (o / c.clamp(min=1)).max().item())
        lost = {k: [o for o, _ in v] for k, v in overflow.items()}
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        check(os.path.exists(os.path.join(model_dir, "model_last.pth")),
              "ssl: no checkpoint written")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_last.pth"),
                                 os.path.join(work, "ssl_model_last.pth"))
        last = student["passes"][-(2 + locals_):]
        stage_slots_valid = [[(n, v.tolist()) for n, v in p["sizes"]] for p in last]
        emit(dict(phase="ssl_train", config=SSL_CONFIG, batch_size=batch,
                  batch_cut="the file's batch_size 24 (8 a card x 3 cards) cut to "
                            f"{batch} on one card",
                  global_points=cfg.data.num_points, local_points=cfg.data.num_points_local,
                  local_crop_num=locals_, steps=steps, **logged, lr=hist("lr").values(),
                  momentum=[e["momentum"] for e in ema.errors], ema_check=ema.errors,
                  cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  peak_mem_gib=peak_gib,
                  k1_student_variant_launches=student["variants"],
                  k1_student_lse_variant_launches=student["lse_variants"],
                  k1_teacher_variant_launches=teacher["variants"],
                  k1_teacher_lse_variant_launches=teacher["lse_variants"],
                  k1_launches_per_step=k1 / steps, k2_variant_launches=dict(k2_variants),
                  k2_launches_per_step=sum(k2_variants.values()) / steps,
                  n_overflow_per_stage=lost,
                  overflow_share_per_stage={k: [f for _, f in v] for k, v in overflow.items()},
                  stage_slots_valid_last_step=stage_slots_valid,
                  dataset_write_s=data_s, profile=probe.profile))
        # the one loss the file's capacities are known to take: a crop's 4 cm
        # cells past its first pooling's 1/2 (up to 32% of a local crop's, 1%
        # of a global's; ROADMAP Queue 3); no later stage may lose any
        check(not any(o for v in lost.values() for o in v[1:]),
              f"ssl: pooling overflow beyond the first stage: {lost}")
        warm = step_ms[1:-1] or step_ms
        print(f"ssl_train: loss {logged['loss'][-1]:.4f} after {steps} steps, warm step "
              f"{min(warm):.0f}-{max(warm):.0f} ms, peak {peak_gib:.2f} GiB", flush=True)
        shapes = ssl_stage_shapes(backbone, student, locals_)
        # the teacher's K1 calls, without lse: the last step's first global
        # crop's stages, for both of its passes
        first = teacher["passes"][-2]
        teacher_shapes = [sh[:5] + (2 * sh[5],) for sh in stage_shapes(
            backbone, [(n, v.tolist()) for n, v in first["sizes"]])]
        counts = dict(student_lse=student["lse_variants"], teacher=teacher["variants"],
                      k1=k1, k2=dict(k2_variants), steps=steps)
        del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return shapes, counts, checkpoint, teacher_shapes


def ssl_rows(n, n_local, seed=19):
    """Two rows of the SSL batch: 2 global crops of ``n`` points and 3
    local crops of ``n_local``, each a room small enough that its 4 cm
    cells fit the first pooling; numpy arrays [2, points, ...] under
    ``<crop>_<key>``."""
    rng = np.random.default_rng(seed)
    batch = {}
    for prefix, points, size in (("global_crop0", n, 1.8), ("global_crop1", n, 1.8),
                                 ("local_crop0", n_local, 0.9), ("local_crop1", n_local, 0.9),
                                 ("local_crop2", n_local, 0.9)):
        rows = [room_scene(rng, points, (size,) * 3) for _ in range(2)]
        for i, key in enumerate(("coord", "feat", "grid_coord")):
            batch[f"{prefix}_{key}"] = np.stack([r[i] for r in rows])
        batch[f"{prefix}_mask"] = np.ones((2, points), bool)
    return batch


def phase_ssl_agree(n=24576, n_local=6144):
    """One fp32 SSL loss and its gradients of the SSL file's model at one
    block a stage with mean pooling (its widths, heads and windows kept),
    batch 2, two global crops of ``n`` points with injected token masks and
    three local crops of ``n_local``, with the kernels and with the plain
    attention; each loss term's gradient apart."""
    cfg = Config.fromfile(SSL_CONFIG)
    # mean pooling in place of the file's max: which point is a cluster's
    # max is a discontinuous function of the features, and an attention
    # output a few ulps off flips near-ties, moving some gradients by 1e-3
    # on either path (the kernels' or the plain path's own under one ulp);
    # max pooling runs as the file has it in ssl_train and against JAX in
    # tests/test_torch_ssl.py
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4,
                    pool_reduce="mean")
    batch = cuda_batch(ssl_rows(n, n_local))
    gen = torch.Generator(device="cuda").manual_seed(5)
    for prefix in ("global_crop0", "global_crop1"):
        tm, w = generate_token_masks(gen, batch[f"{prefix}_coord"], batch[f"{prefix}_mask"],
                                     mask_sample_probability=1.0)
        batch[f"{prefix}_token_mask"], batch[f"{prefix}_mask_weight"] = tm, w

    # the expansion term's gradient at the student's DINO heads: each
    # path's own is as ill-conditioned as I + 2560 cov (eigenvalues 1 to
    # about 5,100 at two rows); the first step's is given to both, so what
    # is compared is the heads' and the backbones' backward, where the
    # kernels are
    cotangent = []

    def step(use_kernel):
        model, loss_kwargs = build_ssl_model(dict(cfg.model, backbone=dict(
            backbone, dtype="float32", seed=1, use_kernel=use_kernel)))
        model = model.cuda().train()
        passes = record_passes(model)
        heads, head = [], model.dino_head.forward

        def recording(x):
            y = head(x)
            if torch.is_grad_enabled():  # the student's
                heads.append(y)
            return y

        model.dino_head.forward = recording
        loss, metrics = ssl_loss(model, batch, torch.Generator(device="cuda").manual_seed(13),
                                 **loss_kwargs)
        if not cotangent:
            cotangent.extend(torch.autograd.grad(metrics["mcr_expa_loss"], heads,
                                                 retain_graph=True))
        named = [(k, p) for k, p in model.named_parameters() if p.requires_grad]
        grads = {}
        for term, out, cot in (("mcr_comp_loss", metrics["mcr_comp_loss"], None),
                               ("sim_ibot_patch_loss", metrics["sim_ibot_patch_loss"], None),
                               ("global_mae_loss", metrics["global_mae_loss"], None),
                               ("mcr_expa_loss", heads, cotangent)):
            got = torch.autograd.grad(out, [p for _, p in named], grad_outputs=cot,
                                      retain_graph=True, allow_unused=True)
            grads.update({f"{term}/{k}": g for (k, _), g in zip(named, got) if g is not None})
        overflow = [max(int(o.max()) for p in r["passes"] for o in p["overflow"])
                    for r in passes.values()]
        return {k: v.item() for k, v in metrics.items()}, grads, overflow

    enc, dec = depth_split(backbone)
    # K2: the compression's and the expansion's backward each reach the
    # encoders of all five student passes, the iBOT term's the globals'
    # encoders and decoders, the MAE term's the first global's
    compare_train_steps("ssl_agree", step, ((enc + dec) * 7, enc * 5 * 2 + (enc + dec) * 3),
                        points=dict(global_crop=n, local_crop=n_local, batch=2),
                        config=SSL_CONFIG, enc_depths=backbone["enc_depths"],
                        dec_depths=backbone["dec_depths"], token_masks="injected",
                        passes="2 teacher, 2 masked global, 3 local",
                        grads="per term; the expansion's from one cotangent at the heads")
    gc.collect()  # the recorders' closures hold the models in cycles
    torch.cuda.empty_cache()


# ---- pretraining to fine-tuning, data parallel semseg and SSL, remat ----------

STEM = "backbone.embedding.stem.conv.weight"
SSL_DDP_LR = 0.01  # SGD, so a step's student (and the EMA'd teacher) moves smoothly


class LogLines(logging.Handler):
    """The messages a logger emits while the handler is attached."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def check_warm_start(phase, after, init, source, lines):
    """A non-strict load of ``source`` into a model whose state was ``init``
    and is ``after``: every source tensor whose name and shape the model
    has is loaded bit for bit, every other model tensor kept its
    initialization, and ``lines`` (the loader's log) name each tensor
    skipped and each one kept. Returns the record."""
    loaded = sorted(k for k, v in source.items()
                    if k in after and tuple(v.shape) == tuple(after[k].shape))
    skipped = sorted(k for k in source if k not in set(loaded))
    kept = sorted(k for k in after if k not in set(loaded))
    for k in loaded:
        check(torch.equal(after[k].cpu(), source[k].cpu()), f"{phase}: {k} not loaded bit for bit")
    for k in kept:
        check(torch.equal(after[k].cpu(), init[k].cpu()), f"{phase}: {k} left its initialization")
    text = "\n".join(lines)
    unlogged = [k for k in skipped if f"skipped {k}:" not in text] + [
        k for k in kept if f"kept the initialization of {k}" not in text]
    check(not unlogged, f"{phase}: the log does not name {unlogged[:5]}")
    return dict(loaded=len(loaded), model_tensors=len(after), skipped=skipped, kept=kept)


class WarmStartProbe(HookBase):
    """Inserted right after the trainer's CheckpointLoader: reads the
    model's state after the load (check_warm_start against ``source`` and
    the state the trainer built) and the loader's log lines."""

    def __init__(self, source):
        self.source, self.record = source, None

    def insert(self, trainer):
        self.trainer = trainer
        self.init = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        (i,) = [i for i, h in enumerate(trainer.hooks) if type(h).__name__ == "CheckpointLoader"]
        trainer.hooks.insert(i + 1, self)
        self.log = LogLines()
        trainer.logger.addHandler(self.log)

    def before_train(self):
        self.trainer.logger.removeHandler(self.log)
        after = {k: v.detach().cpu() for k, v in self.trainer.model.state_dict().items()}
        self.record = check_warm_start("warm_start", after, self.init, self.source,
                                       self.log.lines)


def phase_warm_start(work, ssl_checkpoint, flagship_checkpoint):
    """``python -m scenesplat_tpu_torch.rename_ckpt`` on ssl_train's last
    checkpoint (the SSL file at its widths) for the teacher and for the
    student: each output holds that backbone's tensors as ``backbone.*``,
    bit for bit, without the mask token. Then non-strict loads as the
    files' CheckpointLoader makes them: the train phase's flagship
    checkpoint into the semseg file's model and the extracted teacher into
    the flagship file's (every encoder tensor of stages 0-3 loads; the rest
    are skipped or kept, and logged). semseg_train starts from the teacher.
    Returns the teacher's file."""
    from scenesplat_tpu_torch import rename_ckpt
    from scenesplat_tpu_torch.engines.hooks.misc import load_matching

    ssl_state = torch.load(ssl_checkpoint, map_location="cpu", weights_only=False)["state_dict"]
    out, record = {}, dict(phase="warm_start", ssl_checkpoint="ssl_train's model_last.pth")
    for source, prefix in (("teacher", "teacher."), ("student", "backbone.")):
        path = os.path.join(work, f"ssl_{source}_backbone.pth")
        t0 = time.perf_counter()
        check(rename_ckpt.main(["--input", ssl_checkpoint, "--output", path,
                                "--source", source]) == 0, f"warm_start: {source} extraction")
        record[f"{source}_extract_s"] = time.perf_counter() - t0
        got = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
        want = {"backbone." + k[len(prefix):]: v for k, v in ssl_state.items()
                if k.startswith(prefix) and k != prefix + "mask_token"}
        check(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want),
              f"warm_start: the {source} extraction differs from the checkpoint's {prefix}*")
        record[f"{source}_tensors"] = len(got)
        out[source] = got
    check(any(not torch.equal(v, out["student"][k]) for k, v in out["teacher"].items()),
          "warm_start: the teacher equals the student after ssl_train's steps")
    logger = logging.getLogger("chip_smoke.warm_start")
    logger.setLevel(logging.INFO)
    encoders = tuple(f"backbone.enc.enc{s}." for s in range(4))
    for name, weight, config in (("flagship_to_semseg", flagship_checkpoint, SEMSEG_CONFIG),
                                 ("teacher_to_flagship", os.path.join(
                                     work, "ssl_teacher_backbone.pth"), FLAGSHIP_CONFIG)):
        model_cfg = dict(Config.fromfile(config).model)
        model_cfg.pop("criteria", None)
        model = build_model(model_cfg)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        source = torch.load(weight, map_location="cpu", weights_only=False)["state_dict"]
        log = LogLines()
        logger.addHandler(log)
        try:
            load_matching(model, source, logger)
        finally:
            logger.removeHandler(log)
        after = model.state_dict()
        rec = check_warm_start(name, after, init, source, log.lines)
        missing = [k for k in after if k.startswith(encoders) and k in rec["kept"]]
        check(not missing, f"{name}: encoder tensors not loaded: {missing[:5]}")
        record[name] = dict(rec, skipped=len(rec["skipped"]), kept=len(rec["kept"]),
                            stem_loaded=STEM not in rec["kept"],
                            first_skipped=rec["skipped"][:8], first_kept=rec["kept"][:8])
        del model
    emit(record)
    return os.path.join(work, "ssl_teacher_backbone.pth")


def semseg_fp32_model(**backbone):
    """The semseg file's DefaultSegmentorV2 at one block a stage (its
    widths, heads, windows and drop-path kept) in fp32 from seed 1, on the
    card in train mode, and the file's criteria (CE + Lovasz)."""
    cfg = Config.fromfile(SEMSEG_CONFIG)
    model_cfg = dict(cfg.model)
    criteria = build_criteria(model_cfg.pop("criteria"))
    model = build_model(dict(model_cfg, backbone=dict(
        cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4, dtype="float32", seed=1,
        **backbone)))
    return model.cuda().train(), criteria


def ssl_fp32_model():
    """The SSL file's SimDINOSSL at one block a stage with mean pooling (as
    ssl_agree), drop-path 0.3 as the file sets it, fp32 from seed 1, on the
    card; and the loss's keyword arguments."""
    cfg = Config.fromfile(SSL_CONFIG)
    backbone = dict(cfg.model.backbone, enc_depths=(1,) * 5, dec_depths=(1,) * 4,
                    pool_reduce="mean", dtype="float32", seed=1)
    model, loss_kwargs = build_ssl_model(dict(cfg.model, backbone=backbone))
    return model.cuda().train(), loss_kwargs, cfg.model.get("momentum_base", 0.994)


def expansion_cotangent(batch):
    """The MCR expansion term's gradient at the student's DINO head outputs
    (one [rows, D] a crop, zeros for the local crops, which it does not
    read) in one process's forward of ssl_fp32_model over ``batch`` with
    the generator ssl_step_fp32 seeds."""
    model, loss_kwargs, _ = ssl_fp32_model()
    heads, head = [], model.dino_head.forward

    def recording(x):
        y = head(x)
        if torch.is_grad_enabled():  # the student's
            heads.append(y)
        return y

    model.dino_head.forward = recording
    _, metrics = ssl_loss(model, batch, torch.Generator(device="cuda").manual_seed(13),
                          **loss_kwargs)
    got = torch.autograd.grad(metrics["mcr_expa_loss"], heads, allow_unused=True)
    return [torch.zeros_like(h) if g is None else g.detach() for h, g in zip(heads, got)]


@contextlib.contextmanager
def given_expansion_cotangent(cotangent):
    """The SSL loss's MCR with the expansion term's backward replaced by
    ``cotangent`` (expansion_cotangent's, rows of the global batch; each
    process takes its rows): the same values, and the same well-posed
    gradient on every path. The expansion's own gradient goes through the
    inverse of I + p / (m eps) cov, whose condition number (about 5,100 at
    two rows, see ssl_agree) turns the summation-order differences of two
    ranks against one process into gradient differences above 1e-4; what
    ssl_ddp_agree compares is the data-parallel backward of the heads and
    the backbones. The loss's own reduction over the ranks is held to JAX
    in tests/test_torch_dist_tasks.py."""
    import scenesplat_tpu_torch.engines.pretrain as pretrain

    real = pretrain.mcr_loss

    def mcr(student_feats, teacher_feats):
        _, metrics = real(student_feats, teacher_feats)
        rows = local_batch_slice(cotangent[0].shape[0])
        lin = all_reduce_sum(sum((s * c[rows]).sum() for s, c in zip(student_feats, cotangent)))
        expa = metrics["mcr_expa_loss"].detach() + lin - lin.detach()
        return -0.1 * metrics["mcr_comp_loss"] - expa, metrics  # mcr_loss's coeff 0.1

    pretrain.mcr_loss = mcr
    try:
        yield
    finally:
        pretrain.mcr_loss = real


def ssl_step_fp32(batch, cotangent, wrap=lambda m: m):
    """One ssl_train_step of ssl_fp32_model (token masks, the curve shuffle
    and drop-path drawn from a generator seeded 13; SGD at SSL_DDP_LR; the
    EMA at the file's first momentum) through its SSLObjective wrapped by
    ``wrap``, the MCR expansion's cotangent given
    (given_expansion_cotangent). Returns (loss terms, student gradients,
    BatchNorm running statistics, teacher parameters after the EMA, whether
    the teacher's mask token stayed, pooling overflow)."""
    model, loss_kwargs, momentum = ssl_fp32_model()
    token = model.teacher.mask_token.detach().clone()
    passes = record_passes(model)
    optimizer = torch.optim.SGD([p for p in model.parameters() if p.requires_grad],
                                lr=SSL_DDP_LR)
    with given_expansion_cotangent(cotangent):
        metrics = ssl_train_step(wrap(SSLObjective(model)), optimizer, None, batch, momentum,
                                 generator=torch.Generator(device="cuda").manual_seed(13),
                                 **loss_kwargs)
    overflow = [max(int(o.max()) for p in r["passes"] for o in p["overflow"])
                for r in passes.values()]
    return ({k: v.item() for k, v in metrics.items()},
            {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: v.detach().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))},
            {k: p.detach().clone() for k, p in model.teacher.named_parameters()},
            torch.equal(model.teacher.mask_token, token), overflow)


def task_agree_rank(rank, world, port, job_file):
    """One rank of phase_task_ddp_agree (a spawned process sharing the one
    card over gloo): its rows of the job's global batch through one fp32
    step under DDP; writes the step's results and its K1 / K2 launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_file, weights_only=False)
    with torchrun_env(rank, world, port):
        init_distributed("cuda", backend="gloo")
        try:
            reset_k1_counts()
            reset_k2_counts()
            rows = {k: v[local_batch_slice(len(v))] for k, v in job["rows"].items()}
            if job["task"] == "semseg":
                loss, norm, grads, stats, overflow = train_step_fp32(
                    cuda_batch(rows), data_parallel, build=semseg_fp32_model, task="semseg",
                    seed=12)
                out = dict(loss=loss, grad_norm=norm, overflow=overflow)
            else:
                terms, grads, stats, teacher, token_kept, overflow = ssl_step_fp32(
                    cuda_batch(rows), [c.cuda() for c in job["cotangent"]], data_parallel)
                out = dict(terms=terms, teacher={k: v.cpu() for k, v in teacher.items()},
                           token_kept=token_kept, overflow=overflow)
            out.update(grads={k: g.cpu() for k, g in grads.items()},
                       stats={k: v.cpu() for k, v in stats.items()},
                       k1_lse=k1_lse_variants(), k1=k1_variants(),
                       k2=dict(fwa.flash_window_attention_bwd.variant_launches))
            torch.save(out, job["out"].format(rank=rank))
        finally:
            torch.distributed.destroy_process_group()


STAT_RTOL_DDP = 1e-6


def check_ranks_stats(phase, r, got, ref):
    """Each BatchNorm running statistic of rank ``r`` within STAT_RTOL_DDP
    (relative L2) of one process's; returns the worst."""
    err = {k: rel_l2(v, ref[k].cpu()) for k, v in got.items()}
    check(sorted(err) == sorted(ref) and max(err.values()) <= STAT_RTOL_DDP,
          f"{phase}: rank {r}'s BatchNorm statistics differ by {max(err.values())}")
    return max(err.values())


def phase_task_ddp_agree(work, task, world=2):
    """semseg_ddp_agree / ssl_ddp_agree: two ranks sharing the one card over
    gloo, one row each, against one process over both rows, fp32 at the
    file's widths with one block a stage. semseg: CE + Lovasz (the gather of
    every rank's probabilities), 2 rows of 49,152 points, drop-path 0.3, no
    Mix3D; the loss to 1e-5, every gradient to 1e-4 of its norm, the
    BatchNorm statistics to 1e-6. ssl: crops of 24,576 and 6,144 (as
    ssl_agree), token masks drawn at the global batch's shape; every loss
    term to 1e-5, every student gradient to 1e-4 of its norm, the
    statistics to 1e-6, and after the SGD step and the EMA the teacher
    bit-equal on both ranks and within 1e-6 of one process's, its mask token
    unmoved (the MCR expansion's cotangent at the heads given to both sides,
    as in ssl_agree: given_expansion_cotangent). K1 with lse and K2 launch
    on each rank."""
    phase = f"{task}_ddp_agree"
    rows = semseg_rows(49152, (13, 14)) if task == "semseg" else ssl_rows(24576, 6144)
    batch = cuda_batch(rows)
    if task == "semseg":
        loss, norm, grads, stats, overflow = train_step_fp32(batch, build=semseg_fp32_model,
                                                             task="semseg", seed=12)
        ref = (loss, {k: g.cpu() for k, g in grads.items()}, overflow)
    else:
        cotangent = expansion_cotangent(batch)
        terms, grads, stats, teacher, token_kept, overflow = ssl_step_fp32(batch, cotangent)
        check(token_kept, f"{phase}: one process's teacher mask token moved")
        ref = (terms, {k: g.cpu() for k, g in grads.items()}, overflow)
        teacher = {k: v.cpu() for k, v in teacher.items()}
    del grads, batch
    gc.collect()
    torch.cuda.empty_cache()
    job_file = os.path.join(work, f"{phase}_job.pt")
    torch.save(dict(task=task, rows=rows, out=os.path.join(work, f"{phase}_rank{{rank}}.pt"),
                    cotangent=None if task == "semseg" else [c.cpu() for c in cotangent]),
               job_file)
    ranks_s = spawn_ranks(task_agree_rank, world, job_file)
    ranks = [torch.load(os.path.join(work, f"{phase}_rank{r}.pt"), weights_only=False)
             for r in range(world)]
    record = dict(phase=phase, world=world, backend="gloo", rows=world, dtype="float32",
                  drop_path=0.3, ranks_s=ranks_s, stat_rtol=STAT_RTOL_DDP)
    for r, got in enumerate(ranks):
        loss_r = got["loss"] if task == "semseg" else got["terms"]
        compare_steps(f"{phase}_rank{r}", (loss_r, got["grads"], got["overflow"]), ref,
                      names=("ranks", "one"), world=world, backend="gloo")
        if task == "ssl":
            for key, value in ref[0].items():
                check(abs(loss_r[key] - value) <= TRAIN_LOSS_RTOL * abs(value),
                      f"{phase}: rank {r}'s {key} {loss_r[key]} against {value}")
            err = max((got["teacher"][k] - v).abs().max().item() for k, v in teacher.items())
            check(err <= 1e-6, f"{phase}: rank {r}'s teacher differs by {err} from one process's")
            check(got["token_kept"], f"{phase}: rank {r}'s teacher mask token moved")
            record.setdefault("teacher_max_abs_diff", []).append(err)
            for k, v in ranks[0]["teacher"].items():
                check(torch.equal(v, got["teacher"][k]),
                      f"{phase}: rank {r}'s teacher {k} differs from rank 0's")
        record.setdefault("stat_worst_rel_l2", []).append(
            check_ranks_stats(phase, r, got["stats"], stats))
        k1_lse, k2 = sum(got["k1_lse"].values()), sum(got["k2"].values())
        check(k1_lse > 0 and k2 > 0, f"{phase}: rank {r} launched K1 with lse {k1_lse} and K2 "
              f"{k2} times")
        record.setdefault("k1_lse", []).append(k1_lse)
        record.setdefault("k1_without_lse", []).append(sum(got["k1"].values()) - k1_lse)
        record.setdefault("k2", []).append(k2)
        for key, g in ranks[0]["grads"].items():
            check(torch.equal(g, got["grads"][key]),
                  f"{phase}: rank {r}'s {key} gradient differs from rank 0's")
    record.update(loss=[got.get("loss", got.get("terms")) for got in ranks], loss_one=ref[0])
    emit(record)
    return dict(k1_lse=sum(record["k1_lse"]), k1=sum(record["k1_without_lse"]),
                k2=sum(record["k2"]),
                k1_lse_variants=sum_counts(got["k1_lse"] for got in ranks),
                k2_variants=sum_counts(got["k2"] for got in ranks))


REMAT_GRAD_RTOL = 1e-5


def phase_remat_agree(n=49152):
    """The flagship file at its widths, one fp32 train step of 2 rows of
    ``n`` points (drop-path 0.3, the curve shuffle and the contrastive split
    drawn) with remat_blocks off and on, from the same weights and
    generator seed, both under deterministic algorithms (the pooling's
    scatter-adds in one order): the loss bit-equal, every gradient within
    REMAT_GRAD_RTOL of its norm, K1 / K2 launches (with remat, each block's
    recompute in the backward launches K1 with lse once more); then each
    model's step again without the deterministic mode for its time (CUDA
    events) and peak memory (the model's parameters included)."""
    batch = cuda_batch(agree_rows(n, (7, 8)))
    blocks = sum(depth_split(Config.fromfile(FLAGSHIP_CONFIG).model.backbone))
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for remat in (False, True):
            built = flagship_fp32_model(remat_blocks=remat)
            gc.collect()
            torch.cuda.empty_cache()
            reset_k1_counts()
            reset_k2_counts()
            loss, norm, grads, _, overflow = train_step_fp32(batch, build=lambda: built)
            runs[remat] = dict(loss=loss, grad_norm=norm, overflow=overflow,
                               grads={k: g.detach().clone() for k, g in grads.items()},
                               k1_lse=sum(k1_lse_variants().values()),
                               k1=fwa.flash_window_attention.launches,
                               k2=fwa.flash_window_attention_bwd.launches)
            del grads
            # the same step again as a user runs it (not deterministic): its
            # time (CUDA events) and peak memory (the model's parameters
            # included)
            torch.use_deterministic_algorithms(False)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            train_step_fp32(batch, build=lambda: built)
            end.record()
            torch.cuda.synchronize()
            runs[remat].update(step_ms=start.elapsed_time(end),
                               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            torch.use_deterministic_algorithms(True, warn_only=True)
            del built
    finally:
        torch.use_deterministic_algorithms(False)
    off, on = runs[False], runs[True]
    worst = max(rel_l2(on["grads"][k], g) for k, g in off["grads"].items()
                if g.norm() > ZERO_GRAD * off["grad_norm"])
    record = dict(phase="remat_agree", config=FLAGSHIP_CONFIG, dtype="float32", points=n,
                  rows=2, deterministic_algorithms=True, grad_rtol=REMAT_GRAD_RTOL,
                  worst_grad_rel_l2=worst, loss_bit_equal=on["loss"] == off["loss"],
                  **{f"remat_{name}": {k: v for k, v in run.items() if k != "grads"}
                     for name, run in (("off", off), ("on", on))})
    emit(record)
    check(on["loss"] == off["loss"], f"remat_agree: loss {on['loss']} against {off['loss']}")
    check(worst <= REMAT_GRAD_RTOL, f"remat_agree: a gradient differs by {worst}")
    check(not any(on["overflow"] + off["overflow"]), "remat_agree: pooling overflow")
    check(off["k1_lse"] == off["k2"] == blocks and on["k2"] == blocks
          and on["k1_lse"] == 2 * blocks,
          f"remat_agree: K1 with lse {off['k1_lse']} / {on['k1_lse']} and K2 {off['k2']} / "
          f"{on['k2']} a step without / with remat, expected {blocks} / {2 * blocks} and "
          f"{blocks}")
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return dict(off=dict(k1_lse=off["k1_lse"], k2=off["k2"]),
                on=dict(k1_lse=on["k1_lse"], k2=on["k2"]))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuBLAS's deterministic workspace, for the test phase's two compared
    # runs; cuBLAS reads it when its handle is made, so it holds for every
    # phase (the device phase's record says so)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        meta_root = os.path.join(work, "metadata")
        write_meta(meta_root)
        os.environ["SCENESPLAT_META_ROOT"] = meta_root  # the flagship config reads it
        smi = phase_device()
        worst32 = phase_kernel()
        text = load_text_embeddings("builtin:scannet200")
        shapes, launches, serve_variants = phase_serve(text)
        tot = phase_timing(shapes)
        phase_shipped(text)
        phase_agree(text)
        worst_bwd, worst_fwd_lse = phase_kernel_bwd()
        train_shapes, k1_train, k1_val, k1_variants_train, k2_variants, checkpoint, plain = \
            phase_train(work)
        tot_bwd = phase_timing_bwd(train_shapes)
        phase_train_agree()
        ddp_record, ddp_checkpoint = phase_ddp_train(work, plain)
        ddp_ranks = phase_ddp_agree(work, ddp_checkpoint, meta_root)
        worst_sort = phase_kernel_sort()
        sort_calls, sort_kernels, fragments, sort_sizes, test_variants, test_shapes = \
            phase_test(work, checkpoint, meta_root)
        tot_sort = phase_timing_sort(sort_sizes)
        tot_test = phase_timing_test(test_shapes)
        ssl_shapes, ssl_counts, ssl_checkpoint, teacher_shapes = phase_ssl_train(work)
        ssl_bwd = phase_timing_bwd(ssl_shapes, phase="ssl_timing_bwd")
        ssl_teacher = phase_timing(teacher_shapes, phase="ssl_timing_teacher")
        phase_ssl_agree()
        teacher_weight = phase_warm_start(work, ssl_checkpoint, checkpoint)
        semseg_shapes, semseg_k1, semseg_k1_variants, semseg_k2_variants, semseg_checkpoint = \
            phase_semseg_train(work, teacher_weight)
        semseg_bwd = phase_timing_bwd(semseg_shapes, phase="semseg_timing_bwd")
        phase_semseg_agree()
        semseg_on, semseg_fragments, semseg_sort_sizes, semseg_calls = \
            phase_semseg_test(work, semseg_checkpoint)
        semseg_fwd = phase_timing_test(semseg_calls, phase="semseg_timing_test")
        semseg_sort = phase_timing_sort(semseg_sort_sizes, phase="semseg_timing_sort")
        tasks_ddp = {task: phase_task_ddp_agree(work, task) for task in ("semseg", "ssl")}
        remat = phase_remat_agree()
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)
    source = "scenesplat_tpu_torch/csrc/flash_window_attn.cu"
    # bf16 at windows of at most 64: the decoder's launches of the train and
    # test paths
    source_small = "scenesplat_tpu_torch/csrc/flash_window_attn_fwd_small.cu"
    # the bf16 backward; flash_window_attn.cu holds its fp32 twin
    source_bwd = "scenesplat_tpu_torch/csrc/flash_window_attn_bwd.cu"
    # bf16 at windows of 128 and more: every launch of the serve path, and
    # the encoder's launches of the train path
    source_large = "scenesplat_tpu_torch/csrc/flash_window_attn_fwd.cu"
    # launches: the count of the path's run (4 serve forwards, 6 train
    # steps, the test run's fragment forwards with the sort switch on); ms
    # and the other times: per forward or per step (18 attention launches, 8
    # sorts; the small forward: the decoder's 6 launches of a test fragment
    # forward). "semseg": the same for the semseg file's path (6 train
    # steps of 22 attention launches; the test run's fragment forwards, the
    # first one's 14 encoder and 8 decoder launches timed, 10 sorts)

    def times(t, pre=""):
        """A timing phase's sums, of the forward with lse with pre "fwd_"."""
        return dict(ms=t["fwd_lse_ms" if pre else "ms"], plain_ms=t[pre + "plain_ms"],
                    bound_ms=t[pre + "bound_ms"], bound_by=t[pre + "bound_by"],
                    library_ms=t[pre + "library_ms"])

    semseg_test = dict(path="semseg test", fragment_forwards=semseg_fragments,
                       ms_per="test fragment forward (the first fragment's calls, no lse)")
    semseg_train = dict(path="semseg train", ms_per="train step")
    # "ssl": the SSL file's path, 6 train steps of 7 backbone passes; ms
    # and the other times per step (timing at the student's shapes: the
    # globals' 22 launches twice, the locals' 22 forward and 14 backward
    # launches three times); the teacher's launches, without lse, are
    # counted apart
    ssl_train = dict(path="ssl train", ms_per="train step", steps=ssl_counts["steps"])
    ssl_small = ssl_bwd["fwd_by_variant"]["bf16_small"]
    # "ddp": data parallel, the flagship trainer under DDP at one process
    # (NCCL, 6 steps and one validation, as "train") and the two ranks of
    # ddp_agree on the one card (gloo: one fp32 step each, then their share
    # of the 3 test scenes' fragment forwards), launches summed over ranks
    ddp = dict(path="ddp train", ms_per="train step", world1_steps=ddp_record["steps"])
    # the semseg and SSL files' fp32 steps under two ranks on the one card
    # (semseg_ddp_agree, ssl_ddp_agree), launches summed over the ranks; and
    # remat_agree's flagship fp32 step without and with remat_blocks (the
    # recompute launches K1 with lse once more a block)
    ddp_tasks = {f"{task}_two_rank_launches": tasks_ddp[task]["k1_lse"] for task in tasks_ddp}
    ddp_tasks_k2 = {f"{task}_two_rank_launches": tasks_ddp[task]["k2"] for task in tasks_ddp}
    teacher_large = ssl_teacher["by_variant"]["bf16_large"]
    teacher_small = ssl_teacher["by_variant"]["bf16_small"]
    emit({"kernels": [
        dict(name="flash_window_attention_fwd", route="cuda", source=source_large,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="serve",
             launches=launches, variant_launches=serve_variants,
             ms_per="serve forward", max_abs_err=worst32, ms=tot["ms"],
             plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=tot["bound_by"],
             library_ms=tot["library_ms"],
             semseg=dict(semseg_test, launches=semseg_on["k1_variants"]["bf16_large"],
                         **times(semseg_fwd["by_variant"]["bf16_large"])),
             ssl_teacher=dict(ssl_train, ms_per="train step (the teacher's 2 passes over the "
                              "global crops, no lse; its encoder's windows of 1024)",
                              launches=ssl_counts["teacher"]["bf16_large"],
                              **times(teacher_large))),
        dict(name="flash_window_attention_fwd_lse", route="cuda", source=source_small,
             sources=[source_small, source_large, source],
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="train",
             launches=k1_train, validation_launches=k1_val,
             variant_launches=k1_variants_train, ms_per="train step",
             max_abs_err=worst_fwd_lse,
             ms=tot_bwd["fwd_lse_ms"], plain_ms=tot_bwd["fwd_plain_ms"],
             bound_ms=tot_bwd["fwd_bound_ms"], bound_by=tot_bwd["fwd_bound_by"],
             library_ms=tot_bwd["fwd_library_ms"],
             semseg=dict(semseg_train, launches=semseg_k1, variant_launches=semseg_k1_variants,
                         by_variant=semseg_bwd["fwd_by_variant"], **times(semseg_bwd, "fwd_")),
             ssl=dict(ssl_train, launches=sum(ssl_counts["student_lse"].values()),
                      variant_launches=ssl_counts["student_lse"],
                      teacher_launches_without_lse=sum(ssl_counts["teacher"].values()),
                      teacher_variant_launches=ssl_counts["teacher"],
                      by_variant=ssl_bwd["fwd_by_variant"], **times(ssl_bwd, "fwd_")),
             ddp=dict(ddp, launches=ddp_record["k1_launches"] + ddp_ranks["k1_lse"],
                      world1_launches=ddp_record["k1_launches"],
                      world1_variant_launches=ddp_record["k1_variant_launches"],
                      world1_validation_launches=ddp_record["validation_k1_launches"],
                      two_rank_launches=ddp_ranks["k1_lse"],
                      two_rank_variant_launches=ddp_ranks["k1_lse_variants"],
                      two_rank_test_launches_without_lse=ddp_ranks["k1_test"],
                      two_rank_test_variant_launches=ddp_ranks["k1_test_variants"],
                      **ddp_tasks),
             remat=dict(path="remat_agree", ms_per="fp32 train step",
                        launches_per_step_off=remat["off"]["k1_lse"],
                        launches_per_step_on=remat["on"]["k1_lse"])),
        dict(name="flash_window_attention_fwd_small", route="cuda", source=source_small,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="test",
             launches=test_variants["bf16_small"], variant_launches=test_variants,
             fragment_forwards=fragments, train_launches=k1_variants_train["train"]["bf16_small"],
             train_step=tot_bwd["fwd_by_variant"]["bf16_small"],
             ms_per="test fragment forward (the decoder's windows of 48, no lse)",
             max_abs_err=tot_test["max_abs_err"], ms=tot_test["ms"],
             plain_ms=tot_test["plain_ms"],
             bound_ms=tot_test["bound_ms"], bound_by=tot_test["bound_by"],
             library_ms=tot_test["library_ms"],
             semseg=dict(semseg_test, launches=semseg_on["k1_variants"]["bf16_small"],
                         train_launches=semseg_k1_variants["train"]["bf16_small"],
                         train_step=semseg_bwd["fwd_by_variant"]["bf16_small"],
                         **times(semseg_fwd["by_variant"]["bf16_small"])),
             ssl=dict(ssl_train, launches=ssl_counts["student_lse"]["bf16_small"],
                      teacher_launches_without_lse=ssl_counts["teacher"]["bf16_small"],
                      ms_per="train step (the student's decoder launches, with lse)",
                      ms=ssl_small["fwd_lse_ms"], plain_ms=ssl_small["fwd_plain_ms"],
                      bound_ms=ssl_small["fwd_bound_ms"], bound_by=ssl_small["fwd_bound_by"],
                      library_ms=ssl_small["fwd_library_ms"]),
             ssl_teacher=dict(ssl_train, ms_per="train step (the teacher's 2 passes' decoder "
                              "launches, no lse)", launches=ssl_counts["teacher"]["bf16_small"],
                              **times(teacher_small))),
        dict(name="flash_window_attention_bwd", route="cuda", source=source_bwd,
             sources=[source_bwd, source],
             replaces="scenesplat_tpu/ops/pallas_attn.py:98", path="train",
             launches=sum(k2_variants.values()), variant_launches=k2_variants,
             ms_per="train step", max_abs_err=worst_bwd,
             ms=tot_bwd["ms"], plain_ms=tot_bwd["plain_ms"], bound_ms=tot_bwd["bound_ms"],
             bound_by=tot_bwd["bound_by"], library_ms=tot_bwd["library_ms"],
             design_bound_ms=tot_bwd["design_bound_ms"],
             semseg=dict(semseg_train, launches=sum(semseg_k2_variants.values()),
                         variant_launches=semseg_k2_variants, **times(semseg_bwd)),
             ssl=dict(ssl_train, launches=sum(ssl_counts["k2"].values()),
                      variant_launches=ssl_counts["k2"], **times(ssl_bwd)),
             ddp=dict(ddp, launches=ddp_record["k2_launches"] + ddp_ranks["k2"],
                      world1_launches=ddp_record["k2_launches"],
                      world1_variant_launches=ddp_record["k2_variant_launches"],
                      two_rank_launches=ddp_ranks["k2"],
                      two_rank_variant_launches=ddp_ranks["k2_variants"], **ddp_tasks_k2),
             remat=dict(path="remat_agree", ms_per="fp32 train step",
                        launches_per_step_off=remat["off"]["k2"],
                        launches_per_step_on=remat["on"]["k2"])),
        dict(name="bitonic_sort", route="cuda",
             source="scenesplat_tpu_torch/csrc/bitonic_sort.cu",
             replaces="scenesplat_tpu/ops/pallas_sort.py:146", path="test",
             launches=sort_calls, kernel_launches=sort_kernels, fragment_forwards=fragments,
             ms_per="fragment forward",
             max_abs_err=max(worst_sort, tot_sort["max_abs_err"]), ms=tot_sort["ms"],
             plain_ms=tot_sort["plain_ms"], bound_ms=tot_sort["bound_ms"], bound_by="bytes",
             library_ms=tot_sort["library_ms"],
             semseg=dict(semseg_test, ms_per="fragment forward (the first fragment's sorts)",
                         launches=semseg_on["sort_calls"],
                         kernel_launches=semseg_on["sort_kernels"], ms=semseg_sort["ms"],
                         plain_ms=semseg_sort["plain_ms"], bound_ms=semseg_sort["bound_ms"],
                         bound_by="bytes", library_ms=semseg_sort["library_ms"],
                         max_abs_err=semseg_sort["max_abs_err"]))]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--cards" and torch.cuda.is_available():
        sys.exit(main_cards(int(sys.argv[2]), sys.argv[3:]))
    sys.exit(main())
