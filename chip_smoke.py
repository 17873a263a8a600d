"""Chip smoke test of the PyTorch/CUDA port (scenesplat_tpu_torch) on one
NVIDIA H100.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. device: the card, and the kernels' build from this checkout's sources
     (one nvcc per source, started together);
  2. kernel: the flash-window attention kernel against its plain version at
     every (window, channels, heads) signature of the flagship backbone and
     of configs/test_lang_inference.py, fp32 and bf16, with partial and fully
     padded windows and a ragged last window;
  3. serve: the zero-shot serving path (FeatureExtractor -> flagship
     LangPretrainer in bf16 -> zero_shot_predict against the ScanNet200
     SigLIP2 table) at 196,608 points of a seeded synthetic room, a few
     requests, with the kernel's launches counted;
  4. timing: at the shapes and valid counts phase 3 gave each launch, the
     kernel against its plain version in bf16, then the times of the
     kernel, the plain version and scaled_dot_product_attention (the
     library yardstick, used nowhere in the port), with the least time the
     card could take for the same work;
  5. shipped: one forward of the shipped inference backbone (decoder
     windows of 48, ragged at every stage) at 65,536 points;
  6. agree: fp32 forward with the kernel against the same forward with the
     plain attention at 49,152 points;
  7. kernel_bwd: the attention backward kernel (through the autograd
     Function) against autograd through the plain version at every
     signature of phase 2, fp32 and bf16, with zero gradients in padded
     windows;
  8. train: scenesplat_tpu_torch.train's trainer on the flagship config
     (configs/concat_dataset/lang-pretrain-concat-gs-contrastive.py, read
     through the port's Config) over a synthetic 3DGS dataset written to a
     temporary directory: flagship widths, losses, optimizer, schedule,
     transforms, Mix3D and 196,608 points, batch 2, epoch 1 so the
     contrastive term is live, and the file's own hooks (the evaluator
     over one small validation scene per dataset logs val*/fg_mIoU, the
     saver writes model_best.pth, PreciseEvaluator finds no tester); 1 + 5
     steps with K1 and K2 launches counted, step times, loader waits, peak
     memory and one profiled step;
  9. timing_bwd: at the train step's stage shapes, the forward with
     log-sum-exp and the backward kernel against the plain version (bf16
     noise-floor rule, zeros in padded windows), then their times against
     the plain version, scaled_dot_product_attention's forward and backward
     (the library yardstick, used nowhere in the port) and the least time
     the card could take;
 10. train_agree: one fp32 train step of the flagship config file's model at
     49,152 points with the kernels and one with the plain attention, same
     weights and generator seeds;
 11. kernel_sort: the bitonic row sort K3 against its plain version, exact,
     at 2 and 3 operands, 1 to 3 keys, rows of 1000 to 2^20, 1 to 12 rows,
     random and heavily tied keys, and against torch.sort (equal keys;
     with the index as last key, the stable order); int64 codes with a
     sentinel tail through sort_int64 with the switch off and on;
 12. test: scenesplat_tpu_torch.test's main on the flagship config file
     plus test= and data.test= (the fragment test pipeline of
     configs/_base_/gs_pipelines.py), bf16, the train phase's checkpoint,
     over two synthetic ScanNet200-layout scenes of 320,001 Gaussians at
     1 cm spacing (2 fragments of 160,001 points each); once with
     torch.sort and once with SCENESPLAT_BITONIC_SORT=1, both under
     torch.use_deterministic_algorithms: equal predictions and metrics, K3
     launches 0 then as reckoned, K1 18 per fragment; then once more with
     torch.sort and without the deterministic mode, as a user runs it, for
     the times per scene;
 13. timing_sort: K3, torch.sort and the plain version by CUDA events at
     the eight sort shapes of one fragment forward.
Then the kernels line and, last, {"ok": true, "device": {...}}. Any failed
check raises; without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import gc
import inspect
import json
import math
import os
import shutil
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
from scenesplat_tpu_torch.engines.train import build_trainer
from scenesplat_tpu_torch.engines.train_step import lang_loss
from scenesplat_tpu_torch.entry import (
    FLAGSHIP_BACKBONE,
    SHIPPED_INFERENCE_BACKBONE,
    build_lang_model,
)
from scenesplat_tpu_torch.models import PointBatch, build_criteria, build_model
from scenesplat_tpu_torch.models.ptv3 import PointTransformerV3, _round_capacity
from scenesplat_tpu_torch.ops import bitonic_sort as bs
from scenesplat_tpu_torch.ops import flash_window_attn as fwa
from scenesplat_tpu_torch.ops.knn import knn
from scenesplat_tpu_torch.ops.serialization import SENTINEL
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


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
    libraries = (fwa.LIBRARY, bs.LIBRARY)
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
            if "registers" in ln or "spill" in ln][:24]
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
} | {(1024, c, h) for c, h in ((32, 2), (64, 4), (128, 8), (256, 16))})


def phase_kernel():
    """Kernel vs plain at every signature; returns the fp32 max abs error."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst32, rows = 0.0, []
    for k, c, h in SIGNATURES:
        n = 3 * k + k // 2 + 5  # ragged last window
        valid = torch.zeros(2, n, dtype=torch.bool, device="cuda")
        valid[0, : int(0.8 * n)] = True  # a partial window
        valid[1, : k + 7] = True  # then fully padded windows
        qkv = torch.randn(2, n, 3, c, generator=gen, device="cuda")
        out32 = fwa.flash_window_attention(qkv, valid, k, h)
        ref32 = fwa.flash_window_attention_plain(qkv, valid, k, h)
        torch.cuda.synchronize()
        check(torch.isfinite(out32).all().item(), f"non-finite output at {k, c, h}")
        err32 = (out32 - ref32)[valid].abs().max().item()
        dead = torch.zeros_like(valid)
        dead[1, -(-(k + 7) // k) * k:] = True
        check((out32[dead] == 0).all().item(), f"padded windows not zero at {k, c, h}")

        err16, floor16 = check_bf16(qkv.bfloat16(), valid, k, h)
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err=err32,
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        check(err32 <= FP32_ATOL, f"fp32 error {err32} > {FP32_ATOL} at {k, c, h}")
        worst32 = max(worst32, err32)
    emit(dict(phase="kernel", fp32_atol=FP32_ATOL, bf16_noise_factor=BF16_NOISE_FACTOR,
              cases=rows))
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
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
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
    fwa.flash_window_attention.launches = 0
    feat, pred, plans, times = serve(model, sample, text, reps)
    launches = fwa.flash_window_attention.launches
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
              n_clusters=clusters, n_overflow=overflow, peak_mem_gib=peak_gib,
              classes_predicted=len(uniq),
              class_histogram=dict(zip(uniq.tolist(), counts.tolist())),
              profile=profile))
    sizes = [(n, n)] + [(p.out_mask.shape[1], int(p.out_mask.sum())) for p in plans]
    return stage_shapes(backbone, sizes), launches


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


def phase_timing(shapes):
    """Kernel against plain (bf16 noise-floor rule), then kernel, plain and
    library times per call at the main path's shapes, and the times' sums
    over one forward."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0)
    for n, n_valid, k, c, h, count in shapes:
        qkv = torch.randn(1, n, 3, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(1, n, dtype=torch.bool, device="cuda")
        valid[0, :n_valid] = True
        err16, floor16 = check_bf16(qkv, valid, k, h)
        ms = cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps=10)
        plain_ms = cuda_ms(lambda: fwa.flash_window_attention_plain(qkv, valid, k, h),
                           reps=3, warmup=1)
        p, d = -(-n // k), c // h
        pad = p * k - n
        qkv_w = torch.cat([qkv, qkv.new_zeros(1, pad, 3, c)], 1) if pad else qkv
        valid_w = torch.cat([valid, valid.new_zeros(1, pad)], 1) if pad else valid
        q, kk, v = qkv_w.view(p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid_w.view(p, 1, 1, k)
        lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps=10)
        ops_ms, bytes_ms = bound_ms(n, n_valid, k, c)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, ops_ms=ops_ms,
                   bytes_ms=bytes_ms)
        rows.append(dict(N=n, valid=n_valid, K=k, C=c, H=h, launches=count, **row,
                         bound_ms=max(ops_ms, bytes_ms), bf16_rel_err=err16,
                         bf16_plain_rel_err=floor16))
        for key, val in row.items():
            tot[key] += count * val
        del qkv, qkv_w, q, kk, v
    tot["bound_ms"] = max(tot["ops_ms"], tot["bytes_ms"])
    tot["bound_by"] = "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes"
    emit(dict(phase="timing", dtype="bfloat16", per_call=rows, per_forward=tot))
    return tot


def phase_shipped(text):
    n = 65536
    rng = np.random.default_rng(1)
    coord, feat_in, grid = room_scene(rng, n, (3.0, 3.0, 3.0))
    backbone = dict(SHIPPED_INFERENCE_BACKBONE)
    model = build_lang_model(backbone, dtype="bfloat16", device="cuda", seed=0)
    fwa.flash_window_attention.launches = 0
    feat, pred, plans, times = serve(
        model, dict(coord=coord, feat=feat_in, grid_coord=grid), text, reps=0)
    launches = fwa.flash_window_attention.launches
    check_features(feat, n, "shipped")
    overflow = [int(p.n_overflow.max()) for p in plans]
    check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
    check(launches == 18, f"{launches} kernel launches, expected 18")
    sizes = [n] + [p.out_mask.shape[1] for p in plans]
    ragged = [s for s in sizes[:-1] if s % 48]
    check(len(ragged) == len(sizes) - 1, f"decoder stages {sizes[:-1]} not all ragged")
    emit(dict(phase="shipped", points=n, dec_window=48, stage_sizes=sizes,
              ragged_decoder_stages=ragged, extract_ms=times[0][0], kernel_launches=launches,
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
    for k, c, h in SIGNATURES:
        n = 3 * k + k // 2 + 5  # ragged last window
        valid = torch.zeros(2, n, dtype=torch.bool, device="cuda")
        valid[0, : int(0.8 * n)] = True
        valid[1, : k + 7] = True
        qkv = torch.randn(2, n, 3, c, generator=gen, device="cuda")
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
        dead = torch.zeros_like(valid)
        dead[1, -(-(k + 7) // k) * k:] = True
        check((g32[dead] == 0).all().item(), f"padded windows' gradients not zero at {k, c, h}")

        x16, d16 = qkv.bfloat16(), dout.bfloat16()
        _, truth = grads_of(fwa.flash_window_attention_plain, x16.float(), valid, k, h,
                            d16.float())

        def rel(g):
            return ((g.float() - truth).norm() / truth.norm()).item()

        err16 = rel(grads_of(fwa.flash_window_attention, x16, valid, k, h, d16)[1])
        floor16 = rel(grads_of(fwa.flash_window_attention_plain, x16, valid, k, h, d16)[1])
        rows.append(dict(K=k, C=c, H=h, N=n, fp32_max_abs_err_dq_dk_dv=errs,
                         fp32_max_abs_grad=scale, fp32_fwd_lse_max_abs_err=err_fwd,
                         bf16_rel_err=err16, bf16_plain_rel_err=floor16))
        for name, e, m in zip(("dq", "dk", "dv"), errs, scale):
            check(e <= BWD_FP32_RTOL * m, f"fp32 {name} error {e} > {BWD_FP32_RTOL} x {m} "
                  f"at {k, c, h}")
        check_noise_floor(err16, floor16, "gradient", ("K, C, H", k, c, h))
        worst = max(worst, *errs)
    emit(dict(phase="kernel_bwd", fp32_rtol=BWD_FP32_RTOL,
              bf16_noise_factor=BF16_NOISE_FACTOR, cases=rows))
    return worst, worst_fwd


def write_gs_scenes(root, n_scenes, n, seed, size_m=(3.6, 3.6, 2.6), pc_points=0):
    """``n_scenes`` synthetic 3DGS scenes of ``n`` unique 2 cm voxels on the
    4 cm thick floor and walls of a room of ``size_m`` metres (81% of its
    247,072 surface voxels at the default size), in the GS datasets'
    layout (root/scene/<asset>.npy): colour, opacity, quaternion, scale, 20
    classes by angle around the room's centre and height, 768-d fp16
    lang_feat (the class's unit embedding plus noise) and valid_feat_mask.
    Dense shells keep the pooled stages inside their capacities after
    Mix3D merges two rooms and halves each one's density. With
    ``pc_points`` a scene also gets an evaluation point cloud (that many of
    its points, moved by a few millimetres, with their labels)."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    noise = (0.05 * rng.standard_normal((n, LANG_DIM), dtype=np.float32))
    dirs = []
    for i in range(n_scenes):
        coord, _, _ = room_scene(rng, n, size_m, thickness=2)
        angle = np.arctan2(coord[:, 1] - size_m[1] / 2, coord[:, 0] - size_m[0] / 2)
        seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
        seg = (seg + 10 * (coord[:, 2] > 1.0)).astype(np.int16)
        scene = os.path.join(root, f"scene{i:04d}")
        os.makedirs(scene)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32),
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
            kernels = [e for e in self.prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
            busy = sum(e.self_device_time_total for e in kernels) / 1e3
            top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:20]
            self.profile = dict(step=self.profile_step, wall_ms=wall_ms, device_busy_ms=busy,
                                idle_share=1 - busy / wall_ms,
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


def run_training(cfg):
    """Trains the config's epoch; returns the trainer, its probe, the
    per-step records of the training forward (pooling overflow, stage sizes
    and valid counts) and, read from K1's counter around every forward, the
    forwards and K1 launches of the train steps and of the hooks'
    validation."""
    trainer = build_trainer(cfg, device="cuda")
    steps = len(trainer.train_loader)
    probe = StepProbe(profile_step=steps - 1)
    probe.trainer = trainer
    trainer.hooks.append(probe)
    records = []
    k1 = dict(train_forwards=0, train_launches=0, val_forwards=0, val_launches=0)
    forward = trainer.model.forward

    def recording_forward(point, generator=None):
        before = fwa.flash_window_attention.launches
        out = forward(point, generator=generator)
        mode = "train" if trainer.model.training else "val"
        k1[mode + "_forwards"] += 1
        k1[mode + "_launches"] += fwa.flash_window_attention.launches - before
        if mode == "val":
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


def phase_train(work, scene_points=200000, room=(3.6, 3.6, 2.6), val_points=40000):
    """The flagship trainer, its own hooks included, for 1 + 5 steps and one
    validation; returns the train-step stage shapes, the K1 / K2 launch
    counts and the best checkpoint, copied into ``work``."""
    with tempfile.TemporaryDirectory() as tmp:
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
            for scene in scenes[:count]:
                os.symlink(scene, os.path.join(root[name], split, os.path.basename(scene)))
            os.makedirs(os.path.join(root[name], val_split))
            os.symlink(val_scene, os.path.join(root[name], val_split, "scene_val"))
        data_s = time.perf_counter() - t0

        fwa.flash_window_attention.launches = 0
        fwa.flash_window_attention_bwd.launches = 0
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
            fwa.flash_window_attention.launches = 0
            fwa.flash_window_attention_bwd.launches = 0
            result = run_training(flagship_train_config(root, os.path.join(tmp, "exp1"), batch))
        trainer, probe, records, k1_counts = result
        backbone = trainer.cfg.model.backbone
        blocks = sum(backbone["enc_depths"]) + sum(backbone["dec_depths"])  # 18
        # K1 with lse: the launches counted inside the train steps' forwards;
        # the evaluator hook's validation forwards launch K1 without lse
        k1, k1_val = k1_counts["train_launches"], k1_counts["val_launches"]
        val_forwards = k1_counts["val_forwards"]
        k2 = fwa.flash_window_attention_bwd.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        step_ms = probe.step_ms()
        hist = trainer.storage.history
        losses, grad_norms = hist("loss").values(), hist("grad_norm").values()
        steps = len(losses)
        check(steps >= 6, f"{steps} train steps, expected at least 1 + 5")
        check(all(math.isfinite(v) for v in losses + grad_norms),
              f"non-finite loss or grad_norm: {losses} {grad_norms}")
        check(k1_counts["train_forwards"] == steps and k1 == blocks * steps
              and k2 == blocks * steps,
              f"{k1} forward and {k2} backward kernel launches in {steps} steps "
              f"({k1_counts['train_forwards']} forwards), expected {blocks} each per step")
        check(val_forwards == len(trainer.cfg.data.val) and k1_val == blocks * val_forwards,
              f"{k1_val} kernel launches in {val_forwards} validation forwards, expected "
              f"{blocks} each, one forward per validation set")
        check(fwa.flash_window_attention.launches == k1 + k1_val,
              f"K1 launched {fwa.flash_window_attention.launches} times, {k1} + {k1_val} "
              "of them inside a forward")
        overflow = [int(max(int(o.max()) for o in r["overflow"])) for r in records]
        check(all(o == 0 for o in overflow), f"pooling overflow {overflow}")
        model_dir = os.path.join(trainer.cfg.save_path, "model")
        check(os.path.exists(os.path.join(model_dir, "model_last.pth")),
              "no checkpoint written")
        # the file's own hooks: the evaluator logged each validation set's
        # fg_mIoU, the saver kept the best epoch, PreciseEvaluator had no tester
        val = {f"val{i}/{m}": hist(f"val{i}/{m}").values()
               for i in range(len(trainer.cfg.data.val)) for m in ("mIoU", "fg_mIoU")}
        check(all(len(v) == 1 and 0.0 <= v[0] <= 1.0 for v in val.values()),
              f"validation metrics not logged once per set: {val}")
        check(trainer.comm_info.get("current_metric_name") == "fg_mIoU",
              "the evaluator hook set no checkpoint metric")
        check(os.path.exists(os.path.join(model_dir, "model_best.pth")), "no model_best.pth")
        precise = [h for h in trainer.hooks if isinstance(h, PreciseEvaluator)]
        check(len(precise) == 1 and precise[0].results == [],
              "PreciseEvaluator ran a tester the config does not name")
        checkpoint = shutil.copy(os.path.join(model_dir, "model_best.pth"),
                                 os.path.join(work, "model_best.pth"))
        sizes = [[(n, v.tolist()) for n, v in r["sizes"]] for r in records]
        emit(dict(phase="train", batch_size=batch, points=TRAIN_POINTS, oom=oom,
                  steps=steps, loss=losses, grad_norm=grad_norms, lr=hist("lr").values(),
                  cold_step_ms=step_ms[0], warm_step_ms=step_ms[1:-1],
                  profiled_step_ms=step_ms[-1], data_wait_s=hist("data_time").values(),
                  k1_launches=k1, k2_launches=k2, validation_forwards=val_forwards,
                  validation_k1_launches=k1_val,
                  peak_mem_gib=peak_gib,
                  n_overflow=overflow, stage_slots_valid=sizes[-1],
                  dataset_write_s=data_s, validation={k: v[0] for k, v in val.items()},
                  best_metric=trainer.comm_info.get("best_metric_value"),
                  profile=probe.profile))
        del trainer
    torch.cuda.empty_cache()
    shapes = stage_shapes(backbone, [(n, v.tolist()) for n, v in records[-1]["sizes"]])
    return shapes, k1, k1_val, k2, checkpoint


def bwd_bound_ms(n, valids, k, c, h):
    """Least time of one bf16 backward call, as (ops_ms, bytes_ms,
    design_bytes_ms): 10 v^2 C operations per window of v valid slots (the
    five products, the recompute of S included) at the bf16 peak; the bytes
    of the function K2 replaces (qkv and dO of live windows and the mask
    read once, dqkv written once) at the memory rate; and those bytes plus
    the O and lse of live windows that this design's backward also reads."""
    ops, rows_live = 0, 0
    for nv in valids:
        for w0 in range(0, n, k):
            v = max(0, min(nv, w0 + k) - w0)
            ops += 10 * v * v * c
            rows_live += min(k, n - w0) if v else 0
    nbytes = rows_live * (2 * 3 * c + 2 * c) + len(valids) * n * (2 * 3 * c + 1)
    design = nbytes + rows_live * (2 * c + 4 * h)
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


def phase_timing_bwd(shapes):
    """At the train step's shapes: the forward with log-sum-exp and the
    backward kernel against the plain version under the bf16 noise-floor
    rule (gradients against autograd through the plain version run in
    fp32), with zero output and gradients in windows whose slot 0 is
    padding; then each kernel's time per call and per step against the
    plain version, the library call and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops_ms=0.0, bytes_ms=0.0,
               design_bytes_ms=0.0, fwd_lse_ms=0.0, fwd_plain_ms=0.0,
               fwd_library_ms=0.0, fwd_ops_ms=0.0, fwd_bytes_ms=0.0)
    # what the autograd Function keeps beyond the JAX package's residuals
    # (qkv, valid): the bf16 output and the fp32 log-sum-exp of every call
    saved_gib = sum(count * len(valids) * n * (2 * c + 4 * h)
                    for n, valids, k, c, h, count in shapes) / 2 ** 30
    for n, valids, k, c, h, count in shapes:
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
        rows.append(dict(N=n, B=b, valid=valids, K=k, C=c, H=h, launches=count, **row,
                         bound_ms=max(ops_ms, bytes_ms),
                         fwd_bound_ms=max(fwd_ops_ms, fwd_bytes_ms),
                         bf16_grad_rel_err=err16, bf16_grad_plain_rel_err=floor16,
                         bf16_fwd_lse_rel_err=fwd_err, bf16_fwd_plain_rel_err=fwd_floor))
        for key, val in row.items():
            tot[key] += count * val
        del qkv, dout, out, lse, dqkv, q, kk, v, qkv_w, dout_w
        torch.cuda.empty_cache()
    for pre in ("", "fwd_"):
        ops_ms, bytes_ms = tot[pre + "ops_ms"], tot[pre + "bytes_ms"]
        tot[pre + "bound_ms"] = max(ops_ms, bytes_ms)
        tot[pre + "bound_by"] = "operations" if ops_ms >= bytes_ms else "bytes"
    tot["design_bound_ms"] = max(tot["ops_ms"], tot["design_bytes_ms"])
    emit(dict(phase="timing_bwd", dtype="bfloat16", bf16_noise_factor=BF16_NOISE_FACTOR,
              per_call=rows, per_step=tot, saved_out_lse_gib=saved_gib,
              worst_bf16_grad_ratio=max(r["bf16_grad_rel_err"] / r["bf16_grad_plain_rel_err"]
                                        for r in rows),
              worst_bf16_fwd_lse_ratio=max(r["bf16_fwd_lse_rel_err"]
                                           / r["bf16_fwd_plain_rel_err"] for r in rows)))
    return tot


def phase_train_agree(n=49152):
    """One fp32 train step of the flagship config file's model (decoder
    windows of 48, ragged) at ``n`` points with the kernels and one with the
    plain attention, from the same weights and generator seeds."""
    cfg = Config.fromfile(FLAGSHIP_CONFIG)
    backbone = dict(cfg.model.backbone)
    rng = np.random.default_rng(7)
    # a room small enough that its 4 cm cells fit the first pooling's
    # capacity (a 3 m room's 24,891 would overflow 0.5 x 49,152)
    coord, feat_in, grid = room_scene(rng, n, (2.4, 2.4, 2.4))
    angle = np.arctan2(coord[:, 1] - 1.2, coord[:, 0] - 1.2)
    seg = ((angle + np.pi) / (2 * np.pi) * 10).astype(np.int64).clip(0, 9)
    seg = seg + 10 * (coord[:, 2] > 1.0)
    emb = rng.normal(size=(TRAIN_CLASSES, LANG_DIM)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)  # SigLIP2 features are unit rows
    lang = emb[seg] + 0.05 * rng.normal(size=(n, LANG_DIM)).astype(np.float32)

    def dev(x):
        return torch.from_numpy(np.asarray(x))[None].cuda()

    batch = dict(coord=dev(coord), feat=dev(feat_in), grid_coord=dev(grid),
                 mask=torch.ones(1, n, dtype=torch.bool, device="cuda"),
                 segment=dev(seg), lang_feat=dev(lang.astype(np.float16)),
                 valid_feat_mask=dev(rng.random(n) > 0.1))
    criteria = build_criteria(cfg.model.criteria)

    def step(use_kernel):
        model = build_model(dict(type="LangPretrainer", backbone=dict(
            backbone, dtype="float32", seed=1, use_kernel=use_kernel)))
        model = model.cuda().train()
        gen = torch.Generator(device="cuda").manual_seed(11)
        loss, out = lang_loss(model, criteria, batch, gen, epoch_progress=1.0)
        loss.backward()
        overflow.append([int(p.n_overflow.max()) for p in out.plans])
        return loss.item(), {k: p.grad for k, p in model.named_parameters()}

    blocks = sum(backbone["enc_depths"]) + sum(backbone["dec_depths"])
    overflow = []
    before = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    loss_k, grads_k = step(None)
    after = (fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
    check(after == (before[0] + blocks, before[1] + blocks),
          f"kernel path not taken: {before} {after}")
    loss_p, grads_p = step(False)
    check((fwa.flash_window_attention.launches, fwa.flash_window_attention_bwd.launches)
          == after, "plain path launched a kernel")
    total = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads_p.values()])).item()
    worst, zero, by_share = 0.0, [], {}
    for name, gp in grads_p.items():
        gk = grads_k[name]
        check(torch.isfinite(gk).all().item(), f"non-finite gradient {name}")
        norm, diff = gp.norm().item(), (gk - gp).norm().item()
        # per decade of the tensor's share of the global norm: how many
        # tensors, and their worst error relative to their own norm
        decade = f"1e{math.floor(math.log10(norm / total))}" if norm else "0"
        count, own = by_share.get(decade, (0, 0.0))
        by_share[decade] = (count + 1, max(own, diff / norm if norm else diff))
        if norm < ZERO_GRAD * total:
            zero.append(name)
            check(gk.norm().item() < ZERO_GRAD * total,
                  f"gradient of {name} is zero on the plain path only")
            continue
        worst = max(worst, diff / norm)
        check(diff / norm <= TRAIN_GRAD_RTOL,
              f"gradient of {name} differs by {diff / norm} (relative L2)")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit(dict(phase="train_agree", points=n, dtype="float32",
              dec_patch_size=backbone.get("dec_patch_size", "default (48)"),
              n_overflow=overflow, loss_kernel=loss_k,
              loss_plain=loss_p, loss_rel_diff=loss_rel, loss_rtol=TRAIN_LOSS_RTOL,
              grad_tensors=len(grads_p), worst_grad_rel_l2=worst, grad_rtol=TRAIN_GRAD_RTOL,
              zero_grad_tensors=zero, global_grad_norm=total,
              worst_own_rel_l2_by_share=dict(sorted(by_share.items()))))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"losses differ by {loss_rel} relative")
    check(not any(map(any, overflow)), f"pooling overflow {overflow}")

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
    # int64 codes with duplicates and a sentinel tail, as the sort sites see them
    for shape in ((4, 1, 196608), (3, 2, 24576), (393216,)):
        code = torch.randint(0, 1 << 28, shape, generator=gen, device="cuda")
        code[..., -(shape[-1] // 7):] = SENTINEL
        sort_switch(False)
        values, order = bs.sort_int64(code)
        sort_switch(True)
        values_on, order_on = bs.sort_int64(code)
        sort_switch(False)
        check(torch.equal(values, values_on) and torch.equal(order, order_on),
              f"sort_int64 with the switch on differs from torch.sort at {shape}")
    emit(dict(phase="kernel_sort", exact=True, signatures=checked, max_abs_err=worst,
              rows=cases))
    return worst


def write_test_scenes(root, n_scenes, n_voxels, seed, pc_points=100000):
    """``n_scenes`` ScanNet200-layout scenes under root/val: ``n_voxels``
    unique 2 cm voxels on the floor and walls of a 6 x 6 x 3 m room, each
    holding two Gaussians 1 cm apart on its diagonal, plus one Gaussian at
    height 0 in a voxel of its own, so that the 1 cm deduplication keeps all
    2 n + 1 and the 2 cm test voxelisation, whose cells line up with the
    voxels after CenterShift, gives 2 fragments of n + 1 points. With 200
    classes by position, valid_feat_mask and an evaluation point cloud of
    ``pc_points`` of the Gaussians moved by a few millimetres."""
    rng = np.random.default_rng(seed)
    ex, ey, ez = (int(round(m / GRID)) for m in (6.0, 6.0, 3.0))
    x, y, z = np.meshgrid(np.arange(ex), np.arange(ey), np.arange(ez), indexing="ij")
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
        seg = ((angle + np.pi) / (2 * np.pi) * 20).astype(np.int64).clip(0, 19)
        seg = (seg * 10 + (coord[:, 2] / 3.0 * 10).astype(np.int64).clip(0, 9)).astype(np.int16)
        pick = rng.choice(n, pc_points, replace=False)
        assets = dict(
            coord=coord, color=rng.uniform(0, 255, (n, 3)).astype(np.float32),
            opacity=rng.uniform(0, 1, n).astype(np.float32),
            quat=rng.normal(size=(n, 4)).astype(np.float32),
            scale=rng.uniform(0, 0.05, (n, 3)).astype(np.float32), segment200=seg,
            valid_feat_mask=rng.random(n) > 0.1,
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


def phase_test(work, checkpoint, meta_root, n_voxels=160000, n_scenes=2):
    """The test entry point's main three times: switch off and switch on
    under deterministic algorithms, whose predictions and metrics must be
    equal, then switch off as a user runs it (no deterministic mode), whose
    times are the ones to quote per scene. Returns the K3 counts of the run
    with the switch on, its fragment forwards and the sort sizes of one."""
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
    blocks = sum(backbone["enc_depths"]) + sum(backbone["dec_depths"])
    sizes = forward_sort_sizes(backbone, n_voxels + 1)

    runs = {}
    try:
        for name, switch, deterministic in (("off", False, True), ("on", True, True),
                                            ("timed", False, False)):
            # scatter-adds of the pooling sum in an order that changes from
            # run to run, and a last-bit difference can flip an argmax: the
            # two runs that are compared use the deterministic forms
            torch.use_deterministic_algorithms(deterministic, warn_only=True)
            save = os.path.join(work, f"test_{name}")
            bs.bitonic_sort.launches = bs.bitonic_sort.kernel_launches = 0
            fwa.flash_window_attention.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (res,) = test_entry.main([
                "--config-file", cfg_file, "--options", f"weight={checkpoint}",
                f"test.save_path={save}", f"bitonic_sort={switch}"])
            seconds = time.perf_counter() - t1
            with open(os.path.join(save, "scene_log.json")) as f:
                scenes = json.load(f)
            preds = {name: np.load(os.path.join(save, name)) for name in sorted(os.listdir(save))
                     if name.endswith("_pred.npy")}
            runs[name] = dict(
                res=res, scenes=scenes, preds=preds, seconds=seconds,
                sort_calls=bs.bitonic_sort.launches,
                sort_kernels=bs.bitonic_sort.kernel_launches,
                k1=fwa.flash_window_attention.launches)
    finally:
        torch.use_deterministic_algorithms(False)
        sort_switch(False)

    off, on, timed = runs["off"], runs["on"], runs["timed"]
    fragments = sum(s["fragments"] for s in on["scenes"])
    check(len(on["preds"]) == n_scenes and sorted(off["preds"]) == sorted(on["preds"]),
          f"prediction files: {sorted(off['preds'])} and {sorted(on['preds'])}")
    for s in on["scenes"]:
        check(s["fragments"] >= 2 and min(s["fragment_points"]) >= 150000
              and s["points"] == n_points,
              f"scene {s['name']}: {s['fragments']} fragments of {s['fragment_points']}")
    for name, pred in off["preds"].items():
        check(np.array_equal(pred, on["preds"][name]),
              f"{name}: predictions differ with the sort switch on")
        check(pred.ndim == 1 and len(pred) > 50000, f"{name}: shape {pred.shape}")
    for key, value in off["res"].items():
        check(np.array_equal(value, on["res"][key]), f"metric {key} differs with the switch on")
    check(all(np.isfinite(off["res"][k]) for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")),
          "non-finite metrics")
    want_calls = fragments * len(sizes)
    want_kernels = fragments * sum(bs.kernel_launches(n) for _, n in sizes)
    check(off["sort_calls"] == 0 and off["sort_kernels"] == 0,
          f"K3 launched {off['sort_calls']} times with the switch off")
    check(on["sort_calls"] == want_calls and on["sort_kernels"] == want_kernels,
          f"K3: {on['sort_calls']} sorts and {on['sort_kernels']} kernels, reckoned "
          f"{want_calls} and {want_kernels}")
    check(off["k1"] == on["k1"] == timed["k1"] == blocks * fragments,
          f"K1 launches {off['k1']} / {on['k1']} / {timed['k1']}, expected {blocks} per "
          "fragment")
    check(timed["sort_calls"] == 0 and len(timed["preds"]) == n_scenes,
          "the run without deterministic algorithms launched K3 or lost a scene")
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

    def split(run):
        keys = ("fetch_s", "extract_s", "score_s", "vote_s", "total_s")
        return [dict(name=s["name"], points=s["points"], fragments=s["fragments"],
                     fragment_points=s["fragment_points"], **{k: s[k] for k in keys})
                for s in run["scenes"]]

    record = dict(
        phase="test", dtype="bfloat16", scenes=n_scenes, points_per_scene=n_points,
        fragments=fragments, dataset_write_s=write_s, sort_sizes=sizes,
        switch_off=dict(deterministic_algorithms=True, seconds=off["seconds"],
                        per_scene=split(off), k1_launches=off["k1"],
                        sort_calls=off["sort_calls"]),
        switch_on=dict(deterministic_algorithms=True, seconds=on["seconds"],
                       per_scene=split(on), k1_launches=on["k1"],
                       sort_calls=on["sort_calls"], sort_kernel_launches=on["sort_kernels"]),
        as_a_user_runs_it=dict(deterministic_algorithms=False, bitonic_sort=False,
                               seconds=timed["seconds"], per_scene=split(timed),
                               k1_launches=timed["k1"],
                               predictions_equal_to_deterministic_run=agreement,
                               metrics={k: timed["res"][k]
                                        for k in ("mIoU", "fg_mIoU", "mAcc", "allAcc")}),
        predictions_equal=True, metrics_equal=True,
        metrics={k: off["res"][k] for k in ("mIoU", "fg_mIoU", "mAcc", "fg_mAcc", "allAcc")},
        classes_predicted=int(len(np.unique(np.concatenate(list(off["preds"].values()))))),
        knn_s=knn_s, knn_data=len(data), knn_queries=len(query))
    emit(record)
    return on["sort_calls"], on["sort_kernels"], fragments, sizes


def phase_timing_sort(sizes):
    """At the 8 sort shapes of one fragment forward: K3 (the wrapper on a
    code's halves and the index, padding copies included), the plain version
    and torch.sort(stable=True) on the int64 codes, by CUDA events; the bound
    is every operand read once and written once at the memory rate."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows, worst = [], 0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, kernel_launches=0)
    for b, n in sizes:
        code = torch.randint(0, 1 << 30, (b, n), generator=gen, device="cuda")
        code[:, -(n // 5):] = SENTINEL  # padding slots
        halves = code.view(torch.int32).view(b, n, 2)
        ops = (halves[..., 1].contiguous(), halves[..., 0].contiguous(),
               torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n).contiguous())
        got = bs.bitonic_sort(ops, 3)
        ref = bs.bitonic_sort_reference(ops, 3)
        want = torch.sort(code, dim=-1, stable=True)
        torch.cuda.synchronize()
        worst = max(worst, sort_max_abs_diff(got, ref))
        check(all(torch.equal(g, r) for g, r in zip(got, ref)),
              f"K3 differs from its plain version at {(b, n)}")
        check(torch.equal(got[2].long(), want.indices),
              f"K3 order differs from the stable torch.sort at {(b, n)}")
        row = dict(
            ms=cuda_ms(lambda: bs.bitonic_sort(ops, 3), reps=20),
            plain_ms=cuda_ms(lambda: bs.bitonic_sort_reference(ops, 3), reps=2, warmup=1),
            library_ms=cuda_ms(lambda: torch.sort(code, dim=-1, stable=True), reps=20),
            bound_ms=2 * 3 * 4 * b * n / PEAK_BYTES * 1e3)
        rows.append(dict(B=b, n=n, padded=bs.padded_length(n),
                         kernel_launches=bs.kernel_launches(n), **row))
        for key, val in row.items():
            tot[key] += val
        tot["kernel_launches"] += bs.kernel_launches(n)
    tot["max_abs_err"] = worst
    emit(dict(phase="timing_sort", operands=3, num_keys=3, per_call=rows, per_forward=tot))
    return tot


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
        shapes, launches = phase_serve(text)
        tot = phase_timing(shapes)
        phase_shipped(text)
        phase_agree(text)
        worst_bwd, worst_fwd_lse = phase_kernel_bwd()
        train_shapes, k1_train, k1_val, k2_train, checkpoint = phase_train(work)
        tot_bwd = phase_timing_bwd(train_shapes)
        phase_train_agree()
        worst_sort = phase_kernel_sort()
        sort_calls, sort_kernels, fragments, sort_sizes = phase_test(work, checkpoint, meta_root)
        tot_sort = phase_timing_sort(sort_sizes)
    emit(dict(phase="done", seconds=time.perf_counter() - t0))
    print(smi, flush=True)
    source = "scenesplat_tpu_torch/csrc/flash_window_attn.cu"
    # launches: the count of the path's run (4 serve forwards, 6 train
    # steps, the test run's fragment forwards with the sort switch on); ms
    # and the other times: per forward or per step (18 attention launches, 8
    # sorts)
    emit({"kernels": [
        dict(name="flash_window_attention_fwd", route="cuda", source=source,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="serve",
             launches=launches, ms_per="serve forward", max_abs_err=worst32, ms=tot["ms"],
             plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=tot["bound_by"],
             library_ms=tot["library_ms"]),
        dict(name="flash_window_attention_fwd_lse", route="cuda", source=source,
             replaces="scenesplat_tpu/ops/pallas_attn.py:68", path="train",
             launches=k1_train, validation_launches=k1_val, ms_per="train step",
             max_abs_err=worst_fwd_lse,
             ms=tot_bwd["fwd_lse_ms"], plain_ms=tot_bwd["fwd_plain_ms"],
             bound_ms=tot_bwd["fwd_bound_ms"], bound_by=tot_bwd["fwd_bound_by"],
             library_ms=tot_bwd["fwd_library_ms"]),
        dict(name="flash_window_attention_bwd", route="cuda", source=source,
             replaces="scenesplat_tpu/ops/pallas_attn.py:98", path="train",
             launches=k2_train, ms_per="train step", max_abs_err=worst_bwd,
             ms=tot_bwd["ms"], plain_ms=tot_bwd["plain_ms"], bound_ms=tot_bwd["bound_ms"],
             bound_by=tot_bwd["bound_by"], library_ms=tot_bwd["library_ms"],
             design_bound_ms=tot_bwd["design_bound_ms"]),
        dict(name="bitonic_sort", route="cuda",
             source="scenesplat_tpu_torch/csrc/bitonic_sort.cu",
             replaces="scenesplat_tpu/ops/pallas_sort.py:146", path="test",
             launches=sort_calls, kernel_launches=sort_kernels, fragment_forwards=fragments,
             ms_per="fragment forward",
             max_abs_err=max(worst_sort, tot_sort["max_abs_err"]), ms=tot_sort["ms"],
             plain_ms=tot_sort["plain_ms"], bound_ms=tot_sort["bound_ms"], bound_by="bytes",
             library_ms=tot_sort["library_ms"])]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
