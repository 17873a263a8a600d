"""Build, check and time the port's hand-written kernels alone on one CUDA
card, without the model: the quick loop while a kernel is being worked on
(chip_smoke.py is the whole proof).

    python3 tools/torch_kernel_bench.py [attn] [sort] [bwd] [fps] [widths] [--reps N]

attn: the flash-window attention forward (K1) in bf16 against its plain
version (noise-floor rule, lse against the plain log-sum-exp, zeros in
padded windows, valid prefixes that end inside a key tile, on a tile edge
and one past it) at windows of 16 to 1024, every bf16 variant; then its
time at the seven stage shapes of a flagship serve forward at 196,608
points beside scaled_dot_product_attention (the library yardstick, used
nowhere in the port) and the operations bound; then, at the decoder's
windows of 48 (dec2, dec1, dec0), the one-pass bf16_small kernel in each
unit order, in turns, beside the tiled kernel it replaced there (the C
function of bf16_tiled called at 48), the library and the bound, per call
and per step: with lse at a train step's shapes (batch 2) and without lse
at a test fragment's (batch 1).
sort: the bitonic row sort (K3), both C entries against the plain version
and torch.sort (exact), then sort_int64 with the switch on at the eight sort
shapes of one fragment forward beside torch.sort(stable=True).
bwd: the attention backward (K2) alone, its source built alone: bf16
against autograd through the plain version run in fp32 (noise-floor rule,
zero gradients in windows of padding, a ragged last window) at windows on
both sides of its variants' threshold, then its time per call and per step
at the seven stage shapes of a flagship train step at 196,608 points, batch
2, beside the backward of scaled_dot_product_attention and the bound
(chip_smoke.py's arithmetic). O and lse come from the plain version.
fps: the farthest point sampling kernel against its plain loop (ids
bit-equal, one launch a call) at each block count's edge (the capacity of
1, 2, 4, 8 and 16 blocks and one point more), past 16 blocks into the
scratch row, on both sides of the small one-block row (4,096 points) and on
lattice rows where distances tie everywhere; then its
time at chip_smoke.py's fps_kernel levels (ST's five at the train rows,
PTv1's four, PartSeg50's four), each level checked against the plain loop,
with its blocks a row, whether it spilled and us a step.
widths: K1 and K2 at head widths 8 to 128 in fp32, bf16 and fp16 against
the plain version (chip_smoke.py's kernel_widths phase, with every variant
timed at width 64 and the wrapper pad's time at the padded widths); then
the fp32 route (csrc/flash_window_attn.cu: K1 with lse and K2) at the
stage shapes of the flagship file's fp32 model over one row of 49,152
points in a 2.4 m room (the size of chip_smoke.py's semseg, PPT, insseg and
CAC agree steps; train_agree now takes 24,576), and the bf16_tiled forward (its C
function called in bf16 and in fp16) at the same shapes, each beside the
plain version, scaled_dot_product_attention and the bound, per call and
per step.
One JSON line per phase; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from scenesplat_tpu_torch.ops import bitonic_sort as bs  # noqa: E402
from scenesplat_tpu_torch.ops import flash_window_attn as fwa  # noqa: E402
from scenesplat_tpu_torch.ops import fps as fps_ops  # noqa: E402
from scenesplat_tpu_torch.ops import pointops  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
# (N, valid, K, C, H, launches) of a flagship serve forward at 196,608 points
SERVE_SHAPES = ((196608, 196608, 1024, 32, 2, 2), (98304, 66269, 1024, 64, 4, 2),
                (49152, 16577, 1024, 128, 8, 2), (24576, 4108, 1024, 256, 16, 6),
                (49152, 16577, 1024, 256, 16, 2), (98304, 66269, 1024, 512, 16, 2),
                (196608, 196608, 1024, 768, 16, 2))
# (N, valid counts of the two batch rows, K, C, H, launches) of a flagship
# train step at 196,608 points, batch 2 (chip_smoke.py's timing_bwd)
TRAIN_SHAPES = ((196608, (196608, 196608), 1024, 32, 2, 2),
                (98304, (98009, 88835), 1024, 64, 4, 2),
                (49152, (24032, 21419), 1024, 128, 8, 2),
                (24576, (5206, 4743), 1024, 256, 16, 6),
                (49152, (24032, 21419), 48, 256, 16, 2),
                (98304, (98009, 88835), 48, 512, 16, 2),
                (196608, (196608, 196608), 48, 768, 16, 2))
# (N, valid count, K, C, H, launches) of the decoder's calls in one test
# fragment forward of chip_smoke.py's test phase (160,001 points in the
# 196,608 bucket; the pooled stages' valid counts as that phase records
# them, decoder_k1_calls_first_fragment)
TEST_DEC_SHAPES = ((49152, 16577, 48, 256, 16, 2), (98304, 64901, 48, 512, 16, 2),
                   (196608, 160001, 48, 768, 16, 2))
SORT_SHAPES = ((4, 196608), (1, 196608), (3, 98304), (1, 98304), (3, 49152), (1, 49152),
               (3, 24576), (1, 24576))


def emit(obj):
    print(json.dumps(obj), flush=True)


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


def build(libraries):
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libraries)) as pool:
        seconds = list(pool.map(lambda lib: lib.build(), libraries))
    report = {}
    for lib, s in zip(libraries, seconds):
        lib.load()
        lines = lib.log_path().read_text().splitlines()
        info, name = [], None
        for ln in lines:
            if "Compiling entry function" in ln:
                name = ln.split("'")[1][-70:]
            elif "registers" in ln or "spill" in ln:
                info.append(f"{name}: {ln.split('ptxas info    : ')[-1]}")
            elif "warning" in ln.lower() or "Performance" in ln:
                info.append(f"{name}: {ln.strip()[:300]}")
        report[lib.source.name] = dict(seconds=s, ptxas=info)
    emit(dict(phase="build", wall_s=time.perf_counter() - t0, libraries=report))


def plain_lse(qkv, valid, k, h):
    """Natural-log log-sum-exp of the scaled scores over each row's valid
    keys, [B, N, H] fp32, in plain torch (N a multiple of k)."""
    b, n, _, c = qkv.shape
    d = c // h
    blk = qkv.view(b, n // k, k, 3, h, d).permute(3, 0, 1, 4, 2, 5)
    s = (blk[0] * d ** -0.5).float() @ blk[1].float().transpose(-1, -2)
    s = torch.where(valid.view(b, n // k, 1, 1, k), s, float("-inf"))
    return torch.logsumexp(s, -1).permute(0, 1, 3, 2).reshape(b, n, h)


def attn_check():
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for k in (16, 32, 48, 64, 65, 127, 128, 192, 256, 1024):
        for c, h in ((768, 16), (512, 16), (32, 2)):
            n = 4 * k
            # valid prefixes: inside a key tile, on a tile edge, one past it; a dead window
            valid = torch.zeros(3, n, dtype=torch.bool, device="cuda")
            valid[0, : k + 37] = True
            valid[1, : 2 * k + 64] = True
            valid[2, : 64 + 1] = True
            qkv = torch.randn(3, n, 3, c, generator=gen, device="cuda").bfloat16()
            variant = fwa.forward_variant(qkv.dtype, k, c // h)
            truth = fwa.flash_window_attention_plain(qkv.float(), valid, k, h)
            floor = fwa.flash_window_attention_plain(qkv, valid, k, h)
            out, lse = fwa._forward(qkv, valid, k, h, (c // h) ** -0.5, True)[:2]
            torch.cuda.synchronize()
            err = ((out.float() - truth)[valid].norm() / truth[valid].norm()).item()
            ref = ((floor.float() - truth)[valid].norm() / truth[valid].norm()).item()
            live = valid.view(3, n // k, k)[:, :, :1].expand(3, n // k, k).reshape(3, n)
            lse_err = (lse - plain_lse(qkv, valid, k, h))[live].abs().max().item()
            dead_zero = bool((out[~live] == 0).all())
            rows.append(dict(K=k, C=c, H=h, variant=variant, rel_err=err, plain_rel_err=ref,
                             lse_max_abs_err=lse_err, dead_windows_zero=dead_zero))
            if not (err <= 2.5 * ref and lse_err <= 1e-3 and dead_zero):
                emit(dict(phase="attn_check", failed=rows[-1]))
                raise AssertionError(rows[-1])
    emit(dict(phase="attn_check", cases=rows))


def attn_time(reps):
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, tot = [], {}
    for n, n_valid, k, c, h, count in SERVE_SHAPES:
        qkv = torch.randn(1, n, 3, c, generator=gen, device="cuda").bfloat16()
        valid = torch.zeros(1, n, dtype=torch.bool, device="cuda")
        valid[0, :n_valid] = True
        row = dict(N=n, valid=n_valid, K=k, C=c, H=h, launches=count)
        row["ms"] = [cuda_ms(lambda: fwa.flash_window_attention(qkv, valid, k, h), reps)
                     for _ in range(2)]
        p, d = n // k, c // h
        q, kk, v = qkv.view(p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
        mask = valid.view(p, 1, 1, k)
        row["library_ms"] = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, kk, v, attn_mask=mask), reps)
        ops = sum(4 * max(0, min(n_valid, w0 + k) - w0) ** 2 * c for w0 in range(0, n, k))
        row["ops_ms"] = ops / PEAK_BF16_FLOPS * 1e3
        row["tflops"] = ops / min(row["ms"]) / 1e9
        rows.append(row)
        for key in ("ms", "library_ms", "ops_ms"):
            val = min(row[key]) if isinstance(row[key], list) else row[key]
            tot[key] = tot.get(key, 0.0) + count * val
        del qkv, q, kk, v
    emit(dict(phase="attn_time", dtype="bfloat16", per_call=rows, per_forward=tot))


def small_call(order, qkv, valid, k, h, with_lse):
    """One launch of the bf16_small C function in unit order ``order`` (a
    key of fwa.SMALL_UNIT_ORDERS): out and lse (or None)."""
    b, n, _, c = qkv.shape
    out = torch.empty(b, n, c, dtype=qkv.dtype, device="cuda")
    lse = torch.empty(b, n, h, device="cuda") if with_lse else None
    rc = fwa.LIBRARY_SMALL.load().fwa_fwd_small(
        qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        fwa._DTYPES[qkv.dtype], b, n, c, h, k, (c // h) ** -0.5, fwa.small_chunk(order, h),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fwa_fwd_small failed: CUDA error {rc}")
    return out, lse


def tiled_call(qkv, valid, k, h, with_lse):
    """One launch of the bf16_tiled C function (the kernel that served
    windows of 48 before bf16_small) at window ``k``: out and lse (or None)."""
    b, n, _, c = qkv.shape
    out = torch.empty(b, n, c, dtype=qkv.dtype, device="cuda")
    lse = torch.empty(b, n, h, device="cuda") if with_lse else None
    rc = fwa.LIBRARY.load().fwa_fwd(
        qkv.data_ptr(), valid.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        fwa._DTYPES[qkv.dtype], b, n, c, h, k, (c // h) ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fwa_fwd (bf16_tiled) failed: CUDA error {rc}")
    return out, lse


def small_time(reps):
    """bf16_small at the decoder's shapes: each unit order and the tiled
    kernel, in turns (each order, the tiled kernel twice, each order again
    in reverse), per call and per step, with lse at a train step's shapes
    and without at a test fragment's; every order checked bit-equal to the
    shipped one and the tiled kernel's output within the noise-floor rule."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    orders = tuple(fwa.SMALL_UNIT_ORDERS)
    cases = [("train", True, n, valids, k, c, h, count)
             for n, valids, k, c, h, count in TRAIN_SHAPES if k <= fwa.FWD_SMALL_MAX]
    cases += [("test", False, n, (nv,), k, c, h, count)
              for n, nv, k, c, h, count in TEST_DEC_SHAPES]
    for path in ("train", "test"):
        rows, tot = [], {}
        for _, with_lse, n, valids, k, c, h, count in (x for x in cases if x[0] == path):
            b, d = len(valids), c // h
            qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
            valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
            for i, nv in enumerate(valids):
                valid[i, :nv] = True
            shipped = fwa._forward(qkv, valid, k, h, d ** -0.5, with_lse)[:2]
            live = valid.view(b, n // k, k)[:, :, :1].expand(b, n // k, k).reshape(b, n)
            for order in orders:
                got = small_call(order, qkv, valid, k, h, with_lse)
                # the lse of a window of padding is not written
                same = torch.equal(got[0], shipped[0]) and (
                    not with_lse or torch.equal(got[1][live], shipped[1][live]))
                if not same:
                    raise AssertionError(f"order {order} differs from the shipped one at "
                                         f"{n, valids, k, c, h}")
            err, floor = chip_smoke.check_bf16(qkv, valid, k, h, out=shipped[0])
            t_err, _ = chip_smoke.check_bf16(qkv, valid, k, h,
                                              out=tiled_call(qkv, valid, k, h, with_lse)[0])
            times = {o: [] for o in orders}
            times["tiled"] = []
            turns = list(orders) + ["tiled", "tiled"] + list(reversed(orders))
            for who in turns:
                if who == "tiled":
                    fn = lambda: tiled_call(qkv, valid, k, h, with_lse)  # noqa: E731
                else:
                    fn = lambda o=who: small_call(o, qkv, valid, k, h, with_lse)  # noqa: E731
                times[who].append(cuda_ms(fn, reps))
            p = n // k
            q, kk, v = qkv.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()
            mask = valid.view(b * p, 1, 1, k)
            lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kk, v, attn_mask=mask), reps)
            if with_lse:
                ops_ms, bytes_ms = chip_smoke.fwd_lse_bound_ms(n, valids, k, c, h)
            else:
                ops_ms, bytes_ms = chip_smoke.bound_ms(n, valids[0], k, c)
            row = dict(N=n, B=b, valid=list(valids), K=k, C=c, H=h, launches=count,
                       lse=with_lse, ms={o: times[o] for o in orders},
                       tiled_ms=times["tiled"], library_ms=lib_ms,
                       bound_ms=max(ops_ms, bytes_ms),
                       bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                       rel_err=err, tiled_rel_err=t_err, plain_rel_err=floor,
                       blocks_per_sm=fwa.LIBRARY_SMALL.load().fwa_fwd_small_residency(d, k))
            rows.append(row)
            for key, val in [(f"ms_{o}", min(times[o])) for o in orders] + [
                    ("tiled_ms", min(times["tiled"])), ("library_ms", lib_ms),
                    ("bound_ms", row["bound_ms"])]:
                tot[key] = tot.get(key, 0.0) + count * val
            del qkv, q, kk, v
            torch.cuda.empty_cache()
        emit(dict(phase="small_time", path=path, shipped_order=fwa.FWD_SMALL_ORDER,
                  per_call=rows, per_step_or_forward=tot))


def bwd_inputs(gen, b, n, c, k, stops):
    """bf16 qkv and dout [b, n, ...], valid prefixes ending at ``stops``, the
    plain bf16 output, the plain fp32 log-sum-exp, and the mask of windows
    whose slot 0 is padding."""
    qkv = torch.randn(b, n, 3, c, generator=gen, device="cuda").bfloat16()
    dout = torch.randn(b, n, c, generator=gen, device="cuda").bfloat16()
    valid = torch.zeros(b, n, dtype=torch.bool, device="cuda")
    dead = torch.zeros_like(valid)
    for i, stop in enumerate(stops):
        valid[i, :stop] = True
        dead[i, -(-stop // k) * k:] = True
    return qkv, dout, valid, dead


def plain_out_lse(qkv, valid, k, h):
    chunk = max(1, 16384 // k)  # windows per plain chunk: the result is the same
    out = fwa.flash_window_attention_plain(qkv, valid, k, h, patch_chunk=chunk)
    return out.contiguous(), chip_smoke.plain_lse(qkv, valid, k, h).contiguous()


def bwd_rel_err(qkv, valid, k, h, dout, dqkv):
    """(kernel's, plain bf16 version's) relative gradient error against
    autograd through the plain version run in fp32."""
    chunk = max(1, 16384 // k)

    def plain(t, m, kk, hh):
        return fwa.flash_window_attention_plain(t, m, kk, hh, patch_chunk=chunk)

    _, truth = chip_smoke.grads_of(plain, qkv.float(), valid, k, h, dout.float())
    floor = chip_smoke.grads_of(plain, qkv, valid, k, h, dout)[1]

    def rel(g):
        return ((g.float() - truth).norm() / truth.norm()).item()

    return rel(dqkv), rel(floor)


def bwd_check():
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for k in (16, 48, 64, 65, 127, 128, 1024, 4160):  # 4160: more key tiles than a pass holds
        for c, h in ((768, 16), (512, 16), (256, 16), (32, 2)) if k < 4096 else ((32, 2),):
            n = 3 * k + k // 2 + 5  # a ragged last window
            # valid prefixes: inside a window, then windows of padding; all
            qkv, dout, valid, dead = bwd_inputs(gen, 3, n, c, k, (int(0.8 * n), k + 7, n))
            out, lse = plain_out_lse(qkv, valid, k, h)
            dqkv = fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h,
                                                  (c // h) ** -0.5)
            torch.cuda.synchronize()
            err, floor = bwd_rel_err(qkv, valid, k, h, dout, dqkv)
            row = dict(K=k, C=c, H=h, N=n, variant=fwa.backward_variant(qkv.dtype, k, c // h),
                       rel_err=err, plain_rel_err=floor,
                       finite=bool(torch.isfinite(dqkv).all()),
                       dead_windows_zero=bool((dqkv[dead] == 0).all()))
            row["ok"] = (row["finite"] and row["dead_windows_zero"] and floor > 1e-4
                         and err <= chip_smoke.BF16_NOISE_FACTOR * floor)
            rows.append(row)
    emit(dict(phase="bwd_check", bf16_noise_factor=chip_smoke.BF16_NOISE_FACTOR, cases=rows))
    failed = [r for r in rows if not r["ok"]]
    if failed:
        raise AssertionError(f"{len(failed)} of {len(rows)} cases failed: {failed}")


def bwd_time(reps):
    gen = torch.Generator(device="cuda").manual_seed(6)
    rows, tot = [], dict(ms=0.0, library_ms=0.0, bound_ms=0.0)
    for n, valids, k, c, h, count in TRAIN_SHAPES:
        b, d, scale = len(valids), c // h, (c // h) ** -0.5
        qkv, dout, valid, _ = bwd_inputs(gen, b, n, c, k, valids)
        out, lse = plain_out_lse(qkv, valid, k, h)
        ms = [cuda_ms(lambda: fwa.flash_window_attention_bwd(qkv, valid, out, lse, dout, k, h,
                                                             scale), reps) for _ in range(2)]
        p = -(-n // k)
        pad = p * k - n
        qkv_w = torch.nn.functional.pad(qkv, (0, 0, 0, 0, 0, pad))
        valid_w = torch.nn.functional.pad(valid, (0, pad))
        q, kk, v = [t.detach().requires_grad_(True) for t in
                    qkv_w.view(b * p, k, 3, h, d).permute(2, 0, 3, 1, 4).contiguous()]
        mask = valid_w.view(b * p, 1, 1, k)
        dout_w = torch.nn.functional.pad(dout, (0, 0, 0, pad))
        dout_w = dout_w.view(b * p, k, h, d).transpose(1, 2).contiguous()
        lib_ms, _ = chip_smoke.backward_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, kk, v, attn_mask=mask),
            [q, kk, v], dout_w, reps=5)
        ops_ms, bytes_ms, _ = chip_smoke.bwd_bound_ms(n, valids, k, c, h)
        variant = fwa.backward_variant(qkv.dtype, k, d)
        row = dict(N=n, valid=valids, K=k, C=c, H=h, launches=count, variant=variant,
                   ms=ms, library_ms=lib_ms,
                   bound_ms=max(ops_ms, bytes_ms),
                   bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        if variant == "bf16_small":  # persistent blocks: how many an SM holds
            row["blocks_per_sm"] = fwa.LIBRARY_BWD.load().fwa_bwd_small_residency(d, k)
        rows.append(row)
        tot["ms"] += count * min(ms)
        tot["library_ms"] += count * lib_ms
        tot["bound_ms"] += count * row["bound_ms"]
        del qkv, dout, out, lse, q, kk, v, qkv_w, dout_w
        torch.cuda.empty_cache()
    emit(dict(phase="bwd_time", dtype="bfloat16", per_call=rows, per_step=tot))


def sort_check():
    gen = torch.Generator(device="cuda").manual_seed(2)
    checked = 0
    for n in (1000, 1024, 4095, 4097, 8192, 16384, 24576, 70000, 196608, 1 << 20):
        for b in (1, 3, 4):
            if b * n > (1 << 21):
                continue
            for num_ops, num_keys, ties in ((2, 1, False), (2, 2, True), (3, 1, True),
                                            (3, 2, False), (3, 3, True)):
                lo, hi = (0, 8) if ties else (-2 ** 31, 2 ** 31 - 1)
                ops = [torch.randint(lo, hi, (b, n), generator=gen, device="cuda",
                                     dtype=torch.int32) for _ in range(num_ops - 1)]
                ops.append(torch.arange(n, dtype=torch.int32, device="cuda").expand(b, n))
                got = bs.bitonic_sort(ops, num_keys)
                ref = bs.bitonic_sort_reference(ops, num_keys)
                torch.cuda.synchronize()
                if not all(torch.equal(g, r) for g, r in zip(got, ref)):
                    raise AssertionError(f"K3 differs from plain at B={b} n={n} "
                                         f"ops={num_ops} keys={num_keys} ties={ties}")
                checked += 1
            code = torch.randint(0, 1 << 28, (b, n), generator=gen, device="cuda")
            code[:, -(n // 7):] = 1 << 62
            os.environ[bs.ENV_SWITCH] = "1"
            values, order = bs.sort_int64(code)
            os.environ[bs.ENV_SWITCH] = "0"
            want = torch.sort(code, dim=-1, stable=True)
            if not (torch.equal(values, want.values) and torch.equal(order, want.indices)):
                raise AssertionError(f"sort_int64 differs from torch.sort at B={b} n={n}")
            checked += 1
    emit(dict(phase="sort_check", exact=True, signatures=checked))


def sort_time(reps):
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows, tot = [], dict(ms=0.0, library_ms=0.0, kernel_launches=0)
    for b, n in SORT_SHAPES:
        code = torch.randint(0, 1 << 30, (b, n), generator=gen, device="cuda")
        code[:, -(n // 5):] = 1 << 62
        os.environ[bs.ENV_SWITCH] = "1"
        ms = [cuda_ms(lambda: bs.sort_int64(code), reps) for _ in range(2)]
        os.environ[bs.ENV_SWITCH] = "0"
        lib = [cuda_ms(lambda: bs.sort_int64(code), reps) for _ in range(2)]
        rows.append(dict(B=b, n=n, ms=ms, library_ms=lib, kernel_launches=bs.kernel_launches(n)))
        tot["ms"] += min(ms)
        tot["library_ms"] += min(lib)
        tot["kernel_launches"] += bs.kernel_launches(n)
    emit(dict(phase="sort_time", per_call=rows, per_forward=tot))


def sort_profile():
    """Device time of every kernel of one sort_int64 call, in launch order
    (torch.profiler), at three of the sort shapes."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(4)
    os.environ[bs.ENV_SWITCH] = "1"
    for b, n in ((4, 196608), (1, 196608), (1, 24576)):
        code = torch.randint(0, 1 << 30, (b, n), generator=gen, device="cuda")
        bs.sort_int64(code)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bs.sort_int64(code)
            host_us = (time.perf_counter() - t0) * 1e6
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events() if str(e.device_type).endswith("CUDA")),
                         key=lambda e: e.time_range.start)
        emit(dict(phase="sort_profile", B=b, n=n, host_call_us=host_us,
                  schedule=[p[0] for p in bs.sort_schedule(n)],
                  kernel_us=[round(e.time_range.elapsed_us(), 1) for e in kernels],
                  span_us=(kernels[-1].time_range.end - kernels[0].time_range.start)
                  if kernels else None))
    os.environ[bs.ENV_SWITCH] = "0"


def fps_rows(gen, n, lattice):
    """2 rows of n points, the first 3 slots of row 0 and the last 17 of
    row 1 padded: uniform in a 4 m cube, or a 12.5 cm lattice (exact in
    fp32) slot by slot, row 1 shifted by 3 slots, where distances tie
    everywhere."""
    if lattice:
        side = round(n ** (1 / 3)) + 1
        g = torch.arange(n + 3, device="cuda")
        cells = torch.stack([g // (side * side), (g // side) % side, g % side], -1) * 0.125
        coord = torch.stack([cells[:n], cells[3:]]).float()
    else:
        coord = torch.rand(2, n, 3, generator=gen, device="cuda") * 4.0
    mask = torch.ones(2, n, dtype=torch.bool, device="cuda")
    mask[0, :3] = False
    mask[1, n - 17:] = False
    return coord, mask


def fps_check(m=200):
    gen = torch.Generator(device="cuda").manual_seed(8)
    sizes = [blocks * fps_ops.BLOCK_POINTS + extra for blocks in fps_ops.CLUSTER_SIZES
             for extra in (0, 1)] + [16 * fps_ops.BLOCK_POINTS + 40000, 4096, 4097]
    cases = [(n, False) for n in sizes] + [(n, True) for n in (4096, 51457, 205824)]
    rows = []
    for n, lattice in cases:
        coord, mask = fps_rows(gen, n, lattice)
        before = fps_ops.farthest_point_sampling_cuda.launches
        got, _ = pointops.farthest_point_sampling(coord, mask, m)
        launches = fps_ops.farthest_point_sampling_cuda.launches - before
        want = pointops.farthest_point_sampling_reference(coord, mask, m)
        torch.cuda.synchronize()
        rows.append(dict(n=n, lattice=lattice, blocks=fps_ops.blocks_per_row(n),
                         spills=fps_ops.spills(n), launches=launches,
                         ids_equal=torch.equal(got, want)))
        if not (rows[-1]["ids_equal"] and launches == 1):
            emit(dict(phase="fps_check", failed=rows[-1]))
            raise AssertionError(rows[-1])
    emit(dict(phase="fps_check", samples=m, cases=rows))


def fps_time(reps):
    for name, args in chip_smoke.fps_level_sets().items():
        levels = chip_smoke.fps_levels(*args, reps=reps)
        emit(dict(phase="fps_time", rows=name, **chip_smoke.fps_record(chip_smoke.fps_sums(levels)),
                  levels=[{k: v for k, v in lv.items() if k != "valid"} for lv in levels]))


def agree_shapes():
    """(N, valid counts, K, C, H, launches) of every attention call of the
    flagship file's fp32 model over one row of 49,152 points in a 2.4 m room
    (agree_rows' default), as its forward pools them."""
    from scenesplat_tpu_torch.utils.config import Config

    backbone = dict(Config.fromfile(chip_smoke.FLAGSHIP_CONFIG).model.backbone)
    batch = chip_smoke.cuda_batch(chip_smoke.agree_rows(49152, (7,)))
    model, criteria = chip_smoke.flagship_fp32_model()
    seen, forward = {}, model.forward

    def recording(point, generator=None, **kwargs):
        out = forward(point, generator=generator, **kwargs)
        seen["sizes"] = [(point.mask.shape[1], point.mask.sum(1).tolist())] + [
            (p.out_mask.shape[1], p.out_mask.sum(1).tolist())
            for p in chip_smoke.points_of(out).plans]
        return out

    model.forward = recording
    with torch.no_grad():
        chip_smoke.lang_loss(model, criteria, batch, torch.Generator(device="cuda").manual_seed(11),
                             epoch_progress=1.0)
    del model
    return chip_smoke.stage_shapes(backbone, seen["sizes"])


def widths_time(reps):
    """The fp32 route (K1 with lse, K2) and the bf16_tiled forward in bf16
    and fp16 at the train_agree step's shapes, per call and per step."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows, tot = [], {}
    for n, valids, k, c, h, count in agree_shapes():
        x = torch.randn(len(valids), n, 3, c, generator=gen, device="cuda")
        valid = torch.zeros(len(valids), n, dtype=torch.bool, device="cuda")
        for i, nv in enumerate(valids):
            valid[i, :nv] = True
        dout = torch.randn(len(valids), n, c, generator=gen, device="cuda")
        row = dict(N=n, valid=valids, K=k, C=c, H=h, launches=count,
                   fp32=chip_smoke.time_width_case(x, valid, dout, k, h))
        row["fp32"]["fwd_lse_ms"] = cuda_ms(
            lambda: fwa._forward(x, valid, k, h, (c // h) ** -0.5, True), reps)
        for dtype in (torch.bfloat16, torch.float16):
            x16 = x.to(dtype)
            name = str(dtype).removeprefix("torch.")
            ops_ms, bytes_ms = chip_smoke.typed_bound_ms(n, valids, k, c, dtype)
            p = -(-n // k)
            pad = p * k - n
            x_w = torch.cat([x16, x16.new_zeros(len(valids), pad, 3, c)], 1) if pad else x16
            v_w = torch.cat([valid, valid.new_zeros(len(valids), pad)], 1) if pad else valid
            q, kk, v = x_w.view(len(valids) * p, k, 3, h, c // h).permute(
                2, 0, 3, 1, 4).contiguous()
            mask = v_w.view(len(valids) * p, 1, 1, k)
            err, floor = _tiled_errs(x16, valid, k, h, tiled_call(x16, valid, k, h, False)[0])
            if err > chip_smoke.BF16_NOISE_FACTOR * floor:
                raise AssertionError(f"bf16_tiled {name} error {err} > 2.5 x {floor} at "
                                     f"{(n, k, c, h)}")
            row[f"tiled_{name}"] = dict(
                rel_err=err, plain_rel_err=floor,
                fwd_lse_ms=cuda_ms(lambda: tiled_call(x16, valid, k, h, True), reps),
                fwd_plain_ms=cuda_ms(lambda: fwa.flash_window_attention_plain(x16, valid, k, h),
                                     2, warmup=1),
                fwd_library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, kk, v, attn_mask=mask), reps),
                fwd_bound_ms=max(ops_ms, bytes_ms),
                fwd_bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        rows.append(row)
        for route in ("fp32", "tiled_bfloat16", "tiled_float16"):
            part = tot.setdefault(route, {})
            for key, val in row[route].items():
                if isinstance(val, float) and "rel_err" not in key:
                    part[key] = part.get(key, 0.0) + count * val
        del x, dout
    emit(dict(phase="widths_time", shapes="flagship file, fp32, one row of 49,152 points",
              per_call=rows, per_step=tot))


def _tiled_errs(x16, valid, k, h, out):
    """The tiled forward's relative error and the plain version's, both
    against the plain version in fp32 on the same values."""
    truth = fwa.flash_window_attention_plain(x16.float(), valid, k, h)[valid]

    def rel(o):
        return ((o[valid].float() - truth).norm() / truth.norm()).item()

    return rel(out), rel(fwa.flash_window_attention_plain(x16, valid, k, h))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("what", nargs="*", default=["attn", "sort"])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    libraries = []
    if "attn" in args.what:
        libraries += [fwa.LIBRARY_LARGE, fwa.LIBRARY, fwa.LIBRARY_SMALL]
    if "sort" in args.what:
        libraries.append(bs.LIBRARY)
    if "bwd" in args.what:
        libraries += [fwa.LIBRARY_BWD, fwa.LIBRARY_BWD_LARGE]
    if "fps" in args.what:
        libraries.append(fps_ops.LIBRARY)
    if "widths" in args.what:
        libraries += [lib for lib in (fwa.LIBRARY_LARGE, fwa.LIBRARY, fwa.LIBRARY_SMALL,
                                      fwa.LIBRARY_BWD, fwa.LIBRARY_BWD_LARGE)
                      if lib not in libraries]
    build(libraries)
    if "sort" in args.what:
        sort_check()
        sort_time(args.reps)
        sort_profile()
    if "attn" in args.what:
        attn_check()
        small_time(args.reps)
        attn_time(args.reps)
    if "bwd" in args.what:
        bwd_check()
        bwd_time(args.reps)
    if "fps" in args.what:
        fps_check()
        fps_time(args.reps)
    if "widths" in args.what:
        chip_smoke.phase_kernel_widths()
        widths_time(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
