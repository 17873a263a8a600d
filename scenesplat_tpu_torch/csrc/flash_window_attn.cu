// Flash-window attention for serialized point windows (Hopper, sm_90a):
// the forward (K1) and the backward (K2).
//
// K1 replaces the TPU kernel scenesplat_tpu/ops/pallas_attn.py:_fwd_kernel
// (entered through _fwa_fwd). Input qkv [B, N, 3, C] (fp32, bf16 or fp16), key
// validity [B, N] (one byte per slot), output [B, N, C] and, when training,
// the log-sum-exp of each row's scores, lse [B, N, H] fp32. The sequence is
// cut into windows of K consecutive slots (the last one ragged when
// N % K != 0); every slot attends to the valid slots of its own window, per
// head of width D = C / H:
//
//   S = round(q * scale) . k^T          (fp32 accumulation)
//   P = masked softmax(S)               (fp32; invalid keys get weight 0)
//   O = round(P) . V                    (fp32 accumulation, stored in T)
//
// where round() rounds to the storage type T (bf16, fp16 or, a no-op, fp32), as
// the TPU kernel does. A window whose slot 0 is padding (padding sorts last)
// writes zeros.
//
// K2 in fp32 replaces scenesplat_tpu/ops/pallas_attn.py:_bwd_kernel
// (entered through _fwa_bwd); K2 in bf16 is csrc/flash_window_attn_bwd.cu.
// From qkv, valid, O, lse and dO [B, N, C] it writes dqkv [B, N, 3, C]:
//
//   P  = exp(S - lse) on valid keys     (S recomputed as above)
//   dV = P^T . dO
//   dP = dO . V^T,  delta = rowsum(dO * O)  (= rowsum(dP * P) up to rounding)
//   dS = P * (dP - delta)
//   dQ = scale * dS . K,  dK = scale * dS^T . Q
//
// Two kernels on the caller's stream: K2a (one block per query tile) writes
// delta and dQ; K2b (one block per key tile, looping over the window's query
// tiles) reads delta and writes dK and dV from fp32 accumulators, so no
// atomics and a deterministic result. A padded window writes zero gradients;
// rows past a ragged window's end are neither read as keys nor written.
//
// Design. The TPU kernels keep a whole [K, K] fp32 score tile in VMEM; at
// K = 1024 that is 4 MB, far above the 227 KB of shared memory a block has.
// Here a block owns a tile of query (or key) rows of one (batch, window,
// head); the other side's rows stream through shared memory in tiles. The
// forward keeps an online softmax (running max and sum in fp32); the
// backward recomputes P from the saved lse. Bound: the forward does
// 4*N*K*C operations and the backward 10*N*K*C against about 4*N*C and 9*N*C
// elements moved, so in bf16 both are bound by operations at windows of 1024
// and by bytes at windows of 48 (the flagship config's decoder). Each is
// instantiated for head widths D = 16, 32, 48, 64, 96 and 128;
// ops/flash_window_attn.py pads any other width up to 128 with zero lanes to
// the next of them (exact: zeros add nothing to S, and the extra output and
// gradient lanes are dropped):
//
//  - the bf16 and fp16 forward (the bf16_tiled variant, fp16 through the
//    same code: Elem's packing and mma.sync's .f16 form): four warps, 16 rows each;
//    every product is an mma.sync m16n8k16 tensor-core product with fp32
//    accumulators in registers, and P goes from one product's accumulators
//    to the A operand of the next without leaving registers. Not wgmma/TMA:
//    synchronous tile loads, no warp specialisation. It now serves only the
//    bf16 windows no redesigned forward takes, 65 to 127 and above 4096
//    slots (ops/flash_window_attn.py:forward_variant): windows up to 64 go
//    to flash_window_attn_fwd_small.cu, 128 to 4096 to
//    flash_window_attn_fwd.cu. The C function still takes any window.
//  - fp32, forward and backward: one row per thread with scalar fp32 FMAs,
//    so it stays exact to the plain version (tensor cores would round the
//    products to TF32). From D = 64 on, a row's registers (q, the
//    accumulators and a tile's scores; four rows of D in the dK/dV kernel)
//    would spill, so TPR = 2 or 4 neighbouring threads share a row, each
//    with D / TPR of its lanes, their partial dot products summed by
//    shuffles (F32Cfg); key and query tiles shrink to keep the static
//    shared memory under 48 KB.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwa_common.cuh"

namespace {

// ---- fp32 variant ----------------------------------------------------------

constexpr int BQ = 128;  // threads of a forward or dQ block
constexpr int BKEY = 64;  // threads of a dK/dV block

// fp32 shapes at head width D: TPR threads share a row, each with DT of its
// lanes; BK key rows a forward and dQ tile, BQT query rows a dK/dV tile
template <int D>
struct F32Cfg {
  static constexpr int TPR = D <= 48 ? 1 : (D <= 96 ? 2 : 4);
  static constexpr int DT = D / TPR;
  static constexpr int BK = D <= 64 ? 64 : 32;
  static constexpr int BQT = D <= 64 ? 32 : 16;
  static_assert(DT % 4 == 0 && 32 % TPR == 0, "fp32 shape");
};

// x summed over the TPR neighbouring lanes that share a row
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(BQ)
fwa_fwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, float* __restrict__ lse, int N, int C, int K,
                   int P, float scale) {
  using F = F32Cfg<D>;
  constexpr int TPR = F::TPR, DT = F::DT, BK = F::BK;
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;  // first slot of the window
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * (BQ / TPR);
  const int wlen = min(K, N - w0);  // slots in this (possibly ragged) window
  if (q0 >= wlen) return;           // whole block: past a short window

  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int row = q0 + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DT;  // this thread's lanes of the row
  const bool has_row = row < wlen;
  float* orow = out + (tok0 + row) * C + h * D + d0;

  if (!vwin[0]) {  // whole block: a window of padding writes zeros
    if (has_row) {
#pragma unroll
      for (int d = 0; d < DT; ++d) orow[d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ bool kvalid[BK];

  float q[DT], acc[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    q[d] = has_row ? qkv[(tok0 + row) * stride + h * D + d0 + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -1e30f;  // running max over valid keys (finite: no inf - inf)
  float l = 0.f;     // running sum of exp(s - m)

  for (int t0 = 0; t0 < wlen; t0 += BK) {
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int j = i / D, d = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (t0 + j < wlen) {
        const float* kp = qkv + (tok0 + t0 + j) * stride + C + h * D + d;
        kv = kp[0];
        vv = kp[C];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (threadIdx.x < BK) {
      const int key = t0 + threadIdx.x;
      kvalid[threadIdx.x] = key < wlen && vwin[key] != 0;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DT; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][d0 + d]);
        dot = fmaf(q[d], k4.x, dot);
        dot = fmaf(q[d + 1], k4.y, dot);
        dot = fmaf(q[d + 2], k4.z, dot);
        dot = fmaf(q[d + 3], k4.w, dot);
      }
      dot = row_sum<TPR>(dot);
      s[j] = kvalid[j] ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DT; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float e = kvalid[j] ? expf(s[j] - m_new) : 0.f;
      l += e;
#pragma unroll
      for (int d = 0; d < DT; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][d0 + d]);
        acc[d] = fmaf(e, v4.x, acc[d]);
        acc[d + 1] = fmaf(e, v4.y, acc[d + 1]);
        acc[d + 2] = fmaf(e, v4.z, acc[d + 2]);
        acc[d + 3] = fmaf(e, v4.w, acc[d + 3]);
      }
    }
    m = m_new;
    __syncthreads();
  }

  if (has_row) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d) orow[d] = acc[d] * inv;
    if (lse && d0 == 0) lse[(tok0 + row) * gridDim.y + h] = m + logf(fmaxf(l, 1e-30f));
  }
}

template <int D>
cudaError_t launch_f32(const void* qkv, const void* valid, void* out, float* lse, int B, int N,
                       int C, int H, int K, float scale, cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const int rows = BQ / F32Cfg<D>::TPR;  // rows a block
  const dim3 grid(B * P, H, (K + rows - 1) / rows);
  fwa_fwd_f32_kernel<D><<<grid, BQ, 0, stream>>>(
      static_cast<const float*>(qkv), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), lse, N, C, K, P, scale);
  return cudaGetLastError();
}

// ---- bf16 tensor-core variant (bf16_tiled) ----------------------------------

constexpr int MQ = 64;  // query rows per block: 4 warps x 16
constexpr int MK = 64;  // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(128)
fwa_fwd_tiled_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                     T* __restrict__ out, float* __restrict__ lse, int N, int C, int K, int P,
                     float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using E = Elem<T>;
  constexpr int KSTEPS = D / 16;  // k-steps of q . k over the head dim
  constexpr int NKEY = MK / 8;    // 8-key column tiles of S
  constexpr int NDIM = D / 8;     // 8-wide column tiles of O
  constexpr int KSTR = D + 8;     // padded row strides: conflict-free fragment loads
  constexpr int VSTR = MK + 8;
  __shared__ __align__(16) T ks[MK * KSTR];  // k rows   [key][d]
  __shared__ __align__(16) T vt[D * VSTR];   // v^T rows [d][key]
  __shared__ bool kvalid[MK];

  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * MQ;
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;  // whole block
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;

  if (!vwin[0]) {  // whole block: a window of padding writes zeros
    for (int i = threadIdx.x; i < MQ * D; i += blockDim.x) {
      const int row = q0 + i / D;
      if (row < wlen) out[(tok0 + row) * C + h * D + i % D] = T(0.f);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;  // this thread's rows

  // A fragments of round(q * scale)
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int t = 0; t < KSTEPS; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? row1 : row0;
      const int d = t * 16 + c2 + ((r & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < wlen) {
        const float2 q2 = E::unpack(
            *reinterpret_cast<const uint32_t*>(qkv + (tok0 + row) * stride + h * D + d));
        x0 = q2.x * scale;
        x1 = q2.y * scale;
      }
      qa[t][r] = E::pack(x0, x1);
    }
  }

  float o[NDIM][4];
#pragma unroll
  for (int n = 0; n < NDIM; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running row max (finite: no inf - inf)
  float l[2] = {0.f, 0.f};        // this thread's part of the running row sum

  for (int t0 = 0; t0 < wlen; t0 += MK) {
    constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
    for (int i = threadIdx.x; i < MK * CHUNKS; i += blockDim.x) {
      const int j = i / CHUNKS, part = i - j * CHUNKS;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t0 + j < wlen) {
        const T* kp = qkv + (tok0 + t0 + j) * stride + C + h * D + part * 8;
        kv = *reinterpret_cast<const uint4*>(kp);
        vv = *reinterpret_cast<const uint4*>(kp + C);
      }
      *reinterpret_cast<uint4*>(&ks[j * KSTR + part * 8]) = kv;
      const T* ve = reinterpret_cast<const T*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(part * 8 + e) * VSTR + j] = ve[e];
    }
    if (threadIdx.x < MK) {
      const int key = t0 + threadIdx.x;
      kvalid[threadIdx.x] = key < wlen && vwin[key] != 0;
    }
    __syncthreads();

    // S = q . k^T for this warp's 16 rows and the tile's keys
    float s[NKEY][4];
#pragma unroll
    for (int n = 0; n < NKEY; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const T* krow = &ks[(n * 8 + g) * KSTR + c2];
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        E::mma(s[n], qa[t], *reinterpret_cast<const uint32_t*>(krow + t * 16),
                 *reinterpret_cast<const uint32_t*>(krow + t * 16 + 8));
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NKEY; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!kvalid[n * 8 + c2 + (e & 1)]) s[n][e] = -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < NDIM; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += round(P) . V, 16 keys at a time; P's A fragment is two S tiles
#pragma unroll
    for (int kt = 0; kt < MK / 16; ++kt) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[2 * kt + half][e];
          const float ev = x == -INFINITY ? 0.f : expf(x - m[e >> 1]);
          l[e >> 1] += ev;
          p[half][e] = ev;
        }
      }
      const uint32_t pa[4] = {E::pack(p[0][0], p[0][1]), E::pack(p[0][2], p[0][3]),
                              E::pack(p[1][0], p[1][1]), E::pack(p[1][2], p[1][3])};
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        const T* vrow = &vt[(n * 8 + g) * VSTR + kt * 16 + c2];
        E::mma(o[n], pa, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r ? row1 : row0;
    if (lse && (lane & 3) == 0 && row < wlen)
      lse[(tok0 + row) * gridDim.y + h] = m[r] + logf(fmaxf(l[r], 1e-30f));
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < NDIM; ++n) {
    const int d = h * D + n * 8 + c2;
    if (row0 < wlen)
      *reinterpret_cast<uint32_t*>(out + (tok0 + row0) * C + d) =
          E::pack(o[n][0] * l[0], o[n][1] * l[0]);
    if (row1 < wlen)
      *reinterpret_cast<uint32_t*>(out + (tok0 + row1) * C + d) =
          E::pack(o[n][2] * l[1], o[n][3] * l[1]);
  }
}

template <typename T, int D>
cudaError_t launch_tiled_t(const void* qkv, const void* valid, void* out, float* lse, int B,
                           int N, int C, int H, int K, float scale, cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const dim3 grid(B * P, H, (K + MQ - 1) / MQ);
  fwa_fwd_tiled_kernel<T, D><<<grid, 128, 0, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(valid), static_cast<T*>(out), lse,
      N, C, K, P, scale);
  return cudaGetLastError();
}

// head width D in the storage type `dtype` (1 bf16, 2 fp16)
template <int D>
cudaError_t launch_tiled(int dtype, const void* qkv, const void* valid, void* out, float* lse,
                         int B, int N, int C, int H, int K, float scale, cudaStream_t s) {
  if (dtype == 1) return launch_tiled_t<bf16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, s);
  if (dtype == 2) return launch_tiled_t<fp16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, s);
  return cudaErrorInvalidValue;
}

// ---- K2, fp32 variant --------------------------------------------------------

// dQ and delta: one query row per TPR threads, key and value tiles in shared
// memory
template <int D>
__global__ void __launch_bounds__(BQ)
fwa_bwd_dq_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                      const float* __restrict__ out, const float* __restrict__ lse,
                      const float* __restrict__ dout, float* __restrict__ dqkv,
                      float* __restrict__ delta, int N, int C, int K, int P, float scale) {
  using F = F32Cfg<D>;
  constexpr int TPR = F::TPR, DT = F::DT, BK = F::BK;
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.z * (BQ / TPR);
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int row = q0 + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DT;
  const bool has_row = row < wlen;
  float* dqrow = dqkv + (tok0 + row) * stride + h * D + d0;

  if (!vwin[0]) {  // whole block: a window of padding gets zero gradients
    if (has_row) {
#pragma unroll
      for (int d = 0; d < DT; ++d) dqrow[d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ bool kvalid[BK];

  float q[DT], g[DT], dq[DT];
  float dl = 0.f, lrow = 0.f;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const size_t at = (tok0 + row) * C + h * D + d0 + d;
    q[d] = has_row ? qkv[(tok0 + row) * stride + h * D + d0 + d] * scale : 0.f;
    g[d] = has_row ? dout[at] : 0.f;
    dl = fmaf(g[d], has_row ? out[at] : 0.f, dl);
    dq[d] = 0.f;
  }
  dl = row_sum<TPR>(dl);
  if (has_row) {
    if (d0 == 0) delta[(tok0 + row) * H + h] = dl;
    lrow = lse[(tok0 + row) * H + h];
  }

  for (int t0 = 0; t0 < wlen; t0 += BK) {
    for (int i = threadIdx.x; i < BK * D; i += BQ) {
      const int j = i / D, d = i - j * D;
      float kv = 0.f, vv = 0.f;
      if (t0 + j < wlen) {
        const float* kp = qkv + (tok0 + t0 + j) * stride + C + h * D + d;
        kv = kp[0];
        vv = kp[C];
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (threadIdx.x < BK) {
      const int key = t0 + threadIdx.x;
      kvalid[threadIdx.x] = key < wlen && vwin[key] != 0;
    }
    __syncthreads();
    // every thread runs the loop (a row's lanes sum across threads); rows
    // past the window's end carry zeros and are not written
    for (int j = 0; j < BK; ++j) {
      if (!kvalid[j]) continue;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        s = fmaf(q[d], ks[j][d0 + d], s);
        dp = fmaf(g[d], vs[j][d0 + d], dp);
      }
      s = row_sum<TPR>(s);
      dp = row_sum<TPR>(dp);
      const float ds = expf(s - lrow) * (dp - dl);
#pragma unroll
      for (int d = 0; d < DT; ++d) dq[d] = fmaf(ds, ks[j][d0 + d], dq[d]);
    }
    __syncthreads();
  }
  if (has_row) {
#pragma unroll
    for (int d = 0; d < DT; ++d) dqrow[d] = scale * dq[d];
  }
}

// dK and dV: one key row per TPR threads, query tiles in shared memory
template <int D>
__global__ void __launch_bounds__(BKEY)
fwa_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ dout, float* __restrict__ dqkv, int N,
                       int C, int K, int P, float scale) {
  using F = F32Cfg<D>;
  constexpr int TPR = F::TPR, DT = F::DT, BQT = F::BQT;
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int k0 = blockIdx.z * (BKEY / TPR);
  const int wlen = min(K, N - w0);
  if (k0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int key = k0 + threadIdx.x / TPR;
  const int d0 = (threadIdx.x % TPR) * DT;
  const bool has_key = key < wlen;
  float* dkrow = dqkv + (tok0 + key) * stride + C + h * D + d0;

  if (!vwin[0]) {
    if (has_key) {
#pragma unroll
      for (int d = 0; d < DT; ++d) dkrow[d] = dkrow[C + d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float qs[BQT][D];  // q * scale
  __shared__ __align__(16) float qr[BQT][D];  // q
  __shared__ __align__(16) float gs[BQT][D];  // dO
  __shared__ float lse_s[BQT], del_s[BQT];
  __shared__ bool qok[BQT];

  const bool kok = has_key && vwin[key] != 0;
  float k[DT], v[DT], dk[DT], dv[DT];
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const float* kp = qkv + (tok0 + key) * stride + C + h * D + d0 + d;
    k[d] = kok ? kp[0] : 0.f;
    v[d] = kok ? kp[C] : 0.f;
    dk[d] = dv[d] = 0.f;
  }

  for (int t0 = 0; t0 < wlen; t0 += BQT) {
    for (int i = threadIdx.x; i < BQT * D; i += BKEY) {
      const int j = i / D, d = i - j * D;
      const int row = t0 + j;
      float qv = 0.f, gv = 0.f;
      if (row < wlen) {
        qv = qkv[(tok0 + row) * stride + h * D + d];
        gv = dout[(tok0 + row) * C + h * D + d];
      }
      qs[j][d] = qv * scale;
      qr[j][d] = qv;
      gs[j][d] = gv;
    }
    if (threadIdx.x < BQT) {
      const int row = t0 + threadIdx.x;
      const bool ok = row < wlen;
      qok[threadIdx.x] = ok;
      lse_s[threadIdx.x] = ok ? lse[(tok0 + row) * H + h] : 0.f;
      del_s[threadIdx.x] = ok ? delta[(tok0 + row) * H + h] : 0.f;
    }
    __syncthreads();
    // one row's TPR threads sum across each other, so every thread runs the
    // loop; an invalid key's p is 0 and adds nothing
    if (TPR > 1 || kok) {
      for (int i = 0; i < BQT; ++i) {
        if (!qok[i]) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          s = fmaf(qs[i][d0 + d], k[d], s);
          dp = fmaf(gs[i][d0 + d], v[d], dp);
        }
        s = row_sum<TPR>(s);
        dp = row_sum<TPR>(dp);
        const float p = kok ? expf(s - lse_s[i]) : 0.f;
        const float ds = p * (dp - del_s[i]);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          dv[d] = fmaf(p, gs[i][d0 + d], dv[d]);
          dk[d] = fmaf(ds, qr[i][d0 + d], dk[d]);
        }
      }
    }
    __syncthreads();
  }
  if (has_key) {
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      dkrow[d] = scale * dk[d];
      dkrow[C + d] = dv[d];
    }
  }
}

template <int D>
cudaError_t launch_bwd_f32(const void* qkv, const void* valid, const void* out,
                           const float* lse, const void* dout, void* dqkv, float* delta,
                           int B, int N, int C, int H, int K, float scale,
                           cudaStream_t stream) {
  constexpr int TPR = F32Cfg<D>::TPR;
  const int P = (N + K - 1) / K;
  const int rows_q = BQ / TPR, rows_k = BKEY / TPR;  // rows a block
  const dim3 grid_q(B * P, H, (K + rows_q - 1) / rows_q);
  const dim3 grid_k(B * P, H, (K + rows_k - 1) / rows_k);
  const auto* q = static_cast<const float*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* g = static_cast<const float*>(dout);
  auto* dq = static_cast<float*>(dqkv);
  fwa_bwd_dq_f32_kernel<D><<<grid_q, BQ, 0, stream>>>(
      q, v, static_cast<const float*>(out), lse, g, dq, delta, N, C, K, P, scale);
  if (cudaError_t e = cudaGetLastError()) return e;
  fwa_bwd_dkv_f32_kernel<D><<<grid_k, BKEY, 0, stream>>>(q, v, lse, delta, g, dq, N, C, K, P,
                                                         scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; head widths 16, 32, 48, 64,
// 96 and 128 (the wrapper pads any other width up to 128 to the next of
// them). lse may be null (inference). Returns a cudaError_t (0 on success),
// cudaErrorInvalidValue for what it was not built for.
extern "C" int fwa_fwd(const void* qkv, const void* valid, void* out, void* lse, int dtype,
                       int B, int N, int C, int H, int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || C % H != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (C / H) {
    case 16:
      return dtype == 0 ? launch_f32<16>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<16>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 32:
      return dtype == 0 ? launch_f32<32>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<32>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 48:
      return dtype == 0 ? launch_f32<48>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<48>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 64:
      return dtype == 0 ? launch_f32<64>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<64>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 96:
      return dtype == 0 ? launch_f32<96>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<96>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 128:
      return dtype == 0 ? launch_f32<128>(qkv, valid, out, l, B, N, C, H, K, scale, s)
                        : launch_tiled<128>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The fp32 backward: dqkv [B, N, 3, C] from qkv, valid, the forward's out
// and lse, and dout [B, N, C]; delta [B, N, H] fp32 is scratch. K2a then K2b
// on one stream. The bf16 and fp16 backward is csrc/flash_window_attn_bwd.cu.
extern "C" int fwa_bwd(const void* qkv, const void* valid, const void* out, const void* lse,
                       const void* dout, void* dqkv, void* delta, int B, int N, int C, int H,
                       int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || C % H != 0) return cudaErrorInvalidValue;
  const auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C / H) {
    case 16:
      return launch_bwd_f32<16>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 32:
      return launch_bwd_f32<32>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 48:
      return launch_bwd_f32<48>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 64:
      return launch_bwd_f32<64>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 96:
      return launch_bwd_f32<96>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 128:
      return launch_bwd_f32<128>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
