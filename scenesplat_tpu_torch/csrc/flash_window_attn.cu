// Flash-window attention for serialized point windows (Hopper, sm_90a):
// the forward (K1) and the backward (K2).
//
// K1 replaces the TPU kernel scenesplat_tpu/ops/pallas_attn.py:_fwd_kernel
// (entered through _fwa_fwd). Input qkv [B, N, 3, C] (fp32 or bf16), key
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
// where round() rounds to the storage type T (bf16 or, a no-op, fp32), as
// the TPU kernel does. A window whose slot 0 is padding (padding sorts last)
// writes zeros.
//
// K2 replaces scenesplat_tpu/ops/pallas_attn.py:_bwd_kernel (entered through
// _fwa_bwd). From qkv, valid, O, lse and dO [B, N, C] it writes dqkv
// [B, N, 3, C], rounding where the TPU kernel rounds:
//
//   P  = exp(S - lse) on valid keys     (fp32, S recomputed as above)
//   dV = round(P)^T . dO                (fp32 accumulation)
//   dP = dO . V^T,  delta = rowsum(dO * O)  (= rowsum(dP * P) up to rounding)
//   dS = round(P * (dP - delta))
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
// and by bytes at windows of 48 (the flagship config's decoder). One variant
// per storage type, each instantiated for the main path's head widths
// D = 16, 32 and 48:
//
//  - bf16: four warps, 16 rows each; every product is an mma.sync m16n8k16
//    tensor-core product with fp32 accumulators in registers, and P (or dS)
//    goes from one product's accumulators to the A operand of the next
//    without leaving registers. Not wgmma/TMA: synchronous tile loads, no
//    warp specialisation.
//  - fp32: one row per thread with scalar fp32 FMAs, so it stays exact to
//    the plain version (tensor cores would round the products to TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- fp32 variant ----------------------------------------------------------

constexpr int BQ = 128;  // query rows per block, one per thread
constexpr int BK = 64;   // key rows per shared-memory tile

template <int D>
__global__ void __launch_bounds__(BQ)
fwa_fwd_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                   float* __restrict__ out, float* __restrict__ lse, int N, int C, int K,
                   int P, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;  // first slot of the window
  const int h = blockIdx.y;
  const int q0 = blockIdx.z * BQ;
  const int wlen = min(K, N - w0);  // slots in this (possibly ragged) window
  if (q0 >= wlen) return;           // whole block: past a short window

  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int row = q0 + threadIdx.x;
  const bool has_row = row < wlen;
  float* orow = out + (tok0 + row) * C + h * D;

  if (!vwin[0]) {  // whole block: a window of padding writes zeros
    if (has_row) {
#pragma unroll
      for (int d = 0; d < D; ++d) orow[d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ bool kvalid[BK];

  float q[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = has_row ? qkv[(tok0 + row) * stride + h * D + d] * scale : 0.f;
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
      for (int d = 0; d < D; d += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&ks[j][d]);
        dot = fmaf(q[d], k4.x, dot);
        dot = fmaf(q[d + 1], k4.y, dot);
        dot = fmaf(q[d + 2], k4.z, dot);
        dot = fmaf(q[d + 3], k4.w, dot);
      }
      s[j] = kvalid[j] ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float e = kvalid[j] ? expf(s[j] - m_new) : 0.f;
      l += e;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][d]);
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
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
    if (lse) lse[(tok0 + row) * gridDim.y + h] = m + logf(fmaxf(l, 1e-30f));
  }
}

cudaError_t launch_f32(const void* qkv, const void* valid, void* out, float* lse, int B,
                       int N, int C, int H, int K, float scale, cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const dim3 grid(B * P, H, (K + BQ - 1) / BQ);
  const auto* q = static_cast<const float*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<float*>(out);
  switch (C / H) {
    case 16: fwa_fwd_f32_kernel<16><<<grid, BQ, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    case 32: fwa_fwd_f32_kernel<32><<<grid, BQ, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    case 48: fwa_fwd_f32_kernel<48><<<grid, BQ, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- bf16 tensor-core variant ---------------------------------------------

constexpr int MQ = 64;  // query rows per block: 4 warps x 16
constexpr int MK = 64;  // keys per shared-memory tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a . b for one m16n8k16 tile (bf16 inputs, fp32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(128)
fwa_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                   const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ lse, int N, int C, int K, int P, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KSTEPS = D / 16;  // k-steps of q . k over the head dim
  constexpr int NKEY = MK / 8;    // 8-key column tiles of S
  constexpr int NDIM = D / 8;     // 8-wide column tiles of O
  constexpr int KSTR = D + 8;     // padded row strides: conflict-free fragment loads
  constexpr int VSTR = MK + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[MK * KSTR];  // k rows   [key][d]
  __shared__ __align__(16) __nv_bfloat16 vt[D * VSTR];   // v^T rows [d][key]
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
      if (row < wlen) out[(tok0 + row) * C + h * D + i % D] = __float2bfloat16_rn(0.f);
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
        const __nv_bfloat16* qp = qkv + (tok0 + row) * stride + h * D + d;
        x0 = __bfloat162float(qp[0]) * scale;
        x1 = __bfloat162float(qp[1]) * scale;
      }
      qa[t][r] = pack_bf16(x0, x1);
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
        const __nv_bfloat16* kp = qkv + (tok0 + t0 + j) * stride + C + h * D + part * 8;
        kv = *reinterpret_cast<const uint4*>(kp);
        vv = *reinterpret_cast<const uint4*>(kp + C);
      }
      *reinterpret_cast<uint4*>(&ks[j * KSTR + part * 8]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
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
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * KSTR + c2];
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        mma_bf16(s[n], qa[t], *reinterpret_cast<const uint32_t*>(krow + t * 16),
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
      const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                              pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        const __nv_bfloat16* vrow = &vt[(n * 8 + g) * VSTR + kt * 16 + c2];
        mma_bf16(o[n], pa, *reinterpret_cast<const uint32_t*>(vrow),
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
          pack_bf16(o[n][0] * l[0], o[n][1] * l[0]);
    if (row1 < wlen)
      *reinterpret_cast<uint32_t*>(out + (tok0 + row1) * C + d) =
          pack_bf16(o[n][2] * l[1], o[n][3] * l[1]);
  }
}

cudaError_t launch_bf16(const void* qkv, const void* valid, void* out, float* lse, int B,
                        int N, int C, int H, int K, float scale, cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const dim3 grid(B * P, H, (K + MQ - 1) / MQ);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<__nv_bfloat16*>(out);
  switch (C / H) {
    case 16: fwa_fwd_bf16_kernel<16><<<grid, 128, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    case 32: fwa_fwd_bf16_kernel<32><<<grid, 128, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    case 48: fwa_fwd_bf16_kernel<48><<<grid, 128, 0, stream>>>(q, v, o, lse, N, C, K, P, scale); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- K2, fp32 variant --------------------------------------------------------

// dQ and delta: one query row per thread, key and value tiles in shared memory
template <int D>
__global__ void __launch_bounds__(BQ)
fwa_bwd_dq_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                      const float* __restrict__ out, const float* __restrict__ lse,
                      const float* __restrict__ dout, float* __restrict__ dqkv,
                      float* __restrict__ delta, int N, int C, int K, int P, float scale) {
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.z * BQ;
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int row = q0 + threadIdx.x;
  const bool has_row = row < wlen;
  float* dqrow = dqkv + (tok0 + row) * stride + h * D;

  if (!vwin[0]) {  // whole block: a window of padding gets zero gradients
    if (has_row) {
#pragma unroll
      for (int d = 0; d < D; ++d) dqrow[d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];
  __shared__ bool kvalid[BK];

  float q[D], g[D], dq[D];
  float dl = 0.f, lrow = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = has_row ? qkv[(tok0 + row) * stride + h * D + d] * scale : 0.f;
    g[d] = has_row ? dout[(tok0 + row) * C + h * D + d] : 0.f;
    dl = fmaf(g[d], has_row ? out[(tok0 + row) * C + h * D + d] : 0.f, dl);
    dq[d] = 0.f;
  }
  if (has_row) {
    delta[(tok0 + row) * H + h] = dl;
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
    if (has_row) {
      for (int j = 0; j < BK; ++j) {
        if (!kvalid[j]) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(q[d], ks[j][d], s);
          dp = fmaf(g[d], vs[j][d], dp);
        }
        const float ds = expf(s - lrow) * (dp - dl);
#pragma unroll
        for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, ks[j][d], dq[d]);
      }
    }
    __syncthreads();
  }
  if (has_row) {
#pragma unroll
    for (int d = 0; d < D; ++d) dqrow[d] = scale * dq[d];
  }
}

constexpr int BKEY = 64;  // key rows per block of the fp32 dK/dV kernel
constexpr int BQT = 32;   // query rows per shared-memory tile there

// dK and dV: one key row per thread, query tiles in shared memory
template <int D>
__global__ void __launch_bounds__(BKEY)
fwa_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const uint8_t* __restrict__ valid,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       const float* __restrict__ dout, float* __restrict__ dqkv, int N,
                       int C, int K, int P, float scale) {
  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int k0 = blockIdx.z * BKEY;
  const int wlen = min(K, N - w0);
  if (k0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int key = k0 + threadIdx.x;
  const bool has_key = key < wlen;
  float* dkrow = dqkv + (tok0 + key) * stride + C + h * D;

  if (!vwin[0]) {
    if (has_key) {
#pragma unroll
      for (int d = 0; d < D; ++d) dkrow[d] = dkrow[C + d] = 0.f;
    }
    return;
  }

  __shared__ __align__(16) float qs[BQT][D];  // q * scale
  __shared__ __align__(16) float qr[BQT][D];  // q
  __shared__ __align__(16) float gs[BQT][D];  // dO
  __shared__ float lse_s[BQT], del_s[BQT];
  __shared__ bool qok[BQT];

  const bool kok = has_key && vwin[key] != 0;
  float k[D], v[D], dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float* kp = qkv + (tok0 + key) * stride + C + h * D + d;
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
    if (kok) {
      for (int i = 0; i < BQT; ++i) {
        if (!qok[i]) continue;
        float s = 0.f, dp = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[i][d], k[d], s);
          dp = fmaf(gs[i][d], v[d], dp);
        }
        const float p = expf(s - lse_s[i]);
        const float ds = p * (dp - del_s[i]);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          dv[d] = fmaf(p, gs[i][d], dv[d]);
          dk[d] = fmaf(ds, qr[i][d], dk[d]);
        }
      }
    }
    __syncthreads();
  }
  if (has_key) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      dkrow[d] = scale * dk[d];
      dkrow[C + d] = dv[d];
    }
  }
}

cudaError_t launch_bwd_f32(const void* qkv, const void* valid, const void* out,
                           const float* lse, const void* dout, void* dqkv, float* delta,
                           int B, int N, int C, int H, int K, float scale,
                           cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const dim3 grid_q(B * P, H, (K + BQ - 1) / BQ), grid_k(B * P, H, (K + BKEY - 1) / BKEY);
  const auto* q = static_cast<const float*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* o = static_cast<const float*>(out);
  const auto* g = static_cast<const float*>(dout);
  auto* dq = static_cast<float*>(dqkv);
  switch (C / H) {
#define FWA_BWD_F32(D)                                                                    \
  case D:                                                                                 \
    fwa_bwd_dq_f32_kernel<D><<<grid_q, BQ, 0, stream>>>(q, v, o, lse, g, dq, delta, N, C, \
                                                        K, P, scale);                     \
    if (cudaError_t e = cudaGetLastError()) return e;                                     \
    fwa_bwd_dkv_f32_kernel<D><<<grid_k, BKEY, 0, stream>>>(q, v, lse, delta, g, dq, N, C, \
                                                           K, P, scale);                  \
    break;
    FWA_BWD_F32(16)
    FWA_BWD_F32(32)
    FWA_BWD_F32(48)
#undef FWA_BWD_F32
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// ---- K2, bf16 tensor-core variant --------------------------------------------

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragments of rows r0 / r0 + 8 of a [rows, D] bf16 block at src (row
// stride ``stride`` elements), times ``mul`` (1 or the softmax scale) and
// rounded to bf16; rows at or past ``wlen`` are zero
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[D / 16][4], const __nv_bfloat16* src,
                                       size_t stride, int r0, int c2, int wlen, float mul) {
#pragma unroll
  for (int t = 0; t < D / 16; ++t) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + ((r & 1) ? 8 : 0);
      const int d = t * 16 + c2 + ((r & 2) ? 8 : 0);
      float x0 = 0.f, x1 = 0.f;
      if (row < wlen) {
        const __nv_bfloat16* p = src + row * stride + d;
        x0 = __bfloat162float(p[0]) * mul;
        x1 = __bfloat162float(p[1]) * mul;
      }
      a[t][r] = pack_bf16(x0, x1);
    }
  }
}

// dQ and delta: four warps of 16 query rows; S, dP and dS . K on mma.sync
template <int D>
__global__ void __launch_bounds__(128)
fwa_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                       const uint8_t* __restrict__ valid,
                       const __nv_bfloat16* __restrict__ out, const float* __restrict__ lse,
                       const __nv_bfloat16* __restrict__ dout,
                       __nv_bfloat16* __restrict__ dqkv, float* __restrict__ delta, int N,
                       int C, int K, int P, float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NKEY = MK / 8;
  constexpr int NDIM = D / 8;
  constexpr int KSTR = D + 8;   // [key][d] rows
  constexpr int TSTR = MK + 8;  // [d][key] rows
  __shared__ __align__(16) __nv_bfloat16 ks[MK * KSTR];  // k
  __shared__ __align__(16) __nv_bfloat16 kt[D * TSTR];   // k^T
  __shared__ __align__(16) __nv_bfloat16 vs[MK * KSTR];  // v
  __shared__ bool kvalid[MK];
  __shared__ float delta_s[MQ];

  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int q0 = blockIdx.z * MQ;
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;

  if (!vwin[0]) {
    for (int i = threadIdx.x; i < MQ * D; i += blockDim.x) {
      const int row = q0 + i / D;
      if (row < wlen) dqkv[(tok0 + row) * stride + h * D + i % D] = __float2bfloat16_rn(0.f);
    }
    return;
  }

  if (threadIdx.x < MQ) {  // delta of this tile's rows, fp32
    const int row = q0 + threadIdx.x;
    float dl = 0.f;
    if (row < wlen) {
      const __nv_bfloat16* op = out + (tok0 + row) * C + h * D;
      const __nv_bfloat16* gp = dout + (tok0 + row) * C + h * D;
      for (int d = 0; d < D; ++d)
        dl = fmaf(__bfloat162float(op[d]), __bfloat162float(gp[d]), dl);
      delta[(tok0 + row) * H + h] = dl;
    }
    delta_s[threadIdx.x] = dl;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[KSTEPS][4], ga[KSTEPS][4];
  load_a<D>(qa, qkv + tok0 * stride + h * D, stride, r0, c2, wlen, scale);
  load_a<D>(ga, dout + tok0 * C + h * D, C, r0, c2, wlen, 1.f);
  float lrow[2];
  bool rok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    rok[r] = row < wlen;
    lrow[r] = rok[r] ? lse[(tok0 + row) * H + h] : 0.f;
  }

  float dq[NDIM][4];
#pragma unroll
  for (int n = 0; n < NDIM; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  for (int t0 = 0; t0 < wlen; t0 += MK) {
    constexpr int CHUNKS = D / 8;
    for (int i = threadIdx.x; i < MK * CHUNKS; i += blockDim.x) {
      const int j = i / CHUNKS, part = i - j * CHUNKS;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (t0 + j < wlen) {
        const __nv_bfloat16* kp = qkv + (tok0 + t0 + j) * stride + C + h * D + part * 8;
        kv = *reinterpret_cast<const uint4*>(kp);
        vv = *reinterpret_cast<const uint4*>(kp + C);
      }
      *reinterpret_cast<uint4*>(&ks[j * KSTR + part * 8]) = kv;
      *reinterpret_cast<uint4*>(&vs[j * KSTR + part * 8]) = vv;
      const __nv_bfloat16* ke = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
      for (int e = 0; e < 8; ++e) kt[(part * 8 + e) * TSTR + j] = ke[e];
    }
    if (threadIdx.x < MK) {
      const int key = t0 + threadIdx.x;
      kvalid[threadIdx.x] = key < wlen && vwin[key] != 0;
    }
    __syncthreads();
    const float dl[2] = {delta_s[warp * 16 + g], delta_s[warp * 16 + g + 8]};

    float s[NKEY][4], dp[NKEY][4];
#pragma unroll
    for (int n = 0; n < NKEY; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const __nv_bfloat16* krow = &ks[(n * 8 + g) * KSTR + c2];
      const __nv_bfloat16* vrow = &vs[(n * 8 + g) * KSTR + c2];
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        mma_bf16(s[n], qa[t], lds32(krow + t * 16), lds32(krow + t * 16 + 8));
        mma_bf16(dp[n], ga[t], lds32(vrow + t * 16), lds32(vrow + t * 16 + 8));
      }
    }
    // dS = P * (dP - delta), kept in s
#pragma unroll
    for (int n = 0; n < NKEY; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p =
            kvalid[n * 8 + c2 + (e & 1)] && rok[r] ? expf(s[n][e] - lrow[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[r]);
      }
    }
    // dQ += round(dS) . K, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t sa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        const __nv_bfloat16* trow = &kt[(n * 8 + g) * TSTR + kk * 16 + c2];
        mma_bf16(dq[n], sa, lds32(trow), lds32(trow + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < NDIM; ++n) {
    const int d = h * D + n * 8 + c2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rok[r])
        *reinterpret_cast<uint32_t*>(dqkv + (tok0 + r0 + 8 * r) * stride + d) =
            pack_bf16(scale * dq[n][2 * r], scale * dq[n][2 * r + 1]);
    }
  }
}

// dK and dV: four warps of 16 key rows looping over the window's query
// tiles; S^T, dP^T, round(P)^T . dO and round(dS)^T . Q on mma.sync
template <int D>
__global__ void __launch_bounds__(128)
fwa_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ qkv,
                        const uint8_t* __restrict__ valid, const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const __nv_bfloat16* __restrict__ dout,
                        __nv_bfloat16* __restrict__ dqkv, int N, int C, int K, int P,
                        float scale) {
  constexpr int KSTEPS = D / 16;
  constexpr int NQRY = MQ / 8;  // 8-query column tiles of S^T
  constexpr int NDIM = D / 8;
  constexpr int RSTR = D + 8;   // [query][d] rows
  constexpr int TSTR = MQ + 8;  // [d][query] rows
  __shared__ __align__(16) __nv_bfloat16 qs[MQ * RSTR];  // round(q * scale)
  __shared__ __align__(16) __nv_bfloat16 qt[D * TSTR];   // q^T
  __shared__ __align__(16) __nv_bfloat16 gs[MQ * RSTR];  // dO
  __shared__ __align__(16) __nv_bfloat16 gt[D * TSTR];   // dO^T
  __shared__ float lse_s[MQ], delta_s[MQ];
  __shared__ bool qok[MQ];

  const int b = blockIdx.x / P;
  const int w0 = (blockIdx.x - b * P) * K;
  const int h = blockIdx.y, H = gridDim.y;
  const int k0 = blockIdx.z * MK;
  const int wlen = min(K, N - w0);
  if (k0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;

  if (!vwin[0]) {
    for (int i = threadIdx.x; i < MK * D; i += blockDim.x) {
      const int row = k0 + i / D;
      if (row < wlen) {
        __nv_bfloat16* p = dqkv + (tok0 + row) * stride + C + h * D + i % D;
        p[0] = p[C] = __float2bfloat16_rn(0.f);
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int r0 = k0 + warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  uint32_t ka[KSTEPS][4], va[KSTEPS][4];
  load_a<D>(ka, qkv + tok0 * stride + C + h * D, stride, r0, c2, wlen, 1.f);
  load_a<D>(va, qkv + tok0 * stride + 2 * C + h * D, stride, r0, c2, wlen, 1.f);
  bool kok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) kok[r] = r0 + 8 * r < wlen && vwin[r0 + 8 * r] != 0;

  float dk[NDIM][4], dv[NDIM][4];
#pragma unroll
  for (int n = 0; n < NDIM; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int t0 = 0; t0 < wlen; t0 += MQ) {
    constexpr int CHUNKS = D / 8;
    for (int i = threadIdx.x; i < MQ * CHUNKS; i += blockDim.x) {
      const int j = i / CHUNKS, part = i - j * CHUNKS;
      uint4 qv = make_uint4(0, 0, 0, 0), gv = make_uint4(0, 0, 0, 0);
      if (t0 + j < wlen) {
        qv = *reinterpret_cast<const uint4*>(qkv + (tok0 + t0 + j) * stride + h * D + part * 8);
        gv = *reinterpret_cast<const uint4*>(dout + (tok0 + t0 + j) * C + h * D + part * 8);
      }
      *reinterpret_cast<uint4*>(&gs[j * RSTR + part * 8]) = gv;
      const __nv_bfloat16* qe = reinterpret_cast<const __nv_bfloat16*>(&qv);
      const __nv_bfloat16* ge = reinterpret_cast<const __nv_bfloat16*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qs[j * RSTR + part * 8 + e] = __float2bfloat16_rn(__bfloat162float(qe[e]) * scale);
        qt[(part * 8 + e) * TSTR + j] = qe[e];
        gt[(part * 8 + e) * TSTR + j] = ge[e];
      }
    }
    if (threadIdx.x < MQ) {
      const int row = t0 + threadIdx.x;
      const bool ok = row < wlen;
      qok[threadIdx.x] = ok;
      lse_s[threadIdx.x] = ok ? lse[(tok0 + row) * H + h] : 0.f;
      delta_s[threadIdx.x] = ok ? delta[(tok0 + row) * H + h] : 0.f;
    }
    __syncthreads();

    // S^T = k . round(q * scale)^T and dP^T = v . dO^T for 16 keys x 64 queries
    float s[NQRY][4], dp[NQRY][4];
#pragma unroll
    for (int n = 0; n < NQRY; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      const __nv_bfloat16* qrow = &qs[(n * 8 + g) * RSTR + c2];
      const __nv_bfloat16* grow = &gs[(n * 8 + g) * RSTR + c2];
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        mma_bf16(s[n], ka[t], lds32(qrow + t * 16), lds32(qrow + t * 16 + 8));
        mma_bf16(dp[n], va[t], lds32(grow + t * 16), lds32(grow + t * 16 + 8));
      }
    }
    // P^T in s, dS^T in dp
#pragma unroll
    for (int n = 0; n < NQRY; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + c2 + (e & 1);
        const float p = kok[e >> 1] && qok[qi] ? expf(s[n][e] - lse_s[qi]) : 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - delta_s[qi]);
      }
    }
    // dV += round(P)^T . dO and dK += round(dS)^T . Q, 16 queries at a time
#pragma unroll
    for (int kk = 0; kk < MQ / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint32_t sa[4] = {pack_bf16(dp[2 * kk][0], dp[2 * kk][1]),
                              pack_bf16(dp[2 * kk][2], dp[2 * kk][3]),
                              pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
                              pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        const __nv_bfloat16* grow = &gt[(n * 8 + g) * TSTR + kk * 16 + c2];
        const __nv_bfloat16* qrow = &qt[(n * 8 + g) * TSTR + kk * 16 + c2];
        mma_bf16(dv[n], pa, lds32(grow), lds32(grow + 8));
        mma_bf16(dk[n], sa, lds32(qrow), lds32(qrow + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < NDIM; ++n) {
    const int d = h * D + n * 8 + c2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < wlen) {
        __nv_bfloat16* p = dqkv + (tok0 + row) * stride + C + d;
        *reinterpret_cast<uint32_t*>(p) =
            pack_bf16(scale * dk[n][2 * r], scale * dk[n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(p + C) = pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
      }
    }
  }
}

cudaError_t launch_bwd_bf16(const void* qkv, const void* valid, const void* out,
                            const float* lse, const void* dout, void* dqkv, float* delta,
                            int B, int N, int C, int H, int K, float scale,
                            cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const dim3 grid_q(B * P, H, (K + MQ - 1) / MQ), grid_k(B * P, H, (K + MK - 1) / MK);
  const auto* q = static_cast<const __nv_bfloat16*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* o = static_cast<const __nv_bfloat16*>(out);
  const auto* g = static_cast<const __nv_bfloat16*>(dout);
  auto* dq = static_cast<__nv_bfloat16*>(dqkv);
  switch (C / H) {
#define FWA_BWD_BF16(D)                                                                     \
  case D:                                                                                   \
    fwa_bwd_dq_bf16_kernel<D><<<grid_q, 128, 0, stream>>>(q, v, o, lse, g, dq, delta, N, C, \
                                                          K, P, scale);                     \
    if (cudaError_t e = cudaGetLastError()) return e;                                       \
    fwa_bwd_dkv_bf16_kernel<D><<<grid_k, 128, 0, stream>>>(q, v, lse, delta, g, dq, N, C,   \
                                                           K, P, scale);                    \
    break;
    FWA_BWD_BF16(16)
    FWA_BWD_BF16(32)
    FWA_BWD_BF16(48)
#undef FWA_BWD_BF16
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null (inference). Returns a
// cudaError_t (0 on success).
extern "C" int fwa_fwd(const void* qkv, const void* valid, void* out, void* lse, int dtype,
                       int B, int N, int C, int H, int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || C % H != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0) return launch_f32(qkv, valid, out, l, B, N, C, H, K, scale, s);
  if (dtype == 1) return launch_bf16(qkv, valid, out, l, B, N, C, H, K, scale, s);
  return cudaErrorInvalidValue;
}

// The backward: dqkv [B, N, 3, C] from qkv, valid, the forward's out and lse,
// and dout [B, N, C]; delta [B, N, H] fp32 is scratch. K2a then K2b on one
// stream.
extern "C" int fwa_bwd(const void* qkv, const void* valid, const void* out, const void* lse,
                       const void* dout, void* dqkv, void* delta, int dtype, int B, int N,
                       int C, int H, int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || C % H != 0) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0)
    return launch_bwd_f32(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
  if (dtype == 1)
    return launch_bwd_bf16(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
  return cudaErrorInvalidValue;
}
