// K1 at large windows: the flash-window attention forward in bf16 or fp16
// for windows of 128 to 4096 slots, for NVIDIA Hopper (sm_90a).
//
// Replaces, like the forward in flash_window_attn.cu, the TPU kernel
// scenesplat_tpu/ops/pallas_attn.py:_fwd_kernel (entered through _fwa_fwd),
// and computes the same function on the same layout: qkv [B, N, 3, C] (bf16
// or fp16), key validity [B, N] (one byte per slot), output [B, N, C] in
// qkv's type and, when
// training, lse [B, N, H] fp32, the natural-log log-sum-exp of each row's
// scaled scores (the backward K2 recomputes P = exp(S - lse) from it). Per
// window of K consecutive slots (the last one ragged) and head of width D:
//
//   S = round(q * scale) . k^T          (fp32 accumulation)
//   P = masked softmax(S)               (fp32; invalid keys get weight 0)
//   O = round(P) . V                    (fp32 accumulation, stored in qkv's type)
//
// A window whose slot 0 is padding writes zeros; a row without valid keys
// gives zeros.
//
// What bounds it. At K = 1024 a call does 4*N*K*C operations on about 4*N*C
// elements, hundreds of operations a byte: tensor-core operations, and at
// D = 16 the exponentials (one special-function result a score against 64
// tensor-core operations). The small-window kernel in flash_window_attn.cu
// loses most of its time around the products: synchronous single-buffered
// tile loads, V transposed through shared memory with 2-byte stores, 32-bit
// fragment loads, 64 query rows a block in an order that reads a window's
// K and V from device memory once per query tile, expf on every score, and
// key tiles of padding computed and masked. This kernel:
//
//  - a block owns 128 query rows of one (batch, window, head). Blocks are
//    numbered query tile first, then head, then window, so the blocks that
//    share a window's K and V run together and find them in L2;
//  - K and V tiles of 64 keys arrive by 16-byte cp.async copies in a ring of
//    three stages, one block barrier a tile: the loads of tiles t+1 and t+2
//    run under the products of tile t. Slots past a ragged window's end are
//    filled with zeros by the copy itself;
//  - K and V fragments come from shared memory by ldmatrix (V by
//    ldmatrix.trans from its stored [key][d] layout: no transpose pass), rows
//    padded by 16 bytes so the eight rows of a matrix fall on distinct banks;
//  - products on mma.sync m16n8k16 with fp32 accumulators; P goes from the S
//    accumulators to the A operand in registers, rounded to bf16;
//  - the online softmax runs in the exp2 domain: one FFMA (s * log2(e) -
//    max * log2(e)) and one ex2.approx a score; the running maximum stays in
//    the natural domain, so lse = max + log(sum) needs no conversion;
//  - the window's validity is read once into one 64-bit word per key tile;
//    tiles without a valid key are left out of the ring altogether, and
//    tiles whose keys are all valid skip the masking;
//  - the output tile goes through shared memory to 16-byte row stores.
//
// Four warps of 32 rows (two m16 tiles each, so every K and V fragment feeds
// two products), three blocks an SM. What holds it now is inside the SM, not
// its loads (with every tile read from one place it is no faster): the warps
// of a block meet at a barrier every tile and then run the same phases side
// by side, so the tensor cores, the special-function unit and the fp32 and
// integer pipes take turns instead of working at once. Two wgmma versions
// of this kernel (products waited for at once; products queued under the
// softmax of the tile before) gave the same results and no better times.
//
// Types and widths. bf16 and fp16 run the same code (Elem: how two values
// pack into a register, and mma.sync's .bf16 or .f16 form). Head widths 16,
// 32, 48, 64, 96 and 128 are instantiated; ops/flash_window_attn.py pads any
// other width up to 128 with zero lanes to the next of them. From 64 on a
// warp holds one m16 tile (LargeCfg), and the ring lives in dynamic shared
// memory (104 KB at 128).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwa_common.cuh"

namespace {

constexpr int MQ = 128;        // query rows per block
constexpr int MK = 64;         // keys per shared-memory tile
constexpr int STAGES = 3;      // tiles in flight
constexpr int MAX_TILES = 64;  // key tiles per window: windows up to 4096 slots

// The block's shape at head width D: MT m16 row tiles a warp (MQ / (16 MT)
// warps), and the blocks an SM should hold. Up to 48, two tiles a warp, so
// every K and V fragment feeds two products, three blocks an SM; from 64 on
// the O accumulators alone (4 D fp32 registers a thread at two tiles) would
// spill, so one tile a warp in 8 warps, two blocks an SM (one at 128).
template <int D>
struct LargeCfg {
  static constexpr int MT = D <= 48 ? 2 : 1;
  static constexpr int NTHREADS = MQ / (16 * MT) * 32;
  static constexpr int MIN_BLOCKS = D <= 48 ? 3 : (D <= 96 ? 2 : 1);
  static constexpr int STR = D + 8;  // padded row stride: conflict-free ldmatrix
  static constexpr int BYTES = STAGES * 2 * MK * STR * 2;  // the K and V ring, dynamic
};

template <typename T, int D>
__global__ void __launch_bounds__(LargeCfg<D>::NTHREADS, LargeCfg<D>::MIN_BLOCKS)
fwa_fwd_large_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                     T* __restrict__ out, float* __restrict__ lse, int N, int C,
                     int H, int K, int P, int NQ, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  using E = Elem<T>;
  constexpr int MT = LargeCfg<D>::MT;
  constexpr int NTHREADS = LargeCfg<D>::NTHREADS;
  constexpr int NWARPS = NTHREADS / 32;
  constexpr int KSTEPS = D / 16;  // k-steps of q . k over the head dim
  constexpr int NKEY = MK / 8;    // 8-key column tiles of S
  constexpr int NDIM = D / 8;     // 8-wide column tiles of O
  constexpr int STR = LargeCfg<D>::STR;
  constexpr int CHUNKS = D / 8;   // 16-byte chunks per row
  // k, v rows [key][d] of STAGES tiles: tile s's k at kv + 2 s TILE, its v
  // one TILE on; 104 KB at D = 128, past the 48 KB a static array may take
  constexpr int TILE = MK * STR;
  extern __shared__ __align__(128) unsigned char smem[];
  T* const kv = reinterpret_cast<T*>(smem);
  __shared__ unsigned long long vbits[MAX_TILES];                   // validity of a tile's keys
  __shared__ int live[MAX_TILES];                                   // tiles with a valid key
  __shared__ int n_live;

  // query tile fastest, then head, then window
  const int qt = blockIdx.x % NQ;
  const int h = (blockIdx.x / NQ) % H;
  const int win = blockIdx.x / (NQ * H);
  const int b = win / P;
  const int w0 = (win - b * P) * K;
  const int q0 = qt * MQ;
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;  // whole block
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int tid = threadIdx.x;

  if (!vwin[0]) {  // whole block: a window of padding writes zeros
    for (int i = tid; i < MQ * CHUNKS; i += NTHREADS) {
      const int row = q0 + i / CHUNKS;
      if (row < wlen)
        *reinterpret_cast<uint4*>(out + (tok0 + row) * C + h * D + (i % CHUNKS) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);

  // one 64-bit validity word per key tile, then the list of live tiles
  const int n_tiles = (wlen + MK - 1) / MK;
  for (int t = warp; t < n_tiles; t += NWARPS) {
    const int k_lo = t * MK + lane, k_hi = k_lo + 32;
    const unsigned lo = __ballot_sync(0xffffffffu, k_lo < wlen && vwin[k_lo] != 0);
    const unsigned hi = __ballot_sync(0xffffffffu, k_hi < wlen && vwin[k_hi] != 0);
    if (lane == 0) vbits[t] = ((unsigned long long)hi << 32) | lo;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int t = 0; t < n_tiles; ++t)
      if (vbits[t]) live[n++] = t;
    n_live = n;
  }
  __syncthreads();
  const int nl = n_live;

  auto load_tile = [&](int li) {
    const int t0 = live[li] * MK;
    T* ks = kv + (li % STAGES) * 2 * TILE;
    T* vs = ks + TILE;
    for (int i = tid; i < MK * CHUNKS; i += NTHREADS) {
      const int j = i / CHUNKS, part = i - j * CHUNKS;
      const bool ok = t0 + j < wlen;
      const T* src = qkv + (tok0 + (ok ? t0 + j : 0)) * stride + C + h * D + part * 8;
      cp_async16(&ks[j * STR + part * 8], src, ok);
      cp_async16(&vs[j * STR + part * 8], src + C, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nl) load_tile(s);
    cp_async_commit();
  }

  // A fragments of round(q * scale), straight from device memory
  const int wrow = q0 + warp * (16 * MT);
  uint32_t qa[MT][KSTEPS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int t = 0; t < KSTEPS; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wrow + mt * 16 + g + ((r & 1) ? 8 : 0);
        const int d = t * 16 + c2 + ((r & 2) ? 8 : 0);
        float x0 = 0.f, x1 = 0.f;
        if (row < wlen) {
          const float2 q2 = E::unpack(
              *reinterpret_cast<const uint32_t*>(qkv + (tok0 + row) * stride + h * D + d));
          x0 = q2.x * scale;
          x1 = q2.y * scale;
        }
        qa[mt][t][r] = E::pack(x0, x1);
      }
    }
  }

  float o[MT][NDIM][4];
  float m[MT][2], l[MT][2];  // running row max (natural domain) and sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NDIM; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m[mt][0] = m[mt][1] = -1e30f;  // finite: no inf - inf
    l[mt][0] = l[mt][1] = 0.f;
  }

  // ldmatrix row addresses of this lane within a tile: matrix lane / 8, row lane % 8
  const int k_key = (lane / 16) * 8 + lane % 8, k_d = ((lane / 8) % 2) * 8;  // K (not transposed)
  const int v_key = ((lane / 8) % 2) * 8 + lane % 8, v_d = (lane / 16) * 8;  // V (transposed)

  for (int it = 0; it < nl; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile `it` have landed
    __syncthreads();              // everyone's have, and everyone is done with tile it - 1
    if (it + STAGES - 1 < nl) load_tile(it + STAGES - 1);
    cp_async_commit();
    const T* ks = kv + (it % STAGES) * 2 * TILE;
    const T* vs = ks + TILE;
    const unsigned long long bits = vbits[live[it]];

    // S = q . k^T for this warp's rows and the tile's 64 keys
    float s[MT][NKEY][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NKEY; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KSTEPS; ++t) {
#pragma unroll
      for (int np = 0; np < NKEY / 2; ++np) {
        uint32_t kb[4];  // (b0, b1) of key tiles 2 np and 2 np + 1
        ldmatrix_x4(kb, &ks[(np * 16 + k_key) * STR + t * 16 + k_d]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          E::mma(s[mt][2 * np], qa[mt][t], kb[0], kb[1]);
          E::mma(s[mt][2 * np + 1], qa[mt][t], kb[2], kb[3]);
        }
      }
    }
    if (bits != ~0ull) {  // warp-uniform: some key of the tile is invalid
#pragma unroll
      for (int n = 0; n < NKEY; ++n) {
        const bool ok0 = (bits >> (n * 8 + c2)) & 1, ok1 = (bits >> (n * 8 + c2 + 1)) & 1;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!ok0) s[mt][n][0] = s[mt][n][2] = -INFINITY;
          if (!ok1) s[mt][n][1] = s[mt][n][3] = -INFINITY;
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NKEY; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
      }
      float ms[2];  // the new row max times log2(e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mt][r], mx[r]);
        const float corr = ex2((m[mt][r] - m_new) * LOG2E);
        m[mt][r] = m_new;
        ms[r] = m_new * LOG2E;
        l[mt][r] *= corr;
#pragma unroll
        for (int n = 0; n < NDIM; ++n) {
          o[mt][n][2 * r] *= corr;
          o[mt][n][2 * r + 1] *= corr;
        }
      }
      // P = 2^(s log2(e) - max log2(e)); an invalid key's -inf gives 0
#pragma unroll
      for (int n = 0; n < NKEY; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[mt][n][e], LOG2E, -ms[e >> 1]));
          l[mt][e >> 1] += p;
          s[mt][n][e] = p;
        }
      }
    }

    // O += round(P) . V, 16 keys at a time; P's A fragment is two S tiles
#pragma unroll
    for (int kt = 0; kt < MK / 16; ++kt) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        pa[mt][0] = E::pack(s[mt][2 * kt][0], s[mt][2 * kt][1]);
        pa[mt][1] = E::pack(s[mt][2 * kt][2], s[mt][2 * kt][3]);
        pa[mt][2] = E::pack(s[mt][2 * kt + 1][0], s[mt][2 * kt + 1][1]);
        pa[mt][3] = E::pack(s[mt][2 * kt + 1][2], s[mt][2 * kt + 1][3]);
      }
#pragma unroll
      for (int np = 0; np < NDIM / 2; ++np) {
        uint32_t vb[4];  // (b0, b1) of output column tiles 2 np and 2 np + 1
        ldmatrix_x4_trans(vb, &vs[(kt * 16 + v_key) * STR + np * 16 + v_d]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          E::mma(o[mt][2 * np], pa[mt], vb[0], vb[1]);
          E::mma(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now holds the output tile
  T* ot = kv;  // [MQ][STR]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[mt][r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const int lrow = warp * (16 * MT) + mt * 16 + g + 8 * r;  // row within the block
      if (lse && (lane & 3) == 0 && q0 + lrow < wlen)
        lse[(tok0 + q0 + lrow) * H + h] = m[mt][r] + logf(fmaxf(sum, 1e-30f));
      const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
      for (int n = 0; n < NDIM; ++n)
        *reinterpret_cast<uint32_t*>(&ot[lrow * STR + n * 8 + c2]) =
            E::pack(o[mt][n][2 * r] * inv, o[mt][n][2 * r + 1] * inv);
    }
  }
  __syncthreads();
  for (int i = tid; i < MQ * CHUNKS; i += NTHREADS) {
    const int lrow = i / CHUNKS, part = i - lrow * CHUNKS;
    if (q0 + lrow < wlen)
      *reinterpret_cast<uint4*>(out + (tok0 + q0 + lrow) * C + h * D + part * 8) =
          *reinterpret_cast<const uint4*>(&ot[lrow * STR + part * 8]);
  }
}

template <typename T, int D>
cudaError_t launch_t(const void* qkv, const void* valid, void* out, float* lse, int B, int N,
                     int C, int H, int K, float scale, cudaStream_t stream) {
  using L = LargeCfg<D>;
  static cudaError_t set = cudaFuncSetAttribute(
      fwa_fwd_large_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (set) return set;
  const int P = (N + K - 1) / K;
  const int NQ = (K + MQ - 1) / MQ;
  const long long blocks = (long long)B * P * H * NQ;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwa_fwd_large_kernel<T, D><<<(unsigned)blocks, L::NTHREADS, L::BYTES, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(valid), static_cast<T*>(out),
      lse, N, C, H, K, P, NQ, scale);
  return cudaGetLastError();
}

// head width D in the storage type `dtype` (1 bf16, 2 fp16)
template <int D>
cudaError_t launch(int dtype, const void* qkv, const void* valid, void* out, float* lse, int B,
                   int N, int C, int H, int K, float scale, cudaStream_t s) {
  if (dtype == 1) return launch_t<bf16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, s);
  if (dtype == 2) return launch_t<fp16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16 (dtype 1) or fp16 (dtype 2); head widths 16, 32, 48, 64, 96 and 128
// (the wrapper pads any other width up to 128 to the next of them); windows
// of at most 4096 slots. lse may be null (inference). Returns a cudaError_t
// (0 on success), cudaErrorInvalidValue for what it was not built for.
extern "C" int fwa_fwd_large(const void* qkv, const void* valid, void* out, void* lse,
                             int dtype, int B, int N, int C, int H, int K, float scale,
                             void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || C % H != 0) return cudaErrorInvalidValue;
  if (K > MAX_TILES * MK) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (C / H) {
    case 16: return launch<16>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 32: return launch<32>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 48: return launch<48>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 64: return launch<64>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 96: return launch<96>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    case 128: return launch<128>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
