// K2 in bf16 and fp16: the flash-window attention backward for NVIDIA
// Hopper (sm_90a), in two variants chosen by the window; this source holds
// the one-pass variant.
//
// Replaces the TPU kernel scenesplat_tpu/ops/pallas_attn.py:_bwd_kernel
// (entered through _fwa_bwd). From qkv [B, N, 3, C] bf16, key validity
// [B, N] (one byte per slot), the forward's lse [B, N, H] fp32 (natural-log
// log-sum-exp of each row's scaled scores) and dO [B, N, C] bf16 it writes
// dqkv [B, N, 3, C] bf16. Per window of K consecutive slots (the last one
// ragged) and head of width D, rounding where the TPU kernel rounds:
//
//   S  = round(q * scale) . k^T         (fp32 accumulation)
//   P  = exp(S - lse) on valid keys     (fp32)
//   dV = round(P)^T . dO                (fp32 accumulation)
//   dP = dO . V^T
//   dS = round(P * (dP - delta))
//   dQ = scale * dS . K,  dK = scale * dS^T . Q
//
// No atomics: the result is deterministic. A window whose slot 0 is padding
// (padding sorts last) writes zero gradients; rows past a ragged window's
// end are neither read nor written.
//
// bf16_small, windows of at most SMALL_MAX = 64 slots (the flagship
// decoder's 48). A call does 10*N*K*C operations on 7*N*C elements, a few
// dozen operations a byte: it is bound by bytes. One kernel, one pass: a
// block of K/16 warps owns one (window, head) at a time and walks a strided
// list of them, so the blocks at work cover neighbouring heads of the same
// rows. The next unit's q, k, v, dO and lse arrive by 16-byte cp.async in a
// second stage while this unit computes. Each warp owns 16 query rows: S and
// dP on mma.sync m16n8k16 over exactly K/16 m-tiles, delta = rowsum(P * dP)
// in fp32 as the TPU kernel takes it (so O is not read), dS, and dQ from dS
// kept in registers. round(P) and round(dS) go to shared memory, where each
// warp then reads them transposed (ldmatrix.trans) for the 16 key rows it
// owns: dV and dK. dQ, dK and dV are staged in shared memory and leave as
// 16-byte row stores.
//
// bf16_large, windows above SMALL_MAX (the encoder's 1024), is
// flash_window_attn_bwd_large.cu, a source and a library of its own so that
// the two build side by side.
//
// Types and widths. bf16 and fp16 run the same code (Elem: how two values
// pack into a register, and mma.sync's .bf16 or .f16 form). Head widths 16,
// 32, 48, 64, 96 and 128 are instantiated; ops/flash_window_attn.py pads any
// other width up to 128 with zero lanes to the next of them. At D = 96 and
// 128 and a window of 64 a block's shared memory (two stages, P and dS) is
// 130–170 KB, so one block holds an SM (small_min_blocks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwa_common.cuh"

namespace {

constexpr int SMALL_MAX = 64;  // the small variant's largest window: 4 m16 tiles

// ---- bf16_small: one pass per (window, head) ------------------------------

// Shared memory of the small kernel: two stages of q, k, v, dO rows
// [R][DS] and lse [R]; then round(P) and round(dS) [R][PS], which later
// hold dK and dV on their way out. Rows padded by 16 bytes so the eight
// rows of an ldmatrix matrix fall on distinct banks.
template <int D, int MT>
struct SmallLayout {
  static constexpr int R = 16 * MT;                   // rows of a window, padded to m-tiles
  static constexpr int DS = D + 8;                    // row stride of q, k, v, dO
  static constexpr int PS = (R > D ? R : D) + 8;      // row stride of P, dS (then dK, dV)
  static constexpr int TILE = R * DS;                 // elements of one [R][DS] tile
  static constexpr int STAGE = 4 * TILE * 2 + R * 4;  // bytes: q, k, v, dO, lse
  static constexpr int BYTES = 2 * STAGE + 2 * R * PS * 2;
};

// The blocks an SM should hold, for __launch_bounds__: 12 / MT, and no more
// than the shared memory holds (one at D = 96 and 128 and a window of 64),
// so that wide heads get the registers a block can use
template <int D, int MT>
constexpr int small_min_blocks() {
  constexpr int fit = (227 * 1024) / SmallLayout<D, MT>::BYTES;
  return 12 / MT < fit ? 12 / MT : (fit > 0 ? fit : 1);
}

template <typename T, int D, int MT>
__global__ void __launch_bounds__(32 * MT, (small_min_blocks<D, MT>()))
fwa_bwd_small_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     T* __restrict__ dqkv, int N, int C, int H, int K, int P, int units,
                     float scale) {
  static_assert(D % 16 == 0 && MT >= 1 && MT <= SMALL_MAX / 16, "shape");
  using L = SmallLayout<D, MT>;
  using E = Elem<T>;
  constexpr int NT = 32 * MT;     // threads
  constexpr int KS = D / 16;      // k-steps over the head dim
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int DS = L::DS, PS = L::PS, TILE = L::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ps = reinterpret_cast<T*>(smem + 2 * L::STAGE);  // round(P), then dK
  T* dss = ps + L::R * PS;                               // round(dS), then dV

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const size_t stride = 3 * (size_t)C;
  // ldmatrix row address of this lane within a 16 x 16 block: (lr, lc) for
  // an A fragment of row-major rows and for a B fragment (two n-tiles) read
  // transposed from [k][n] rows; (xr, xc) for a B fragment (two n-tiles) of
  // [n][k] rows and for an A fragment read transposed from [k][m] rows
  const int lr = lane % 16, lc = (lane / 16) * 8;
  const int xr = (lane / 16) * 8 + lane % 8, xc = ((lane / 8) % 2) * 8;

  struct Unit {
    size_t tok0;  // first slot of the window
    int h, wlen;
  };
  auto unit_of = [&](int u) {
    const int win = u / H, h = u - (u / H) * H;
    const int b = win / P, w0 = (win - b * P) * K;
    return Unit{(size_t)b * N + w0, h, min(K, N - w0)};
  };
  auto load = [&](const Unit& t, int s) {
    T* qs = reinterpret_cast<T*>(smem + s * L::STAGE);
    for (int i = tid; i < L::R * CH; i += NT) {
      const int j = i / CH, part = i - j * CH;
      const bool ok = j < t.wlen;
      const size_t row = t.tok0 + (ok ? j : 0);
      const T* src = qkv + row * stride + t.h * D + part * 8;
      T* dst = qs + j * DS + part * 8;
      cp_async16(dst, src, ok);
      cp_async16(dst + TILE, src + C, ok);
      cp_async16(dst + 2 * TILE, src + 2 * C, ok);
      cp_async16(dst + 3 * TILE, dout + row * C + t.h * D + part * 8, ok);
    }
    float* ls = reinterpret_cast<float*>(qs + 4 * TILE);
    for (int j = tid; j < L::R; j += NT) {
      const bool ok = j < t.wlen;
      cp_async4(ls + j, lse + (t.tok0 + (ok ? j : 0)) * H + t.h, ok);
    }
  };
  auto key_bytes = [&](const Unit& t, uint8_t& lo, uint8_t& hi) {
    lo = lane < t.wlen ? valid[t.tok0 + lane] : 0;
    hi = lane + 32 < t.wlen ? valid[t.tok0 + lane + 32] : 0;
  };

  int u = blockIdx.x;
  if (u >= units) return;
  Unit cur = unit_of(u);
  bool live = valid[cur.tok0] != 0;
  uint8_t vlo = 0, vhi = 0;  // validity of this lane's keys lane and lane + 32
  if (live) {
    load(cur, 0);
    key_bytes(cur, vlo, vhi);
  }
  cp_async_commit();
  int un = u + gridDim.x;
  Unit nxt{0, 0, 0};
  bool nlive = false;  // read one unit ahead of its prefetch
  if (un < units) {
    nxt = unit_of(un);
    nlive = valid[nxt.tok0] != 0;
  }

  for (int it = 0;; ++it) {
    const int s = it & 1;
    __syncthreads();  // every warp is done with the other stage and the P region
    uint8_t nlo = 0, nhi = 0;
    if (nlive) {
      load(nxt, s ^ 1);
      key_bytes(nxt, nlo, nhi);
    }
    cp_async_commit();
    const int un2 = un + gridDim.x;
    Unit nxt2{0, 0, 0};
    bool nlive2 = false;
    if (un2 < units) {
      nxt2 = unit_of(un2);
      nlive2 = valid[nxt2.tok0] != 0;
    }

    const int wlen = cur.wlen;
    T* out0 = dqkv + cur.tok0 * stride + cur.h * D;
    if (!live) {  // a window of padding: zero gradients
      for (int i = tid; i < wlen * CH; i += NT) {
        const int j = i / CH, part = i - j * CH;
        T* dst = out0 + j * stride + part * 8;
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dst) = z;
        *reinterpret_cast<uint4*>(dst + C) = z;
        *reinterpret_cast<uint4*>(dst + 2 * C) = z;
      }
    } else {
      cp_async_wait<1>();  // this thread's copies of this unit have landed
      __syncthreads();     // everyone's have
      T* qs = reinterpret_cast<T*>(smem + s * L::STAGE);
      const T* ks = qs + TILE;
      const T* vs = qs + 2 * TILE;
      const T* gs = qs + 3 * TILE;
      const float* ls = reinterpret_cast<const float*>(qs + 4 * TILE);
      const unsigned long long bits =
          ((unsigned long long)__ballot_sync(0xffffffffu, vhi != 0) << 32) |
          __ballot_sync(0xffffffffu, vlo != 0);

      // this warp's 16 query rows: S = round(q * scale) . k^T and dP = dO . v^T
      const int r0 = warp * 16;
      float sacc[2 * MT][4], dp[2 * MT][4];
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        uint32_t qa[4], ga[4];
        ldmatrix_x4(qa, &qs[(r0 + lr) * DS + t * 16 + lc]);
        ldmatrix_x4(ga, &gs[(r0 + lr) * DS + t * 16 + lc]);
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = scale2<T>(qa[r], scale);
#pragma unroll
        for (int np = 0; np < MT; ++np) {
          uint32_t kb[4], vb[4];  // (b0, b1) of key tiles 2 np and 2 np + 1
          ldmatrix_x4(kb, &ks[(np * 16 + xr) * DS + t * 16 + xc]);
          ldmatrix_x4(vb, &vs[(np * 16 + xr) * DS + t * 16 + xc]);
          E::mma(sacc[2 * np], qa, kb[0], kb[1]);
          E::mma(sacc[2 * np + 1], qa, kb[2], kb[3]);
          E::mma(dp[2 * np], ga, vb[0], vb[1]);
          E::mma(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
      // P = 2^(S log2(e) - lse log2(e)) on valid keys of rows in the window;
      // delta = rowsum(P * dP); dS = P * (dP - delta)
      const int row0 = r0 + g, row1 = row0 + 8;
      const bool rok[2] = {row0 < wlen, row1 < wlen};
      const float l2[2] = {ls[row0] * LOG2E, ls[row1] * LOG2E};
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = n * 8 + c2 + (e & 1);
          const bool ok = rok[e >> 1] && ((bits >> key) & 1ull);
          const float p = ok ? ex2(fmaf(sacc[n][e], LOG2E, -l2[e >> 1])) : 0.f;
          sacc[n][e] = p;
          delta[e >> 1] = fmaf(p, dp[n][e], delta[e >> 1]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 1);
        delta[r] += __shfl_xor_sync(0xffffffffu, delta[r], 2);
      }
      uint32_t sa[MT][4];  // A fragments of round(dS), for dQ
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
        const uint32_t p01 = E::pack(sacc[n][0], sacc[n][1]);
        const uint32_t p23 = E::pack(sacc[n][2], sacc[n][3]);
        const uint32_t d01 = E::pack(sacc[n][0] * (dp[n][0] - delta[0]),
                                       sacc[n][1] * (dp[n][1] - delta[0]));
        const uint32_t d23 = E::pack(sacc[n][2] * (dp[n][2] - delta[1]),
                                       sacc[n][3] * (dp[n][3] - delta[1]));
        *reinterpret_cast<uint32_t*>(&ps[row0 * PS + n * 8 + c2]) = p01;
        *reinterpret_cast<uint32_t*>(&ps[row1 * PS + n * 8 + c2]) = p23;
        *reinterpret_cast<uint32_t*>(&dss[row0 * PS + n * 8 + c2]) = d01;
        *reinterpret_cast<uint32_t*>(&dss[row1 * PS + n * 8 + c2]) = d23;
        sa[n / 2][(n % 2) * 2] = d01;
        sa[n / 2][(n % 2) * 2 + 1] = d23;
      }
      __syncthreads();  // round(P) and round(dS) of every query row are in place

      // this warp's 16 key rows: dV = round(P)^T . dO, dK = round(dS)^T . q
      float dk[2 * KS][4], dv[2 * KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
#pragma unroll
      for (int qt = 0; qt < MT; ++qt) {
        uint32_t pa[4], da[4];
        ldmatrix_x4_trans(pa, &ps[(qt * 16 + xr) * PS + r0 + xc]);
        ldmatrix_x4_trans(da, &dss[(qt * 16 + xr) * PS + r0 + xc]);
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t gb[4], qb[4];  // (b0, b1) of d tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(gb, &gs[(qt * 16 + lr) * DS + np * 16 + lc]);
          ldmatrix_x4_trans(qb, &qs[(qt * 16 + lr) * DS + np * 16 + lc]);
          E::mma(dv[2 * np], pa, gb[0], gb[1]);
          E::mma(dv[2 * np + 1], pa, gb[2], gb[3]);
          E::mma(dk[2 * np], da, qb[0], qb[1]);
          E::mma(dk[2 * np + 1], da, qb[2], qb[3]);
        }
      }
      __syncthreads();  // every warp is done reading P, dS, q and dO
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        const int d = n * 8 + c2;
        *reinterpret_cast<uint32_t*>(&ps[row0 * PS + d]) =
            E::pack(scale * dk[n][0], scale * dk[n][1]);
        *reinterpret_cast<uint32_t*>(&ps[row1 * PS + d]) =
            E::pack(scale * dk[n][2], scale * dk[n][3]);
        *reinterpret_cast<uint32_t*>(&dss[row0 * PS + d]) = E::pack(dv[n][0], dv[n][1]);
        *reinterpret_cast<uint32_t*>(&dss[row1 * PS + d]) = E::pack(dv[n][2], dv[n][3]);
      }

      // this warp's query rows: dQ = scale * round(dS) . k, staged where q was
      float dq[2 * KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t kb[4];
          ldmatrix_x4_trans(kb, &ks[(kt * 16 + lr) * DS + np * 16 + lc]);
          E::mma(dq[2 * np], sa[kt], kb[0], kb[1]);
          E::mma(dq[2 * np + 1], sa[kt], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        const int d = n * 8 + c2;
        *reinterpret_cast<uint32_t*>(&qs[row0 * DS + d]) =
            E::pack(scale * dq[n][0], scale * dq[n][1]);
        *reinterpret_cast<uint32_t*>(&qs[row1 * DS + d]) =
            E::pack(scale * dq[n][2], scale * dq[n][3]);
      }
      __syncthreads();  // dQ, dK and dV are staged
      for (int i = tid; i < wlen * CH; i += NT) {
        const int j = i / CH, part = i - j * CH;
        T* dst = out0 + j * stride + part * 8;
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(&qs[j * DS + part * 8]);
        *reinterpret_cast<uint4*>(dst + C) =
            *reinterpret_cast<const uint4*>(&ps[j * PS + part * 8]);
        *reinterpret_cast<uint4*>(dst + 2 * C) =
            *reinterpret_cast<const uint4*>(&dss[j * PS + part * 8]);
      }
    }

    if (un >= units) break;
    cur = nxt;
    live = nlive;
    vlo = nlo;
    vhi = nhi;
    un = un2;
    nxt = nxt2;
    nlive = nlive2;
  }
  cp_async_wait<0>();
}

// blocks of the small kernel resident on one SM, and the SMs: found once per
// instance (the grid is one wave of persistent blocks)
template <typename T, int D, int MT>
cudaError_t small_residency(int& blocks_per_sm, int& sms) {
  static int bps = 0, n_sm = 0;
  if (!bps) {
    constexpr int BYTES = SmallLayout<D, MT>::BYTES;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (!e)
      e = cudaFuncSetAttribute(fwa_bwd_small_kernel<T, D, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (!e)
      e = cudaFuncSetAttribute(fwa_bwd_small_kernel<T, D, MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (!e)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fwa_bwd_small_kernel<T, D, MT>,
                                                        32 * MT, BYTES);
    if (e) return e;
    if (!bps) return cudaErrorInvalidConfiguration;
  }
  blocks_per_sm = bps;
  sms = n_sm;
  return cudaSuccess;
}

template <typename T, int D, int MT>
cudaError_t launch_small(const void* qkv, const void* valid, const float* lse, const void* dout,
                         void* dqkv, int B, int N, int C, int H, int K, float scale,
                         cudaStream_t stream) {
  int blocks_per_sm = 0, sms = 0;
  if (cudaError_t e = small_residency<T, D, MT>(blocks_per_sm, sms)) return e;
  const int P = (N + K - 1) / K;
  const long long units = (long long)B * P * H;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long resident = (long long)blocks_per_sm * sms;
  const int grid = (int)(units < resident ? units : resident);
  fwa_bwd_small_kernel<T, D, MT><<<grid, 32 * MT, SmallLayout<D, MT>::BYTES, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(valid), lse,
      static_cast<const T*>(dout), static_cast<T*>(dqkv), N, C, H, K, P, (int)units, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_small_t(const void* qkv, const void* valid, const float* lse,
                           const void* dout, void* dqkv, int B, int N, int C, int H, int K,
                           float scale, cudaStream_t s) {
  switch ((K + 15) / 16) {
    case 1: return launch_small<T, D, 1>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 2: return launch_small<T, D, 2>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 3: return launch_small<T, D, 3>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 4: return launch_small<T, D, 4>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// head width D in the storage type `dtype` (1 bf16, 2 fp16)
template <int D>
cudaError_t launch_small_d(int dtype, const void* qkv, const void* valid, const float* lse,
                           const void* dout, void* dqkv, int B, int N, int C, int H, int K,
                           float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_small_t<bf16, D>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
  if (dtype == 2)
    return launch_small_t<fp16, D>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t small_residency_d(int K, int& blocks_per_sm, int& sms) {
  switch ((K + 15) / 16) {
    case 1: return small_residency<bf16, D, 1>(blocks_per_sm, sms);
    case 2: return small_residency<bf16, D, 2>(blocks_per_sm, sms);
    case 3: return small_residency<bf16, D, 3>(blocks_per_sm, sms);
    case 4: return small_residency<bf16, D, 4>(blocks_per_sm, sms);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16_small: windows of 1 to 64 slots in bf16 (dtype 1) or fp16 (dtype
// 2), head widths 16, 32, 48, 64, 96 and 128 (the wrapper pads any other
// width up to 128 to the next of them). dqkv [B, N, 3, C] from qkv, valid,
// lse and dout. Returns a cudaError_t (0 on success), cudaErrorInvalidValue
// for a shape it was not built for.
extern "C" int fwa_bwd_small(const void* qkv, const void* valid, const void* lse,
                             const void* dout, void* dqkv, int dtype, int B, int N, int C, int H,
                             int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || K > SMALL_MAX || C % H != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  switch (C / H) {
    case 16:
      return launch_small_d<16>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 32:
      return launch_small_d<32>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 48:
      return launch_small_d<48>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 64:
      return launch_small_d<64>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 96:
      return launch_small_d<96>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 128:
      return launch_small_d<128>(dtype, qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The small kernel's resident blocks per SM at head width D and window K in
// bf16 (fp16's are the same; the report of tools/torch_kernel_bench.py), or
// -1 for a shape it lacks.
extern "C" int fwa_bwd_small_residency(int D, int K) {
  int bps = 0, sms = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (K > 0 && K <= SMALL_MAX) {
    if (D == 16) e = small_residency_d<16>(K, bps, sms);
    if (D == 32) e = small_residency_d<32>(K, bps, sms);
    if (D == 48) e = small_residency_d<48>(K, bps, sms);
    if (D == 64) e = small_residency_d<64>(K, bps, sms);
    if (D == 96) e = small_residency_d<96>(K, bps, sms);
    if (D == 128) e = small_residency_d<128>(K, bps, sms);
  }
  return e ? -1 : bps;
}

