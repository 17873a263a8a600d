// K2 in bf16: the flash-window attention backward for NVIDIA Hopper (sm_90a),
// in two variants chosen by the window.
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
// bf16_large, windows above SMALL_MAX (the encoder's 1024): bound by
// operations, and at D = 16 by the work around the products (an exponential
// and a handful of fp32 operations a score, twice). Two kernels on the
// caller's stream, with K1's large-window machinery (flash_window_attn_fwd.cu):
// K2a, a block of 128 query rows, writes delta = rowsum(dO * O) (16-byte
// loads; P * dP would need every key first) and dQ, walking only the key
// tiles that hold a valid key; K2b, a block of 128 key rows, walks every
// query tile of the window with dK and dV in fp32 registers, and a block
// without a valid key writes zeros and leaves. Both: tiles of 64 rows by
// 16-byte cp.async in a ring of three stages, one block barrier a tile;
// every shared-memory operand by ldmatrix (transposed ones by
// ldmatrix.trans); four warps of two m16 tiles, so each fragment read feeds
// two products; scores 32 columns at a time to bound registers; P in the
// exp2 domain with log2(e) folded into one FFMA; results staged in shared
// memory for 16-byte row stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int SMALL_MAX = 64;  // the small variant's largest window: 4 m16 tiles
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the two bf16 of x times s, rounded to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t x, float s) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x);
  return pack_bf16(__low2float(v) * s, __high2float(v) * s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// 16 bytes from device to shared memory, or 16 zero bytes when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes when !ok
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ float ex2(float x) {  // 2^x
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

template <int D, int MT>
__global__ void __launch_bounds__(32 * MT, 12 / MT)
fwa_bwd_small_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ valid,
                     const float* __restrict__ lse, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, int N, int C, int H, int K, int P, int units,
                     float scale) {
  static_assert(D % 16 == 0 && MT >= 1 && MT <= SMALL_MAX / 16, "shape");
  using L = SmallLayout<D, MT>;
  constexpr int NT = 32 * MT;     // threads
  constexpr int KS = D / 16;      // k-steps over the head dim
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int DS = L::DS, PS = L::PS, TILE = L::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ps = reinterpret_cast<bf16*>(smem + 2 * L::STAGE);  // round(P), then dK
  bf16* dss = ps + L::R * PS;                               // round(dS), then dV

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
    bf16* qs = reinterpret_cast<bf16*>(smem + s * L::STAGE);
    for (int i = tid; i < L::R * CH; i += NT) {
      const int j = i / CH, part = i - j * CH;
      const bool ok = j < t.wlen;
      const size_t row = t.tok0 + (ok ? j : 0);
      const bf16* src = qkv + row * stride + t.h * D + part * 8;
      bf16* dst = qs + j * DS + part * 8;
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
    bf16* out0 = dqkv + cur.tok0 * stride + cur.h * D;
    if (!live) {  // a window of padding: zero gradients
      for (int i = tid; i < wlen * CH; i += NT) {
        const int j = i / CH, part = i - j * CH;
        bf16* dst = out0 + j * stride + part * 8;
        const uint4 z = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dst) = z;
        *reinterpret_cast<uint4*>(dst + C) = z;
        *reinterpret_cast<uint4*>(dst + 2 * C) = z;
      }
    } else {
      cp_async_wait<1>();  // this thread's copies of this unit have landed
      __syncthreads();     // everyone's have
      bf16* qs = reinterpret_cast<bf16*>(smem + s * L::STAGE);
      const bf16* ks = qs + TILE;
      const bf16* vs = qs + 2 * TILE;
      const bf16* gs = qs + 3 * TILE;
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
        for (int r = 0; r < 4; ++r) qa[r] = scale_bf16x2(qa[r], scale);
#pragma unroll
        for (int np = 0; np < MT; ++np) {
          uint32_t kb[4], vb[4];  // (b0, b1) of key tiles 2 np and 2 np + 1
          ldmatrix_x4(kb, &ks[(np * 16 + xr) * DS + t * 16 + xc]);
          ldmatrix_x4(vb, &vs[(np * 16 + xr) * DS + t * 16 + xc]);
          mma_bf16(sacc[2 * np], qa, kb[0], kb[1]);
          mma_bf16(sacc[2 * np + 1], qa, kb[2], kb[3]);
          mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
          mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
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
        const uint32_t p01 = pack_bf16(sacc[n][0], sacc[n][1]);
        const uint32_t p23 = pack_bf16(sacc[n][2], sacc[n][3]);
        const uint32_t d01 = pack_bf16(sacc[n][0] * (dp[n][0] - delta[0]),
                                       sacc[n][1] * (dp[n][1] - delta[0]));
        const uint32_t d23 = pack_bf16(sacc[n][2] * (dp[n][2] - delta[1]),
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
          mma_bf16(dv[2 * np], pa, gb[0], gb[1]);
          mma_bf16(dv[2 * np + 1], pa, gb[2], gb[3]);
          mma_bf16(dk[2 * np], da, qb[0], qb[1]);
          mma_bf16(dk[2 * np + 1], da, qb[2], qb[3]);
        }
      }
      __syncthreads();  // every warp is done reading P, dS, q and dO
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        const int d = n * 8 + c2;
        *reinterpret_cast<uint32_t*>(&ps[row0 * PS + d]) =
            pack_bf16(scale * dk[n][0], scale * dk[n][1]);
        *reinterpret_cast<uint32_t*>(&ps[row1 * PS + d]) =
            pack_bf16(scale * dk[n][2], scale * dk[n][3]);
        *reinterpret_cast<uint32_t*>(&dss[row0 * PS + d]) = pack_bf16(dv[n][0], dv[n][1]);
        *reinterpret_cast<uint32_t*>(&dss[row1 * PS + d]) = pack_bf16(dv[n][2], dv[n][3]);
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
          mma_bf16(dq[2 * np], sa[kt], kb[0], kb[1]);
          mma_bf16(dq[2 * np + 1], sa[kt], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        const int d = n * 8 + c2;
        *reinterpret_cast<uint32_t*>(&qs[row0 * DS + d]) =
            pack_bf16(scale * dq[n][0], scale * dq[n][1]);
        *reinterpret_cast<uint32_t*>(&qs[row1 * DS + d]) =
            pack_bf16(scale * dq[n][2], scale * dq[n][3]);
      }
      __syncthreads();  // dQ, dK and dV are staged
      for (int i = tid; i < wlen * CH; i += NT) {
        const int j = i / CH, part = i - j * CH;
        bf16* dst = out0 + j * stride + part * 8;
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
template <int D, int MT>
cudaError_t small_residency(int& blocks_per_sm, int& sms) {
  static int bps = 0, n_sm = 0;
  if (!bps) {
    constexpr int BYTES = SmallLayout<D, MT>::BYTES;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (!e)
      e = cudaFuncSetAttribute(fwa_bwd_small_kernel<D, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (!e)
      e = cudaFuncSetAttribute(fwa_bwd_small_kernel<D, MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (!e)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fwa_bwd_small_kernel<D, MT>,
                                                        32 * MT, BYTES);
    if (e) return e;
    if (!bps) return cudaErrorInvalidConfiguration;
  }
  blocks_per_sm = bps;
  sms = n_sm;
  return cudaSuccess;
}

template <int D, int MT>
cudaError_t launch_small(const void* qkv, const void* valid, const float* lse, const void* dout,
                         void* dqkv, int B, int N, int C, int H, int K, float scale,
                         cudaStream_t stream) {
  int blocks_per_sm = 0, sms = 0;
  if (cudaError_t e = small_residency<D, MT>(blocks_per_sm, sms)) return e;
  const int P = (N + K - 1) / K;
  const long long units = (long long)B * P * H;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long resident = (long long)blocks_per_sm * sms;
  const int grid = (int)(units < resident ? units : resident);
  fwa_bwd_small_kernel<D, MT><<<grid, 32 * MT, SmallLayout<D, MT>::BYTES, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const uint8_t*>(valid), lse,
      static_cast<const bf16*>(dout), static_cast<bf16*>(dqkv), N, C, H, K, P, (int)units,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_small_d(const void* qkv, const void* valid, const float* lse,
                           const void* dout, void* dqkv, int B, int N, int C, int H, int K,
                           float scale, cudaStream_t s) {
  switch ((K + 15) / 16) {
    case 1: return launch_small<D, 1>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 2: return launch_small<D, 2>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 3: return launch_small<D, 3>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    case 4: return launch_small<D, 4>(qkv, valid, lse, dout, dqkv, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
cudaError_t small_residency_d(int K, int& blocks_per_sm, int& sms) {
  switch ((K + 15) / 16) {
    case 1: return small_residency<D, 1>(blocks_per_sm, sms);
    case 2: return small_residency<D, 2>(blocks_per_sm, sms);
    case 3: return small_residency<D, 3>(blocks_per_sm, sms);
    case 4: return small_residency<D, 4>(blocks_per_sm, sms);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16_large: K2a (dQ, delta) and K2b (dK, dV) -------------------------

constexpr int LQ = 128;         // rows a block owns: queries in K2a, keys in K2b
constexpr int LT = 64;          // rows of a streamed tile: keys in K2a, queries in K2b
constexpr int LSTAGES = 3;      // streamed tiles in flight
constexpr int LMT = LQ / 64;    // m16 tiles a warp (four warps)
constexpr int MAX_TILES = 64;   // key tiles a pass of K2a's validity list holds

// dQ and delta: a block owns 128 query rows of one (batch, window, head) and
// walks the window's key tiles that hold a valid key
template <int D>
__global__ void __launch_bounds__(128, D == 16 ? 3 : 2)
fwa_bwd_dq_large_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ valid,
                        const bf16* __restrict__ out, const float* __restrict__ lse,
                        const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                        float* __restrict__ delta, int N, int C, int H, int K, int P, int NQ,
                        float scale) {
  constexpr int KS = D / 16, NDIM = D / 8, STR = D + 8, CH = D / 8;
  __shared__ __align__(128) bf16 kv[LSTAGES][2][LT * STR];  // k, v rows [key][d]
  __shared__ unsigned long long vbits[MAX_TILES];           // validity of a tile's keys
  __shared__ int live[MAX_TILES];                           // tiles with a valid key
  __shared__ int n_live;
  __shared__ float delta_s[LQ];

  // query tile fastest, then head, then window: the blocks of a window run together
  const int qt = blockIdx.x % NQ;
  const int h = (blockIdx.x / NQ) % H;
  const int win = blockIdx.x / (NQ * H);
  const int b = win / P, w0 = (win - b * P) * K;
  const int q0 = qt * LQ;
  const int wlen = min(K, N - w0);
  if (q0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int tid = threadIdx.x;

  if (!vwin[0]) {  // a window of padding: zero gradients
    for (int i = tid; i < LQ * CH; i += 128) {
      const int row = q0 + i / CH;
      if (row < wlen)
        *reinterpret_cast<uint4*>(dqkv + (tok0 + row) * stride + h * D + (i % CH) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int lr = lane % 16, lc = (lane / 16) * 8;  // see the small kernel
  const int xr = (lane / 16) * 8 + lane % 8, xc = ((lane / 8) % 2) * 8;

  {  // delta = rowsum(dO * O) in fp32, one row a thread, 16-byte loads
    const int row = q0 + tid;
    float dl = 0.f;
    if (row < wlen) {
      const uint4* op = reinterpret_cast<const uint4*>(out + (tok0 + row) * C + h * D);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + (tok0 + row) * C + h * D);
#pragma unroll
      for (int part = 0; part < CH; ++part) {
        const uint4 o4 = op[part], g4 = gp[part];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dl = fmaf(__low2float(o2[e]), __low2float(g2[e]), dl);
          dl = fmaf(__high2float(o2[e]), __high2float(g2[e]), dl);
        }
      }
      delta[(tok0 + row) * H + h] = dl;
    }
    delta_s[tid] = dl;
  }

  // A fragments of round(q * scale) and dO, straight from device memory
  const int wrow = q0 + warp * (16 * LMT);
  uint32_t qa[LMT][KS][4], ga[LMT][KS][4];
  float l2[LMT][2];
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wrow + mt * 16 + g + ((r & 1) ? 8 : 0);
        const int d = t * 16 + c2 + ((r & 2) ? 8 : 0);
        uint32_t qv = 0, gv = 0;
        if (row < wlen) {
          qv = *reinterpret_cast<const uint32_t*>(qkv + (tok0 + row) * stride + h * D + d);
          gv = *reinterpret_cast<const uint32_t*>(dout + (tok0 + row) * C + h * D + d);
        }
        qa[mt][t][r] = scale_bf16x2(qv, scale);
        ga[mt][t][r] = gv;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + mt * 16 + g + 8 * r;
      l2[mt][r] = row < wlen ? lse[(tok0 + row) * H + h] * LOG2E : 0.f;
    }
  }
  float dq[LMT][NDIM][4];
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
    for (int n = 0; n < NDIM; ++n) dq[mt][n][0] = dq[mt][n][1] = dq[mt][n][2] = dq[mt][n][3] = 0.f;
  __syncthreads();  // delta_s
  float dl[LMT][2];
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) dl[mt][r] = delta_s[warp * (16 * LMT) + mt * 16 + g + 8 * r];

  const int n_tiles = (wlen + LT - 1) / LT;
  for (int c0 = 0; c0 < n_tiles; c0 += MAX_TILES) {  // one pass for windows up to 4096
    const int ct = min(MAX_TILES, n_tiles - c0);
    __syncthreads();  // the last pass's users of vbits, live and the ring are done
    for (int t = warp; t < ct; t += 4) {
      const int k_lo = (c0 + t) * LT + lane, k_hi = k_lo + 32;
      const unsigned lo = __ballot_sync(0xffffffffu, k_lo < wlen && vwin[k_lo] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, k_hi < wlen && vwin[k_hi] != 0);
      if (lane == 0) vbits[t] = ((unsigned long long)hi << 32) | lo;
    }
    __syncthreads();
    if (tid == 0) {
      int n = 0;
      for (int t = 0; t < ct; ++t)
        if (vbits[t]) live[n++] = t;
      n_live = n;
    }
    __syncthreads();
    const int nl = n_live;

    auto load_tile = [&](int li) {
      const int t0 = (c0 + live[li]) * LT;
      bf16* ks = kv[li % LSTAGES][0];
      bf16* vs = kv[li % LSTAGES][1];
      for (int i = tid; i < LT * CH; i += 128) {
        const int j = i / CH, part = i - j * CH;
        const bool ok = t0 + j < wlen;
        const bf16* src = qkv + (tok0 + (ok ? t0 + j : 0)) * stride + C + h * D + part * 8;
        cp_async16(&ks[j * STR + part * 8], src, ok);
        cp_async16(&vs[j * STR + part * 8], src + C, ok);
      }
    };
#pragma unroll
    for (int s = 0; s < LSTAGES - 1; ++s) {
      if (s < nl) load_tile(s);
      cp_async_commit();
    }

    for (int it = 0; it < nl; ++it) {
      cp_async_wait<LSTAGES - 2>();  // this thread's copies of tile `it` have landed
      __syncthreads();               // everyone's have, and everyone is done with it - 1
      if (it + LSTAGES - 1 < nl) load_tile(it + LSTAGES - 1);
      cp_async_commit();
      const bf16* ks = kv[it % LSTAGES][0];
      const bf16* vs = kv[it % LSTAGES][1];
      const unsigned long long bits = vbits[live[it]];

#pragma unroll
      for (int kh = 0; kh < LT / 32; ++kh) {  // 32 keys at a time
        float sc[LMT][4][4], dp[LMT][4][4];
#pragma unroll
        for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
        for (int t = 0; t < KS; ++t) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t kb[4], vb[4];
            ldmatrix_x4(kb, &ks[(kh * 32 + np * 16 + xr) * STR + t * 16 + xc]);
            ldmatrix_x4(vb, &vs[(kh * 32 + np * 16 + xr) * STR + t * 16 + xc]);
#pragma unroll
            for (int mt = 0; mt < LMT; ++mt) {
              mma_bf16(sc[mt][2 * np], qa[mt][t], kb[0], kb[1]);
              mma_bf16(sc[mt][2 * np + 1], qa[mt][t], kb[2], kb[3]);
              mma_bf16(dp[mt][2 * np], ga[mt][t], vb[0], vb[1]);
              mma_bf16(dp[mt][2 * np + 1], ga[mt][t], vb[2], vb[3]);
            }
          }
        }
        const unsigned hb = static_cast<unsigned>(bits >> (32 * kh));
        if (hb != ~0u) {  // warp-uniform: some key of these 32 is invalid
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const bool ok0 = (hb >> (n * 8 + c2)) & 1, ok1 = (hb >> (n * 8 + c2 + 1)) & 1;
#pragma unroll
            for (int mt = 0; mt < LMT; ++mt) {
              if (!ok0) sc[mt][n][0] = sc[mt][n][2] = -INFINITY;
              if (!ok1) sc[mt][n][1] = sc[mt][n][3] = -INFINITY;
            }
          }
        }
        // dS = P * (dP - delta), P = 2^(S log2(e) - lse log2(e)); then dQ += round(dS) . k
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t sa[LMT][4];
#pragma unroll
          for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float x[4];
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float p = ex2(fmaf(sc[mt][2 * kk + half][e], LOG2E, -l2[mt][e >> 1]));
                x[e] = p * (dp[mt][2 * kk + half][e] - dl[mt][e >> 1]);
              }
              sa[mt][2 * half] = pack_bf16(x[0], x[1]);
              sa[mt][2 * half + 1] = pack_bf16(x[2], x[3]);
            }
          }
#pragma unroll
          for (int np = 0; np < KS; ++np) {
            uint32_t kb[4];  // (b0, b1) of d tiles 2 np and 2 np + 1
            ldmatrix_x4_trans(kb, &ks[(kh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
#pragma unroll
            for (int mt = 0; mt < LMT; ++mt) {
              mma_bf16(dq[mt][2 * np], sa[mt], kb[0], kb[1]);
              mma_bf16(dq[mt][2 * np + 1], sa[mt], kb[2], kb[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  __syncthreads();  // every warp is done with the ring: it now holds the dQ tile
  bf16* ot = kv[0][0];  // [LQ][STR]
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * (16 * LMT) + mt * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NDIM; ++n)
        *reinterpret_cast<uint32_t*>(&ot[lrow * STR + n * 8 + c2]) =
            pack_bf16(scale * dq[mt][n][2 * r], scale * dq[mt][n][2 * r + 1]);
    }
  }
  __syncthreads();
  for (int i = tid; i < LQ * CH; i += 128) {
    const int lrow = i / CH, part = i - lrow * CH;
    if (q0 + lrow < wlen)
      *reinterpret_cast<uint4*>(dqkv + (tok0 + q0 + lrow) * stride + h * D + part * 8) =
          *reinterpret_cast<const uint4*>(&ot[lrow * STR + part * 8]);
  }
}

// dK and dV: a block owns 128 key rows of one (batch, window, head) and walks
// every query tile of the window; a block without a valid key writes zeros
template <int D>
__global__ void __launch_bounds__(128, D == 16 ? 3 : 2)
fwa_bwd_dkv_large_kernel(const bf16* __restrict__ qkv, const uint8_t* __restrict__ valid,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const bf16* __restrict__ dout, bf16* __restrict__ dqkv, int N, int C,
                         int H, int K, int P, int NK, float scale) {
  constexpr int KS = D / 16, NDIM = D / 8, STR = D + 8, CH = D / 8;
  __shared__ __align__(128) bf16 qg[LSTAGES][2][LT * STR];  // q, dO rows [query][d]
  __shared__ __align__(16) float ld[LSTAGES][2][LT];        // lse, delta of those rows

  const int kt = blockIdx.x % NK;
  const int h = (blockIdx.x / NK) % H;
  const int win = blockIdx.x / (NK * H);
  const int b = win / P, w0 = (win - b * P) * K;
  const int k0 = kt * LQ;
  const int wlen = min(K, N - w0);
  if (k0 >= wlen) return;
  const size_t tok0 = (size_t)b * N + w0;
  const size_t stride = 3 * (size_t)C;
  const uint8_t* vwin = valid + tok0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const int lr = lane % 16, lc = (lane / 16) * 8;
  const int xr = (lane / 16) * 8 + lane % 8, xc = ((lane / 8) % 2) * 8;

  const int wrow = k0 + warp * (16 * LMT);
  bool kok[LMT][2];
  bool any = false;
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + mt * 16 + g + 8 * r;
      kok[mt][r] = vwin[0] && row < wlen && vwin[row] != 0;
      any |= kok[mt][r];
    }
  if (!__syncthreads_or(any)) {  // no valid key here (or a window of padding): zeros
    for (int i = tid; i < LQ * CH; i += 128) {
      const int row = k0 + i / CH;
      if (row < wlen) {
        bf16* p = dqkv + (tok0 + row) * stride + C + h * D + (i % CH) * 8;
        *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(p + C) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  const int n_tiles = (wlen + LT - 1) / LT;
  auto load_tile = [&](int it) {
    const int t0 = it * LT;
    const int s = it % LSTAGES;
    for (int i = tid; i < LT * CH; i += 128) {
      const int j = i / CH, part = i - j * CH;
      const bool ok = t0 + j < wlen;
      const size_t row = tok0 + (ok ? t0 + j : 0);
      cp_async16(&qg[s][0][j * STR + part * 8], qkv + row * stride + h * D + part * 8, ok);
      cp_async16(&qg[s][1][j * STR + part * 8], dout + row * C + h * D + part * 8, ok);
    }
    if (tid < LT) {
      const bool ok = t0 + tid < wlen;
      const size_t row = tok0 + (ok ? t0 + tid : 0);
      cp_async4(&ld[s][0][tid], lse + row * H + h, ok);
      cp_async4(&ld[s][1][tid], delta + row * H + h, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < LSTAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s);
    cp_async_commit();
  }

  // A fragments of this warp's k and v rows, straight from device memory
  uint32_t ka[LMT][KS][4], va[LMT][KS][4];
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int t = 0; t < KS; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wrow + mt * 16 + g + ((r & 1) ? 8 : 0);
        const int d = t * 16 + c2 + ((r & 2) ? 8 : 0);
        uint32_t kx = 0, vx = 0;
        if (row < wlen) {
          const bf16* p = qkv + (tok0 + row) * stride + C + h * D + d;
          kx = *reinterpret_cast<const uint32_t*>(p);
          vx = *reinterpret_cast<const uint32_t*>(p + C);
        }
        ka[mt][t][r] = kx;
        va[mt][t][r] = vx;
      }
    }
  }
  float dk[LMT][NDIM][4], dv[LMT][NDIM][4];
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
    for (int n = 0; n < NDIM; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][n][e] = dv[mt][n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<LSTAGES - 2>();
    __syncthreads();
    if (it + LSTAGES - 1 < n_tiles) load_tile(it + LSTAGES - 1);
    cp_async_commit();
    const bf16* qs = qg[it % LSTAGES][0];
    const bf16* gs = qg[it % LSTAGES][1];
    const float* ls = ld[it % LSTAGES][0];
    const float* ds = ld[it % LSTAGES][1];

#pragma unroll
    for (int qh = 0; qh < LT / 32; ++qh) {  // 32 queries at a time
      // S^T = k . round(q * scale)^T and dP^T = v . dO^T
      float sc[LMT][4][4], dp[LMT][4][4];
#pragma unroll
      for (int mt = 0; mt < LMT; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[mt][n][e] = dp[mt][n][e] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t qb[4], gb[4];
          ldmatrix_x4(qb, &qs[(qh * 32 + np * 16 + xr) * STR + t * 16 + xc]);
          ldmatrix_x4(gb, &gs[(qh * 32 + np * 16 + xr) * STR + t * 16 + xc]);
#pragma unroll
          for (int r = 0; r < 4; ++r) qb[r] = scale_bf16x2(qb[r], scale);
#pragma unroll
          for (int mt = 0; mt < LMT; ++mt) {
            mma_bf16(sc[mt][2 * np], ka[mt][t], qb[0], qb[1]);
            mma_bf16(sc[mt][2 * np + 1], ka[mt][t], qb[2], qb[3]);
            mma_bf16(dp[mt][2 * np], va[mt][t], gb[0], gb[1]);
            mma_bf16(dp[mt][2 * np + 1], va[mt][t], gb[2], gb[3]);
          }
        }
      }
      // P^T = 2^(S^T log2(e) - lse log2(e)) on valid keys, dS^T = P^T * (dP^T - delta)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int qi = qh * 32 + n * 8 + c2;
        const float2 l = *reinterpret_cast<const float2*>(&ls[qi]);
        const float2 dl = *reinterpret_cast<const float2*>(&ds[qi]);
        const float l2[2] = {l.x * LOG2E, l.y * LOG2E}, dlt[2] = {dl.x, dl.y};
#pragma unroll
        for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                kok[mt][e >> 1] ? ex2(fmaf(sc[mt][n][e], LOG2E, -l2[e & 1])) : 0.f;
            sc[mt][n][e] = p;
            dp[mt][n][e] = p * (dp[mt][n][e] - dlt[e & 1]);
          }
        }
      }
      // dV += round(P^T) . dO and dK += round(dS^T) . q, 16 queries at a time
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t pa[LMT][4], da[LMT][4];
#pragma unroll
        for (int mt = 0; mt < LMT; ++mt) {
          pa[mt][0] = pack_bf16(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
          da[mt][0] = pack_bf16(dp[mt][2 * kk][0], dp[mt][2 * kk][1]);
          da[mt][1] = pack_bf16(dp[mt][2 * kk][2], dp[mt][2 * kk][3]);
          da[mt][2] = pack_bf16(dp[mt][2 * kk + 1][0], dp[mt][2 * kk + 1][1]);
          da[mt][3] = pack_bf16(dp[mt][2 * kk + 1][2], dp[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t gb[4], qb[4];  // (b0, b1) of d tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(gb, &gs[(qh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
          ldmatrix_x4_trans(qb, &qs[(qh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
#pragma unroll
          for (int mt = 0; mt < LMT; ++mt) {
            mma_bf16(dv[mt][2 * np], pa[mt], gb[0], gb[1]);
            mma_bf16(dv[mt][2 * np + 1], pa[mt], gb[2], gb[3]);
            mma_bf16(dk[mt][2 * np], da[mt], qb[0], qb[1]);
            mma_bf16(dk[mt][2 * np + 1], da[mt], qb[2], qb[3]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now holds dK and dV
  bf16* kt_s = &qg[0][0][0];         // dK [LQ][STR]
  bf16* vt_s = kt_s + LQ * STR;      // dV [LQ][STR]
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * (16 * LMT) + mt * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        *reinterpret_cast<uint32_t*>(&kt_s[lrow * STR + n * 8 + c2]) =
            pack_bf16(scale * dk[mt][n][2 * r], scale * dk[mt][n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(&vt_s[lrow * STR + n * 8 + c2]) =
            pack_bf16(dv[mt][n][2 * r], dv[mt][n][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < LQ * CH; i += 128) {
    const int lrow = i / CH, part = i - lrow * CH;
    if (k0 + lrow < wlen) {
      bf16* p = dqkv + (tok0 + k0 + lrow) * stride + C + h * D + part * 8;
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&kt_s[lrow * STR + part * 8]);
      *reinterpret_cast<uint4*>(p + C) =
          *reinterpret_cast<const uint4*>(&vt_s[lrow * STR + part * 8]);
    }
  }
}

template <int D>
cudaError_t launch_large(const void* qkv, const void* valid, const void* out, const float* lse,
                         const void* dout, void* dqkv, float* delta, int B, int N, int C, int H,
                         int K, float scale, cudaStream_t stream) {
  const int P = (N + K - 1) / K;
  const int NT = (K + LQ - 1) / LQ;  // row tiles a window, both kernels
  const long long blocks = (long long)B * P * H * NT;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* q = static_cast<const bf16*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* g = static_cast<const bf16*>(dout);
  fwa_bwd_dq_large_kernel<D><<<(unsigned)blocks, 128, 0, stream>>>(
      q, v, static_cast<const bf16*>(out), lse, g, static_cast<bf16*>(dqkv), delta, N, C, H, K,
      P, NT, scale);
  if (cudaError_t e = cudaGetLastError()) return e;
  fwa_bwd_dkv_large_kernel<D><<<(unsigned)blocks, 128, 0, stream>>>(
      q, v, lse, delta, g, static_cast<bf16*>(dqkv), N, C, H, K, P, NT, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16_small: windows of 1 to 64 slots, head widths 16, 32 and 48. dqkv
// [B, N, 3, C] from qkv, valid, lse and dout. Returns a cudaError_t (0 on
// success), cudaErrorInvalidValue for a shape it was not built for.
extern "C" int fwa_bwd_small(const void* qkv, const void* valid, const void* lse,
                             const void* dout, void* dqkv, int B, int N, int C, int H, int K,
                             float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || K > SMALL_MAX || C % H != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  switch (C / H) {
    case 16: return launch_small_d<16>(qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 32: return launch_small_d<32>(qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    case 48: return launch_small_d<48>(qkv, valid, l, dout, dqkv, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The small kernel's resident blocks per SM at head width D and window K
// (the report of tools/torch_kernel_bench.py), or -1 for a shape it lacks.
extern "C" int fwa_bwd_small_residency(int D, int K) {
  int bps = 0, sms = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (K > 0 && K <= SMALL_MAX) {
    if (D == 16) e = small_residency_d<16>(K, bps, sms);
    if (D == 32) e = small_residency_d<32>(K, bps, sms);
    if (D == 48) e = small_residency_d<48>(K, bps, sms);
  }
  return e ? -1 : bps;
}

// bf16_large: windows above 64 slots, head widths 16, 32 and 48. dqkv from
// qkv, valid, the forward's out and lse, and dout; delta [B, N, H] fp32 is
// scratch. K2a then K2b on one stream.
extern "C" int fwa_bwd_large(const void* qkv, const void* valid, const void* out,
                             const void* lse, const void* dout, void* dqkv, void* delta, int B,
                             int N, int C, int H, int K, float scale, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= SMALL_MAX || C % H != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (C / H) {
    case 16: return launch_large<16>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 32: return launch_large<32>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    case 48: return launch_large<48>(qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
