// K1 at small windows: the flash-window attention forward in bf16 or fp16
// for windows of at most 64 slots (the flagship decoder's 48), for NVIDIA
// Hopper (sm_90a).
//
// Replaces, like the other forwards, the TPU kernel
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
// A window whose slot 0 is padding writes zeros (and no lse); rows past a
// ragged window's end are neither read as keys nor written; a row without a
// valid key gives zeros and a finite lse (about -1e30).
//
// What bounds it. At a window of 48 a call does 4*N*K*C operations on about
// 4*N*C elements read or written, some 24 operations a byte: it is bound by
// bytes, far below the card's 295 a byte. The tiled kernel in
// flash_window_attn.cu (now the bf16_tiled variant) lost its time around
// those bytes: 64 query rows in four warps and 64 keys a tile, so at 48 a
// fourth of the rows and keys were padding; one short block per (window,
// head, row tile) that loaded K and V synchronously and transposed V with
// 2-byte stores; q read with 2-byte loads; windows of one head walked before
// the next head, so the 96-byte pieces of one row were read far apart.
//
// This kernel is the forward half of the one-pass backward in
// flash_window_attn_bwd.cu (fwa_bwd_small_kernel), in a source and a library
// of its own so that it builds beside the others; its helpers are copies of
// that file's.
//
//  - One unit is one (batch, window, head). Persistent blocks, as many as
//    the card holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
//    each walk a list of units: runs of `chunk` consecutive units (the heads
//    of a window one after another) dealt to the blocks in turn, or with
//    chunk 0 a contiguous share a block. The caller chooses the run
//    (ops/flash_window_attn.py:FWD_SMALL_ORDER; PERF.md has the orders
//    measured).
//  - Exact tiles: ceil(K/16) warps, each one m16 tile of query rows, against
//    2 ceil(K/16) n8 key tiles. At 48: three warps and six key tiles, no
//    padded warp and no padded key column.
//  - The next unit's q, k and v arrive by 16-byte cp.async in a second stage
//    while this unit computes; slots past a ragged window's end are zeros
//    from the copy itself. Rows are padded by 16 bytes so the eight rows of
//    an ldmatrix matrix fall on distinct banks. q and K fragments come by
//    ldmatrix, V by ldmatrix.trans from its stored [key][d] rows.
//  - One-pass softmax: the whole window is one tile, so each row's maximum
//    is taken over all its keys at once and nothing is rescaled. The scale
//    is already in round(q * scale), as the TPU kernel rounds, so only
//    log2(e) is folded: P = 2^(S log2(e) - m log2(e)), one FFMA and one
//    ex2.approx a score. P is normalised in fp32 before it is rounded to
//    bf16, as the TPU kernel takes e / sum(e) before its cast; lse =
//    ln(2) (m log2(e) + log2(sum)).
//  - O is staged in the warp's own q rows (no other warp reads them) and
//    leaves as 16-byte row stores. lse is one 4-byte store a row: the rows
//    of one head lie H * 4 bytes apart, so no two rows of a unit share a
//    sector; the heads of a row, in neighbouring units, do.
//
// Types and widths. bf16 and fp16 run the same code (Elem: how two values
// pack into a register, and mma.sync's .bf16 or .f16 form); every sum and
// the softmax stay fp32. Head widths 16, 32, 48, 64, 96 and 128 are
// instantiated; ops/flash_window_attn.py pads any other width up to 128 with
// zero lanes to the next of them (exact: zeros add nothing to S, and the
// extra output lanes are dropped). At D = 128 and a window of 64 a block's
// two stages take 102 KB, so two blocks share an SM (small_min_blocks).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwa_common.cuh"

namespace {

constexpr int SMALL_MAX = 64;  // the largest window: 4 m16 tiles
constexpr int MAX_CHUNK = 1024;  // the longest run of units dealt to a block at once
constexpr float LN2 = 0.6931471805599453f;

// Shared memory: two stages of q, k, v rows [R][DS]. Rows padded by 16 bytes.
template <int D, int MT>
struct SmallLayout {
  static constexpr int R = 16 * MT;        // rows of a window, padded to m-tiles
  static constexpr int DS = D + 8;         // row stride
  static constexpr int TILE = R * DS;      // elements of one [R][DS] tile
  static constexpr int STAGE = 3 * TILE * 2;  // bytes: q, k, v
  static constexpr int BYTES = 2 * STAGE;
};

// The blocks an SM should hold, for __launch_bounds__: 3 of 4 warps, 16 / MT
// of fewer, and no more than the shared memory holds (two at D = 128 and a
// window of 64), so that wide heads get the registers a block can use
constexpr int small_min_blocks(int D, int MT) {
  const int want = MT == 4 ? 3 : 16 / MT;
  const int fit = (227 * 1024) / (2 * 3 * 16 * MT * (D + 8) * 2);
  return want < fit ? want : (fit > 0 ? fit : 1);
}

// The units a block walks: unit(i) for i < count. Runs of `chunk`
// consecutive units are dealt to the blocks in turn, block b taking runs b,
// b + grid, ...; chunk 0 gives each block a contiguous share instead, the
// shares differing by at most one unit. ops/flash_window_attn.py:
// small_unit_order mirrors this.
struct Walk {
  int first, grid, chunk, count;  // chunk 0: the contiguous units first, first + 1, ...
  __device__ __forceinline__ int unit(int i) const {
    return chunk ? (first + i / chunk * grid) * chunk + i % chunk : first + i;
  }
};

__device__ __forceinline__ Walk walk_of(int chunk, int units) {
  const int b = blockIdx.x, grid = gridDim.x;
  if (!chunk) {
    const long long lo = (long long)b * units / grid, hi = (long long)(b + 1) * units / grid;
    return Walk{(int)lo, grid, 0, (int)(hi - lo)};
  }
  const int chunks = (units + chunk - 1) / chunk;
  if (b >= chunks) return Walk{b, grid, chunk, 0};
  int count = (chunks - b + grid - 1) / grid * chunk;
  if ((chunks - 1 - b) % grid == 0) count -= chunks * chunk - units;  // the short last chunk
  return Walk{b, grid, chunk, count};
}

template <typename T, int D, int MT>
__global__ void __launch_bounds__(32 * MT, small_min_blocks(D, MT))
fwa_fwd_small_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                     T* __restrict__ out, float* __restrict__ lse, int N, int C, int H,
                     int K, int P, int units, int chunk, float scale) {
  static_assert(D % 16 == 0 && MT >= 1 && MT <= SMALL_MAX / 16, "shape");
  using L = SmallLayout<D, MT>;
  using E = Elem<T>;
  constexpr int NT = 32 * MT;  // threads
  constexpr int KS = D / 16;   // k-steps over the head dim, and pairs of 8-wide O tiles
  constexpr int CH = D / 8;    // 16-byte chunks a row
  constexpr int DS = L::DS, TILE = L::TILE;
  // every key of the R rows valid: the masking is skipped
  constexpr unsigned long long ALL = MT == 4 ? ~0ull : (1ull << (16 * MT)) - 1;
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c2 = 2 * (lane % 4);
  const size_t stride = 3 * (size_t)C;
  // ldmatrix row address of this lane within a 16 x 16 block: (lr, lc) for
  // an A fragment of row-major rows and for a B fragment (two n-tiles) read
  // transposed from [k][n] rows; (xr, xc) for a B fragment (two n-tiles) of
  // [n][k] rows
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
      const T* src = qkv + (t.tok0 + (ok ? j : 0)) * stride + t.h * D + part * 8;
      T* dst = qs + j * DS + part * 8;
      cp_async16(dst, src, ok);
      cp_async16(dst + TILE, src + C, ok);
      cp_async16(dst + 2 * TILE, src + 2 * C, ok);
    }
  };
  auto key_bytes = [&](const Unit& t, uint8_t& lo, uint8_t& hi) {
    lo = lane < t.wlen ? valid[t.tok0 + lane] : 0;
    hi = lane + 32 < t.wlen ? valid[t.tok0 + lane + 32] : 0;
  };

  const Walk walk = walk_of(chunk, units);
  if (walk.count <= 0) return;
  Unit cur = unit_of(walk.unit(0));
  bool live = valid[cur.tok0] != 0;
  uint8_t vlo = 0, vhi = 0;  // validity of this lane's keys lane and lane + 32
  if (live) {
    load(cur, 0);
    key_bytes(cur, vlo, vhi);
  }
  cp_async_commit();
  Unit nxt{0, 0, 0};
  bool nlive = false;  // read one unit ahead of its prefetch
  if (walk.count > 1) {
    nxt = unit_of(walk.unit(1));
    nlive = valid[nxt.tok0] != 0;
  }

  for (int i = 0;; ++i) {
    const int s = i & 1;
    __syncthreads();  // every warp is done with the other stage
    uint8_t nlo = 0, nhi = 0;
    if (nlive) {
      load(nxt, s ^ 1);
      key_bytes(nxt, nlo, nhi);
    }
    cp_async_commit();
    Unit nxt2{0, 0, 0};
    bool nlive2 = false;
    if (i + 2 < walk.count) {
      nxt2 = unit_of(walk.unit(i + 2));
      nlive2 = valid[nxt2.tok0] != 0;
    }

    const int wlen = cur.wlen;
    T* out0 = out + cur.tok0 * C + cur.h * D;
    if (!live) {  // a window of padding writes zeros
      for (int j = tid; j < wlen * CH; j += NT) {
        const int r = j / CH, part = j - r * CH;
        *reinterpret_cast<uint4*>(out0 + (size_t)r * C + part * 8) = make_uint4(0, 0, 0, 0);
      }
    } else {
      cp_async_wait<1>();  // this thread's copies of this unit have landed
      __syncthreads();     // everyone's have
      T* qs = reinterpret_cast<T*>(smem + s * L::STAGE);
      const T* ks = qs + TILE;
      const T* vs = qs + 2 * TILE;
      const unsigned long long bits =
          ((unsigned long long)__ballot_sync(0xffffffffu, vhi != 0) << 32) |
          __ballot_sync(0xffffffffu, vlo != 0);

      // this warp's 16 query rows against every key: S = round(q * scale) . k^T
      const int r0 = warp * 16;
      float sc[2 * MT][4];
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int t = 0; t < KS; ++t) {
        uint32_t qa[4];
        ldmatrix_x4(qa, &qs[(r0 + lr) * DS + t * 16 + lc]);
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = scale2<T>(qa[r], scale);
#pragma unroll
        for (int np = 0; np < MT; ++np) {
          uint32_t kb[4];  // (b0, b1) of key tiles 2 np and 2 np + 1
          ldmatrix_x4(kb, &ks[(np * 16 + xr) * DS + t * 16 + xc]);
          E::mma(sc[2 * np], qa, kb[0], kb[1]);
          E::mma(sc[2 * np + 1], qa, kb[2], kb[3]);
        }
      }
      if (bits != ALL) {  // warp-uniform: some key is invalid or past the end
#pragma unroll
        for (int n = 0; n < 2 * MT; ++n) {
          const bool ok0 = (bits >> (n * 8 + c2)) & 1, ok1 = (bits >> (n * 8 + c2 + 1)) & 1;
          if (!ok0) sc[n][0] = sc[n][2] = -INFINITY;
          if (!ok1) sc[n][1] = sc[n][3] = -INFINITY;
        }
      }

      // the row maximum over all keys at once (finite: no inf - inf), times log2(e)
      float m2[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
        m2[0] = fmaxf(m2[0], fmaxf(sc[n][0], sc[n][1]));
        m2[1] = fmaxf(m2[1], fmaxf(sc[n][2], sc[n][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
        m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 1));
        m2[r] = fmaxf(m2[r], __shfl_xor_sync(0xffffffffu, m2[r], 2));
        m2[r] = fmaxf(m2[r], -1e30f) * LOG2E;
      }
      // e = 2^(s log2(e) - m log2(e)); an invalid key's -inf gives 0
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2 * MT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(sc[n][e], LOG2E, -m2[e >> 1]));
          sc[n][e] = p;
          l[e >> 1] += p;
        }
      }
      const int row0 = r0 + g, row1 = row0 + 8;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const float sum = fmaxf(l[r], 1e-30f);
        const int row = r ? row1 : row0;
        if (lse && (lane & 3) == 0 && row < wlen)
          lse[(cur.tok0 + row) * H + cur.h] = LN2 * (m2[r] + log2f(sum));
        inv[r] = 1.f / sum;
      }

      // O = round(P) . V, 16 keys at a time; P's A fragment is two S tiles
      float o[2 * KS][4];
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < MT; ++kt) {
        const uint32_t pa[4] = {
            E::pack(sc[2 * kt][0] * inv[0], sc[2 * kt][1] * inv[0]),
            E::pack(sc[2 * kt][2] * inv[1], sc[2 * kt][3] * inv[1]),
            E::pack(sc[2 * kt + 1][0] * inv[0], sc[2 * kt + 1][1] * inv[0]),
            E::pack(sc[2 * kt + 1][2] * inv[1], sc[2 * kt + 1][3] * inv[1])};
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t vb[4];  // (b0, b1) of output column tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(vb, &vs[(kt * 16 + lr) * DS + np * 16 + lc]);
          E::mma(o[2 * np], pa, vb[0], vb[1]);
          E::mma(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }

      // staged in this warp's own q rows, then 16-byte row stores
#pragma unroll
      for (int n = 0; n < 2 * KS; ++n) {
        const int d = n * 8 + c2;
        *reinterpret_cast<uint32_t*>(&qs[row0 * DS + d]) = E::pack(o[n][0], o[n][1]);
        *reinterpret_cast<uint32_t*>(&qs[row1 * DS + d]) = E::pack(o[n][2], o[n][3]);
      }
      __syncwarp();
      for (int j = lane; j < 16 * CH; j += 32) {
        const int r = r0 + j / CH, part = j % CH;
        if (r < wlen)
          *reinterpret_cast<uint4*>(out0 + (size_t)r * C + part * 8) =
              *reinterpret_cast<const uint4*>(&qs[r * DS + part * 8]);
      }
    }

    if (i + 1 >= walk.count) break;
    cur = nxt;
    live = nlive;
    vlo = nlo;
    vhi = nhi;
    nxt = nxt2;
    nlive = nlive2;
  }
  cp_async_wait<0>();
}

// blocks resident on one SM, and the SMs: found once per instance (the grid
// is one wave of persistent blocks)
template <typename T, int D, int MT>
cudaError_t residency(int& blocks_per_sm, int& sms) {
  static int bps = 0, n_sm = 0;
  if (!bps) {
    constexpr int BYTES = SmallLayout<D, MT>::BYTES;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (!e) e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (!e)
      e = cudaFuncSetAttribute(fwa_fwd_small_kernel<T, D, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
    if (!e)
      e = cudaFuncSetAttribute(fwa_fwd_small_kernel<T, D, MT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (!e)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, fwa_fwd_small_kernel<T, D, MT>,
                                                        32 * MT, BYTES);
    if (e) return e;
    if (!bps) return cudaErrorInvalidConfiguration;
  }
  blocks_per_sm = bps;
  sms = n_sm;
  return cudaSuccess;
}

template <typename T, int D, int MT>
cudaError_t launch(const void* qkv, const void* valid, void* out, float* lse, int B, int N,
                   int C, int H, int K, float scale, int chunk, cudaStream_t stream) {
  int blocks_per_sm = 0, sms = 0;
  if (cudaError_t e = residency<T, D, MT>(blocks_per_sm, sms)) return e;
  const int P = (N + K - 1) / K;
  const long long units = (long long)B * P * H;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long resident = (long long)blocks_per_sm * sms;
  const int grid = (int)(units < resident ? units : resident);
  fwa_fwd_small_kernel<T, D, MT><<<grid, 32 * MT, SmallLayout<D, MT>::BYTES, stream>>>(
      static_cast<const T*>(qkv), static_cast<const uint8_t*>(valid), static_cast<T*>(out),
      lse, N, C, H, K, P, (int)units, chunk, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_t(const void* qkv, const void* valid, void* out, float* lse, int B, int N,
                     int C, int H, int K, float scale, int chunk, cudaStream_t s) {
  switch ((K + 15) / 16) {
    case 1: return launch<T, D, 1>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
    case 2: return launch<T, D, 2>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
    case 3: return launch<T, D, 3>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
    case 4: return launch<T, D, 4>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

// head width D in the storage type `dtype` (1 bf16, 2 fp16)
template <int D>
cudaError_t launch_d(int dtype, const void* qkv, const void* valid, void* out, float* lse,
                     int B, int N, int C, int H, int K, float scale, int chunk, cudaStream_t s) {
  if (dtype == 1) return launch_t<bf16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
  if (dtype == 2) return launch_t<fp16, D>(qkv, valid, out, lse, B, N, C, H, K, scale, chunk, s);
  return cudaErrorInvalidValue;
}

template <int D>
cudaError_t residency_d(int K, int& blocks_per_sm, int& sms) {
  switch ((K + 15) / 16) {
    case 1: return residency<bf16, D, 1>(blocks_per_sm, sms);
    case 2: return residency<bf16, D, 2>(blocks_per_sm, sms);
    case 3: return residency<bf16, D, 3>(blocks_per_sm, sms);
    case 4: return residency<bf16, D, 4>(blocks_per_sm, sms);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 (dtype 1) or fp16 (dtype 2); windows of 1 to 64 slots; head widths
// 16, 32, 48, 64, 96 and 128 (the wrapper pads any other width to the next
// of them); units dealt to the blocks in runs of `chunk` (0: a contiguous
// share a block, at most MAX_CHUNK). lse may be null (inference). Returns a
// cudaError_t (0 on success), cudaErrorInvalidValue for what it was not
// built for.
extern "C" int fwa_fwd_small(const void* qkv, const void* valid, void* out, void* lse,
                             int dtype, int B, int N, int C, int H, int K, float scale,
                             int chunk, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= 0 || K > SMALL_MAX || C % H != 0)
    return cudaErrorInvalidValue;
  if (chunk < 0 || chunk > MAX_CHUNK) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (C / H) {
    case 16: return launch_d<16>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    case 32: return launch_d<32>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    case 48: return launch_d<48>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    case 64: return launch_d<64>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    case 96: return launch_d<96>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    case 128: return launch_d<128>(dtype, qkv, valid, out, l, B, N, C, H, K, scale, chunk, s);
    default: return cudaErrorInvalidValue;
  }
}

// The kernel's resident blocks per SM at head width D and window K in bf16
// (fp16's are the same; the report of tools/torch_kernel_bench.py), or -1
// for a shape it lacks.
extern "C" int fwa_fwd_small_residency(int D, int K) {
  int bps = 0, sms = 0;
  cudaError_t e = cudaErrorInvalidValue;
  if (K > 0 && K <= SMALL_MAX) {
    if (D == 16) e = residency_d<16>(K, bps, sms);
    if (D == 32) e = residency_d<32>(K, bps, sms);
    if (D == 48) e = residency_d<48>(K, bps, sms);
    if (D == 64) e = residency_d<64>(K, bps, sms);
    if (D == 96) e = residency_d<96>(K, bps, sms);
    if (D == 128) e = residency_d<128>(K, bps, sms);
  }
  return e ? -1 : bps;
}
