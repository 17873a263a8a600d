// K2 in bf16 and fp16 at windows above 64 slots: the flash-window
// attention backward's bf16_large variant, for NVIDIA Hopper (sm_90a), in a
// source and a library of its own so that it builds beside the one-pass
// variant (flash_window_attn_bwd.cu, whose header gives the function: dqkv
// from qkv, valid, lse and dO, rounding where the TPU kernel
// scenesplat_tpu/ops/pallas_attn.py:_bwd_kernel rounds; its helpers are
// copies of that file's).
//
// Windows above SMALL_MAX (the encoder's 1024): bound by operations, and at
// D = 16 by the work around the products (an exponential and a handful of
// fp32 operations a score, twice). Two kernels on the caller's stream, with
// K1's large-window machinery (flash_window_attn_fwd.cu): K2a, a block of
// LQ query rows, writes delta = rowsum(dO * O) (16-byte loads; P * dP would
// need every key first) and dQ, walking only the key tiles that hold a
// valid key; K2b, a block of LQ key rows, walks every query tile of the
// window with dK and dV in fp32 registers, and a block without a valid key
// writes zeros and leaves. Both: tiles of 64 rows by 16-byte cp.async in a
// ring of three stages (dynamic shared memory: 104 KB at D = 128), one
// block barrier a tile; every shared-memory operand by ldmatrix (transposed
// ones by ldmatrix.trans); four warps of LMT m16 tiles (two up to D = 48, so
// each fragment read feeds two products; one from 64 on, where two tiles'
// accumulators would spill); scores 32 columns at a time to bound
// registers; P in the exp2 domain with log2(e) folded into one FFMA;
// results staged in shared memory for 16-byte row stores. No atomics: the
// result is deterministic. Head widths 16, 32, 48, 64, 96 and 128, bf16 and
// fp16 (Elem).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fwa_common.cuh"

namespace {

constexpr int SMALL_MAX = 64;  // the small variant's largest window: 4 m16 tiles

// ---- bf16_large: K2a (dQ, delta) and K2b (dK, dV) -------------------------

constexpr int LT = 64;          // rows of a streamed tile: keys in K2a, queries in K2b
constexpr int LSTAGES = 3;      // streamed tiles in flight
constexpr int MAX_TILES = 64;   // key tiles a pass of K2a's validity list holds

// The blocks' shape at head width D, four warps each: LMT m16 tiles a warp,
// so LQ = 64 LMT rows a block, and the blocks an SM should hold. Up to 48,
// two tiles a warp; from 64 on the accumulators of two tiles (dK and dV: 8 D
// fp32 registers a thread) would spill, so one tile a warp.
template <int D>
struct LargeBwdCfg {
  static constexpr int LMT = D <= 48 ? 2 : 1;
  static constexpr int LQ = 64 * LMT;  // rows a block owns: queries in K2a, keys in K2b
  static constexpr int MIN_BLOCKS = D == 16 ? 3 : (D <= 48 ? 2 : (D <= 64 ? 3 : (D <= 96 ? 2 : 1)));
  static constexpr int STR = D + 8;
  static constexpr int BYTES = LSTAGES * 2 * LT * STR * 2;  // the streamed ring, dynamic
};

// dQ and delta: a block owns 128 query rows of one (batch, window, head) and
// walks the window's key tiles that hold a valid key
template <typename T, int D>
__global__ void __launch_bounds__(128, LargeBwdCfg<D>::MIN_BLOCKS)
fwa_bwd_dq_large_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                        const T* __restrict__ out, const float* __restrict__ lse,
                        const T* __restrict__ dout, T* __restrict__ dqkv,
                        float* __restrict__ delta, int N, int C, int H, int K, int P, int NQ,
                        float scale) {
  using E = Elem<T>;
  constexpr int LMT = LargeBwdCfg<D>::LMT, LQ = LargeBwdCfg<D>::LQ;
  constexpr int KS = D / 16, NDIM = D / 8, STR = D + 8, CH = D / 8;
  constexpr int TILE = LT * STR;
  // k, v rows [key][d] of LSTAGES tiles: tile s's k at kv + 2 s TILE, its v
  // one TILE on (dynamic: 104 KB at D = 128)
  extern __shared__ __align__(128) unsigned char smem[];
  T* const kv = reinterpret_cast<T*>(smem);
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

  if (tid < LQ) {  // delta = rowsum(dO * O) in fp32, one row a thread, 16-byte loads
    const int row = q0 + tid;
    float dl = 0.f;
    if (row < wlen) {
      const uint4* op = reinterpret_cast<const uint4*>(out + (tok0 + row) * C + h * D);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + (tok0 + row) * C + h * D);
#pragma unroll
      for (int part = 0; part < CH; ++part) {
        const uint4 o4 = op[part], g4 = gp[part];
        const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&o4);
        const uint32_t* g2 = reinterpret_cast<const uint32_t*>(&g4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = E::unpack(o2[e]), gf = E::unpack(g2[e]);
          dl = fmaf(of.x, gf.x, dl);
          dl = fmaf(of.y, gf.y, dl);
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
        qa[mt][t][r] = scale2<T>(qv, scale);
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
      T* ks = kv + (li % LSTAGES) * 2 * TILE;
      T* vs = ks + TILE;
      for (int i = tid; i < LT * CH; i += 128) {
        const int j = i / CH, part = i - j * CH;
        const bool ok = t0 + j < wlen;
        const T* src = qkv + (tok0 + (ok ? t0 + j : 0)) * stride + C + h * D + part * 8;
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
      const T* ks = kv + (it % LSTAGES) * 2 * TILE;
      const T* vs = ks + TILE;
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
              E::mma(sc[mt][2 * np], qa[mt][t], kb[0], kb[1]);
              E::mma(sc[mt][2 * np + 1], qa[mt][t], kb[2], kb[3]);
              E::mma(dp[mt][2 * np], ga[mt][t], vb[0], vb[1]);
              E::mma(dp[mt][2 * np + 1], ga[mt][t], vb[2], vb[3]);
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
              sa[mt][2 * half] = E::pack(x[0], x[1]);
              sa[mt][2 * half + 1] = E::pack(x[2], x[3]);
            }
          }
#pragma unroll
          for (int np = 0; np < KS; ++np) {
            uint32_t kb[4];  // (b0, b1) of d tiles 2 np and 2 np + 1
            ldmatrix_x4_trans(kb, &ks[(kh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
#pragma unroll
            for (int mt = 0; mt < LMT; ++mt) {
              E::mma(dq[mt][2 * np], sa[mt], kb[0], kb[1]);
              E::mma(dq[mt][2 * np + 1], sa[mt], kb[2], kb[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  __syncthreads();  // every warp is done with the ring: it now holds the dQ tile
  T* ot = kv;  // [LQ][STR]
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * (16 * LMT) + mt * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NDIM; ++n)
        *reinterpret_cast<uint32_t*>(&ot[lrow * STR + n * 8 + c2]) =
            E::pack(scale * dq[mt][n][2 * r], scale * dq[mt][n][2 * r + 1]);
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
template <typename T, int D>
__global__ void __launch_bounds__(128, LargeBwdCfg<D>::MIN_BLOCKS)
fwa_bwd_dkv_large_kernel(const T* __restrict__ qkv, const uint8_t* __restrict__ valid,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         const T* __restrict__ dout, T* __restrict__ dqkv, int N, int C,
                         int H, int K, int P, int NK, float scale) {
  using E = Elem<T>;
  constexpr int LMT = LargeBwdCfg<D>::LMT, LQ = LargeBwdCfg<D>::LQ;
  constexpr int KS = D / 16, NDIM = D / 8, STR = D + 8, CH = D / 8;
  constexpr int TILE = LT * STR;
  // q, dO rows [query][d] of LSTAGES tiles: tile s's q at qg + 2 s TILE, its
  // dO one TILE on (dynamic: 104 KB at D = 128)
  extern __shared__ __align__(128) unsigned char smem[];
  T* const qg = reinterpret_cast<T*>(smem);
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
        T* p = dqkv + (tok0 + row) * stride + C + h * D + (i % CH) * 8;
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
      cp_async16(&qg[2 * s * TILE + j * STR + part * 8], qkv + row * stride + h * D + part * 8,
                 ok);
      cp_async16(&qg[(2 * s + 1) * TILE + j * STR + part * 8], dout + row * C + h * D + part * 8,
                 ok);
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
          const T* p = qkv + (tok0 + row) * stride + C + h * D + d;
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
    const T* qs = qg + (it % LSTAGES) * 2 * TILE;
    const T* gs = qs + TILE;
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
          for (int r = 0; r < 4; ++r) qb[r] = scale2<T>(qb[r], scale);
#pragma unroll
          for (int mt = 0; mt < LMT; ++mt) {
            E::mma(sc[mt][2 * np], ka[mt][t], qb[0], qb[1]);
            E::mma(sc[mt][2 * np + 1], ka[mt][t], qb[2], qb[3]);
            E::mma(dp[mt][2 * np], va[mt][t], gb[0], gb[1]);
            E::mma(dp[mt][2 * np + 1], va[mt][t], gb[2], gb[3]);
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
          pa[mt][0] = E::pack(sc[mt][2 * kk][0], sc[mt][2 * kk][1]);
          pa[mt][1] = E::pack(sc[mt][2 * kk][2], sc[mt][2 * kk][3]);
          pa[mt][2] = E::pack(sc[mt][2 * kk + 1][0], sc[mt][2 * kk + 1][1]);
          pa[mt][3] = E::pack(sc[mt][2 * kk + 1][2], sc[mt][2 * kk + 1][3]);
          da[mt][0] = E::pack(dp[mt][2 * kk][0], dp[mt][2 * kk][1]);
          da[mt][1] = E::pack(dp[mt][2 * kk][2], dp[mt][2 * kk][3]);
          da[mt][2] = E::pack(dp[mt][2 * kk + 1][0], dp[mt][2 * kk + 1][1]);
          da[mt][3] = E::pack(dp[mt][2 * kk + 1][2], dp[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t gb[4], qb[4];  // (b0, b1) of d tiles 2 np and 2 np + 1
          ldmatrix_x4_trans(gb, &gs[(qh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
          ldmatrix_x4_trans(qb, &qs[(qh * 32 + kk * 16 + lr) * STR + np * 16 + lc]);
#pragma unroll
          for (int mt = 0; mt < LMT; ++mt) {
            E::mma(dv[mt][2 * np], pa[mt], gb[0], gb[1]);
            E::mma(dv[mt][2 * np + 1], pa[mt], gb[2], gb[3]);
            E::mma(dk[mt][2 * np], da[mt], qb[0], qb[1]);
            E::mma(dk[mt][2 * np + 1], da[mt], qb[2], qb[3]);
          }
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it now holds dK and dV
  T* kt_s = qg;                      // dK [LQ][STR]
  T* vt_s = kt_s + LQ * STR;      // dV [LQ][STR]
#pragma unroll
  for (int mt = 0; mt < LMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lrow = warp * (16 * LMT) + mt * 16 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < NDIM; ++n) {
        *reinterpret_cast<uint32_t*>(&kt_s[lrow * STR + n * 8 + c2]) =
            E::pack(scale * dk[mt][n][2 * r], scale * dk[mt][n][2 * r + 1]);
        *reinterpret_cast<uint32_t*>(&vt_s[lrow * STR + n * 8 + c2]) =
            E::pack(dv[mt][n][2 * r], dv[mt][n][2 * r + 1]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < LQ * CH; i += 128) {
    const int lrow = i / CH, part = i - lrow * CH;
    if (k0 + lrow < wlen) {
      T* p = dqkv + (tok0 + k0 + lrow) * stride + C + h * D + part * 8;
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(&kt_s[lrow * STR + part * 8]);
      *reinterpret_cast<uint4*>(p + C) =
          *reinterpret_cast<const uint4*>(&vt_s[lrow * STR + part * 8]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_large_t(const void* qkv, const void* valid, const void* out, const float* lse,
                           const void* dout, void* dqkv, float* delta, int B, int N, int C,
                           int H, int K, float scale, cudaStream_t stream) {
  using L = LargeBwdCfg<D>;
  static cudaError_t set = [] {
    cudaError_t e = cudaFuncSetAttribute(fwa_bwd_dq_large_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (!e)
      e = cudaFuncSetAttribute(fwa_bwd_dkv_large_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    return e;
  }();
  if (set) return set;
  const int P = (N + K - 1) / K;
  const int NT = (K + L::LQ - 1) / L::LQ;  // row tiles a window, both kernels
  const long long blocks = (long long)B * P * H * NT;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto* q = static_cast<const T*>(qkv);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* g = static_cast<const T*>(dout);
  fwa_bwd_dq_large_kernel<T, D><<<(unsigned)blocks, 128, L::BYTES, stream>>>(
      q, v, static_cast<const T*>(out), lse, g, static_cast<T*>(dqkv), delta, N, C, H, K, P,
      NT, scale);
  if (cudaError_t e = cudaGetLastError()) return e;
  fwa_bwd_dkv_large_kernel<T, D><<<(unsigned)blocks, 128, L::BYTES, stream>>>(
      q, v, lse, delta, g, static_cast<T*>(dqkv), N, C, H, K, P, NT, scale);
  return cudaGetLastError();
}

// head width D in the storage type `dtype` (1 bf16, 2 fp16)
template <int D>
cudaError_t launch_large(int dtype, const void* qkv, const void* valid, const void* out,
                         const float* lse, const void* dout, void* dqkv, float* delta, int B,
                         int N, int C, int H, int K, float scale, cudaStream_t s) {
  if (dtype == 1)
    return launch_large_t<bf16, D>(qkv, valid, out, lse, dout, dqkv, delta, B, N, C, H, K, scale,
                                   s);
  if (dtype == 2)
    return launch_large_t<fp16, D>(qkv, valid, out, lse, dout, dqkv, delta, B, N, C, H, K, scale,
                                   s);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16_large: windows above 64 slots in bf16 (dtype 1) or fp16 (dtype 2),
// head widths 16, 32, 48, 64, 96 and 128. dqkv from qkv, valid, the
// forward's out and lse, and dout; delta [B, N, H] fp32 is scratch. K2a then
// K2b on one stream.
extern "C" int fwa_bwd_large(const void* qkv, const void* valid, const void* out,
                             const void* lse, const void* dout, void* dqkv, void* delta,
                             int dtype, int B, int N, int C, int H, int K, float scale,
                             void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || K <= SMALL_MAX || C % H != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (C / H) {
    case 16:
      return launch_large<16>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    case 32:
      return launch_large<32>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    case 48:
      return launch_large<48>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    case 64:
      return launch_large<64>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    case 96:
      return launch_large<96>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    case 128:
      return launch_large<128>(dtype, qkv, valid, out, l, dout, dqkv, dl, B, N, C, H, K, scale,
                               s);
    default: return cudaErrorInvalidValue;
  }
}
