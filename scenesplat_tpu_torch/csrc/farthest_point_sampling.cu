// Farthest point sampling of the rows of a padded cloud, for NVIDIA Hopper
// (sm_90a): all M steps of a row in one launch.
//
// Replaces no TPU kernel. The JAX package's farthest_point_sampling
// (scenesplat_tpu/ops/pointops.py:205) is an XLA lax.fori_loop, not Pallas;
// the port's plain version (ops/pointops.py:farthest_point_sampling_reference)
// is a host loop of a few launches a step, about 0.2 ms a sample on an H100,
// and the Stratified Transformer takes about 0.42 N samples a forward. The
// reference runs one CUDA kernel (libs/pointops/src/sampling/
// sampling_cuda_kernel.cu); this is that kernel's counterpart.
//
// Semantics, bit for bit those of the plain loop: start at the row's first
// valid point (given by the wrapper); every valid point keeps its least
// squared distance to the points taken, d2 = (dx dx + dy dy) + dz dz with
// dx = x - x_last, each operation rounded once (__fsub_rn, __fmul_rn,
// __fadd_rn: nothing contracts to an FMA, as the plain version's separate
// elementwise launches do not); a padded point keeps -1e10; the next point
// is the argmax over the row, ties to the lowest index (torch.argmax's rule).
//
// What bounds it: the M steps form a chain. Each step reads every point of
// the row once (12 bytes and 10 fp32 operations a point) and ends in a
// row-wide argmax that the next step waits for, so the time is M times the
// latency of one scan plus one reduction, far above both the bytes and the
// operations bound. The design keeps that step short:
//   - a row is C blocks of 1024 threads, C the fewest of 1, 2, 4, 8, 16
//     whose shared memory holds the whole row (BLOCK_POINTS a block; the
//     wrapper's ops/fps.py:blocks_per_row picks C): one block needs no
//     cluster, more form a thread block cluster (16 is non-portable). Only
//     a row longer than 16 blocks hold keeps its rest in a scratch row in
//     device memory, read through L2. A row of at most SMALL_POINTS runs
//     on one block of SMALL_THREADS, whose fewer warps repeat less of the
//     step's fixed work;
//   - a point's coordinates sit in shared memory, four points' x (y, z) in
//     one float4, and its least distance in a register of the thread that
//     owns it (PER_THREAD a thread), so a step reads shared memory for
//     coordinates only, one load per coordinate and 4 points, and never
//     writes it;
//   - a step: each thread scans its points; a warp's best is two redux
//     instructions on (the distance's order-preserving bits, the index);
//     after one barrier every warp of a lone block reduces the warps'
//     results itself and reads the winner's coordinates from shared memory.
//     In a cluster, warp 0 alone reduces them and pushes the block's
//     candidate, (key, index, x, y, z), into every block's shared memory
//     with st.async, which completes its bytes on that block's mbarrier;
//     warp 0 waits once on its own block's barrier, takes the best of the C
//     candidates (a lower block holds only lower indices) and leaves the
//     point for the other warps behind a second named barrier. No load of
//     device memory is on the chain; the candidate slots and barriers are
//     double-buffered by the step's parity.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;      // threads of a block
constexpr int SMALL_THREADS = 256;  // threads of the one block of a small row
constexpr int PER_THREAD = 16;     // points of a thread in shared memory and registers
constexpr int GROUPS = PER_THREAD / 4;  // a thread's points in float4s of 4 points' x (y, z)
constexpr int BLOCK_POINTS = PER_THREAD * THREADS;
constexpr int SMALL_POINTS = PER_THREAD * SMALL_THREADS;
constexpr int MAX_CLUSTER = 16;  // blocks of a row at most
constexpr size_t MAX_SMEM = (size_t)BLOCK_POINTS * 3 * sizeof(float);
constexpr int CAND_BYTES = 20;  // a block's candidate: key, index, x, y, z
constexpr int RESULTS_BAR = 1;  // named barriers in a cluster: the warps' results are in
constexpr int TAKEN_BAR = 2;    // shared memory, and the point taken is
constexpr int EXPECTER = 32;    // the thread that arrives on a step's barrier with its bytes
constexpr int SCRIBE = 64;      // the thread that writes the ids (block 0 of a row)
constexpr float BIG = 1e10f;
constexpr float NEG_INF = -__builtin_huge_valf();  // below every point, padded ones too
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NONE = 0xffffffffu;  // an index no candidate takes
constexpr int NO_CLUSTER = -2;          // the card cannot schedule a 16-block cluster

// unsigned bits that order as the floats do
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// a candidate into another block's shared memory, completing CAND_BYTES of
// the transaction count of its barrier `bar` (both addresses in that block)
__device__ __forceinline__ void send_candidate(uint32_t slot, uint32_t bar, uint32_t key,
                                               uint32_t index, float x, float y, float z) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.u32 [%0], {%1, %2, %3, %4}, "
      "[%5];"
      :: "r"(slot), "r"(key), "r"(index), "r"(__float_as_uint(x)), "r"(__float_as_uint(y)),
         "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               :: "r"(slot + 16), "r"(__float_as_uint(z)), "r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// (key, j) of the best of the lanes: the largest key, at it the lowest j
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& j) {
  const unsigned best = __reduce_max_sync(FULL, key);
  j = __reduce_min_sync(FULL, key == best ? j : NONE);
  key = best;
}

// Thread t's k-th point is the block's point j = k T + t. Shared memory
// holds it as x, y, z in three float4s of thread t's points 4 (k / 4) to
// 4 (k / 4) + 3.
template <int T>
__device__ __forceinline__ int slot_of(int k, int t, int axis) {
  return (((k >> 2) * 3 + axis) * T + t) * 4 + (k & 3);
}

template <int T>
__device__ __forceinline__ void point_at(const float* sxyz, unsigned j, float& x, float& y,
                                         float& z) {
  const int k = j / T, t = j % T;
  x = sxyz[slot_of<T>(k, t, 0)];
  y = sxyz[slot_of<T>(k, t, 1)];
  z = sxyz[slot_of<T>(k, t, 2)];
}

// d2 of a point to the last one taken, its least distance kept, and the
// thread's best so far: larger, or equal at a lower index (j ascends)
__device__ __forceinline__ void visit(float x, float y, float z, float lx, float ly, float lz,
                                      float& dist, unsigned j, float& bv, unsigned& bj) {
  const float dx = __fsub_rn(x, lx), dy = __fsub_rn(y, ly), dz = __fsub_rn(z, lz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  dist = fminf(dist, d2);  // -1e10 (padded) and -inf (no point) stay
  if (dist > bv) {
    bv = dist;
    bj = j;
  }
}

template <int C, int T>
__global__ void __launch_bounds__(T, 1)
    fps_rows(const float* __restrict__ coord, const uint8_t* __restrict__ mask,
             const long long* __restrict__ first, long long* __restrict__ out,
             float4* __restrict__ spill, int n, int m, int part) {
  constexpr int WARPS = T / 32;
  extern __shared__ __align__(16) float sxyz[];
  __shared__ unsigned warp_key[2][WARPS];
  __shared__ unsigned warp_j[2][WARPS];
  // each block's candidate: (key, index, x, y), (z, -, -, -)
  __shared__ __align__(16) uint4 cand[2][C][2];
  __shared__ __align__(8) unsigned long long full[2];
  __shared__ __align__(16) uint4 last;  // in a cluster, the point taken: index, x, y, z

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int row = blockIdx.x / C;
  const float* c = coord + (size_t)row * n * 3;
  const uint8_t* mk = mask + (size_t)row * n;
  const int lo = rank * part;
  const int len = max(0, min(n, lo + part) - lo);
  const int held = min(len, PER_THREAD * T);
  const int mine = held > t ? (held - t + T - 1) / T : 0;
  float dist[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    dist[k] = NEG_INF;  // a slot without a point
    if (k < mine) {
      const int i = lo + k * T + t;
      sxyz[slot_of<T>(k, t, 0)] = c[3 * i];
      sxyz[slot_of<T>(k, t, 1)] = c[3 * i + 1];
      sxyz[slot_of<T>(k, t, 2)] = c[3 * i + 2];
      dist[k] = mk[i] ? BIG : -BIG;
    }
  }
  float4* sp = nullptr;  // the block's points past shared memory, at their index in the block
  if (C == MAX_CLUSTER && len > BLOCK_POINTS) {
    sp = spill + (size_t)row * n + lo;
    for (int j = BLOCK_POINTS + t; j < len; j += T) {
      const int i = lo + j;
      sp[j] = make_float4(c[3 * i], c[3 * i + 1], c[3 * i + 2], mk[i] ? BIG : -BIG);
    }
  }
  const long long f = first[row];
  float lx = c[3 * f], ly = c[3 * f + 1], lz = c[3 * f + 2];
  if (rank == 0 && t == SCRIBE) out[(size_t)row * m] = f;
  if constexpr (C > 1) {
    if (t == 0) {
      for (int b = 0; b < 2; ++b)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_addr(&full[b]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }

  const float4* s4 = reinterpret_cast<const float4*>(sxyz) + t;
  for (int step = 1; step < m; ++step) {
    const int p = step & 1;
    if (C > 1 && t == EXPECTER) expect_bytes(smem_addr(&full[p]), C * CAND_BYTES);
    float bv = NEG_INF;
    unsigned bj = NONE;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      if (4 * g >= mine) break;
      const float4 x = s4[(3 * g) * T], y = s4[(3 * g + 1) * T], z = s4[(3 * g + 2) * T];
      const unsigned j = 4 * g * T + t;
      visit(x.x, y.x, z.x, lx, ly, lz, dist[4 * g], j, bv, bj);
      visit(x.y, y.y, z.y, lx, ly, lz, dist[4 * g + 1], j + T, bv, bj);
      visit(x.z, y.z, z.z, lx, ly, lz, dist[4 * g + 2], j + 2 * T, bv, bj);
      visit(x.w, y.w, z.w, lx, ly, lz, dist[4 * g + 3], j + 3 * T, bv, bj);
    }
    if (C == MAX_CLUSTER && sp) {
      for (int j = BLOCK_POINTS + t; j < len; j += T) {
        float4 q = sp[j];
        const float w = q.w;
        visit(q.x, q.y, q.z, lx, ly, lz, q.w, j, bv, bj);
        if (q.w < w) sp[j].w = q.w;
      }
    }
    unsigned key = order_key(bv);
    warp_best(key, bj);
    if (lane == 0) {
      warp_key[p][warp] = key;
      warp_j[p][warp] = bj;
    }
    if constexpr (C == 1) {
      __syncthreads();
      // every warp takes the block's best itself: no second barrier
      key = lane < WARPS ? warp_key[p][lane] : 0u;
      bj = lane < WARPS ? warp_j[p][lane] : NONE;
      warp_best(key, bj);
      point_at<T>(sxyz, bj, lx, ly, lz);
      if (t == SCRIBE) out[(size_t)row * m + step] = bj;
    } else if (warp == 0) {
      // warp 0 takes the row's best; the others wait for the point it
      // leaves in `last`
      asm volatile("bar.sync %0, %1;" :: "n"(RESULTS_BAR), "n"(T) : "memory");
      key = warp_key[p][lane];
      bj = warp_j[p][lane];
      warp_best(key, bj);  // the block holds a point, so bj is one of them
      float bx, by, bz;
      if (bj < BLOCK_POINTS) {
        point_at<T>(sxyz, bj, bx, by, bz);
      } else {
        const float4 q = sp[bj];
        bx = q.x;
        by = q.y;
        bz = q.z;
      }
      if (lane < C)
        send_candidate(map_rank(smem_addr(&cand[p][rank][0]), lane),
                       map_rank(smem_addr(&full[p]), lane), key, lo + bj, bx, by, bz);
      // full[p]'s phases are the steps of parity p: this is phase (step - 1) / 2
      wait_parity(smem_addr(&full[p]), ((step - 1) >> 1) & 1);
      uint4 a = make_uint4(0u, NONE, 0u, 0u);  // key 0: below every candidate's
      unsigned az = 0u;
      if (lane < C) {
        a = cand[p][lane][0];
        az = cand[p][lane][1].x;
      }
      // a lower block holds only lower indices: the lowest at the largest key
      const unsigned ck = __reduce_max_sync(FULL, a.x);
      const int src = __ffs(__ballot_sync(FULL, a.x == ck)) - 1;
      const unsigned ci = __shfl_sync(FULL, a.y, src);
      const unsigned x = __shfl_sync(FULL, a.z, src), y = __shfl_sync(FULL, a.w, src),
                     z = __shfl_sync(FULL, az, src);
      if (lane == 0) last = make_uint4(ci, x, y, z);
      lx = __uint_as_float(x);
      ly = __uint_as_float(y);
      lz = __uint_as_float(z);
      asm volatile("bar.arrive %0, %1;" :: "n"(TAKEN_BAR), "n"(T) : "memory");
    } else {
      asm volatile("bar.arrive %0, %1;" :: "n"(RESULTS_BAR), "n"(T) : "memory");
      asm volatile("bar.sync %0, %1;" :: "n"(TAKEN_BAR), "n"(T) : "memory");
      const uint4 l = last;
      lx = __uint_as_float(l.y);
      ly = __uint_as_float(l.z);
      lz = __uint_as_float(l.w);
      if (rank == 0 && t == SCRIBE) out[(size_t)row * m + step] = l.x;
    }
  }
  if constexpr (C > 1) {
    // no block leaves while another may still write to its shared memory
    cg::this_cluster().sync();
  }
}

// Whether device `dev` schedules a cluster of 16 blocks of the kernel at
// its most shared memory; asked once a device.
int cluster16_ok(int dev, cudaLaunchConfig_t config) {
  static int known[64] = {};  // 0 not asked, 1 yes, -1 no
  if (dev >= 0 && dev < 64 && known[dev]) return known[dev] > 0 ? 0 : NO_CLUSTER;
  config.dynamicSmemBytes = MAX_SMEM;
  int clusters = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&clusters, fps_rows<MAX_CLUSTER, THREADS>, &config);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 0 && dev < 64) known[dev] = clusters > 0 ? 1 : -1;
  return clusters > 0 ? 0 : NO_CLUSTER;
}

template <int C, int T>
int launch(const float* coord, const uint8_t* mask, const long long* first, long long* out,
           float4* spill, int batch, int n, int m, int part, cudaStream_t stream) {
  static bool ready[64] = {};  // the kernel's attributes set on this device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(fps_rows<C, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)MAX_SMEM);
    if (err == cudaSuccess && C == MAX_CLUSTER)
      err = cudaFuncSetAttribute(fps_rows<C, T>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                                 1);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < 64) ready[dev] = true;
  }
  const int held = part < PER_THREAD * T ? part : PER_THREAD * T;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * C);
  config.blockDim = dim3(T);
  // whole float4s of 4 points a thread
  config.dynamicSmemBytes = (size_t)((held + 4 * T - 1) / (4 * T)) * 3 * T * sizeof(float4);
  config.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = C > 1 ? 1 : 0;
  if (C == MAX_CLUSTER) {
    const int rc = cluster16_ok(dev, config);
    if (rc) return rc;
  }
  err = cudaLaunchKernelEx(&config, fps_rows<C, T>, coord, mask, first, out, spill, n, m, part);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

// Points a block holds in shared memory (the wrapper's BLOCK_POINTS).
extern "C" int fps_block_points() { return BLOCK_POINTS; }

// Farthest point sampling of `batch` rows of n points: coord [batch, n, 3]
// fp32, mask [batch, n] bytes (0 or 1), first [batch] int64 (each row's
// first valid index, n - 1 for a row without one) -> out [batch, m] int64,
// each row on `blocks` blocks (1, 2, 4, 8 or 16, each holding a point; past
// BLOCK_POINTS a block only at 16, with spill scratch of batch * n float4).
// Returns 0, a CUDA error code, -1 for arguments it does not take, or -2
// when the card cannot schedule a cluster of 16 blocks.
extern "C" int farthest_point_sampling(const void* coord, const void* mask, const void* first,
                                       void* out, void* spill, int batch, int n, int m,
                                       int blocks, void* stream) {
  if (!coord || !mask || !first || !out || batch < 1 || n < 1 || m < 1) return -1;
  if (blocks != 1 && blocks != 2 && blocks != 4 && blocks != 8 && blocks != MAX_CLUSTER)
    return -1;
  const int part = (n + blocks - 1) / blocks;
  if ((long long)(blocks - 1) * part >= n) return -1;  // a block without a point
  if (part > BLOCK_POINTS && (blocks != MAX_CLUSTER || !spill)) return -1;
  const float* c = static_cast<const float*>(coord);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const long long* f = static_cast<const long long*>(first);
  long long* o = static_cast<long long*>(out);
  float4* sp = static_cast<float4*>(spill);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (blocks) {
    case 1:
      return n <= SMALL_POINTS ? launch<1, SMALL_THREADS>(c, mk, f, o, sp, batch, n, m, part, s)
                               : launch<1, THREADS>(c, mk, f, o, sp, batch, n, m, part, s);
    case 2: return launch<2, THREADS>(c, mk, f, o, sp, batch, n, m, part, s);
    case 4: return launch<4, THREADS>(c, mk, f, o, sp, batch, n, m, part, s);
    case 8: return launch<8, THREADS>(c, mk, f, o, sp, batch, n, m, part, s);
    default: return launch<MAX_CLUSTER, THREADS>(c, mk, f, o, sp, batch, n, m, part, s);
  }
}
