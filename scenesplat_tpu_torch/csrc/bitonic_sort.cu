// K3: bitonic sort of the rows of [B, n] 32-bit operands, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel scenesplat_tpu/ops/pallas_sort.py:_sort_kernel
// (entered through _sort_rows). It computes the same network on the same
// padded rows: np2 is n rounded up to a power of two, phase m = 2, 4, ...,
// np2 merges runs of length m with compare-exchange stages at distance
// d = m/2, ..., 1 between element i and its partner i ^ d, ascending where
// (i & m) == 0. Rows are ordered lexicographically over the first num_keys
// operands compared as unsigned 32-bit values, the other operands ride along
// as payload, and a pair is exchanged only when the keys are strictly out of
// order (ties keep their places), so the result equals the TPU kernel's
// element for element. A slot at or past n carries the key 0xFFFFFFFF (and
// payload 0): it is formed while loading, never stored in a padded buffer.
//
// The work is bound by bytes: every operand read and written once is the
// least, while the network makes log2(np2) (log2(np2) + 1) / 2 stages (171 at
// 2^18), each a compare of up to three words and a conditional swap: about a
// dozen integer instructions a pair and a stage, at half the card's fp32
// rate, so it stays far above the bytes bound. The TPU kernel keeps a whole
// row as a [R, 128] tile in VMEM and exchanges by rolls, one grid step per
// row. A Hopper block has at most 227 KB of shared memory, a batch has few
// rows, and one SM sorts slowly, so the network is cut into passes, and what
// this design is after is few launches, few trips through memory, no bank
// conflicts and many SMs at work even on a single row:
//   - a pass gives a thread 16 elements and runs up to four stages on them
//     in registers, without a barrier in between; a pair is compared by the
//     borrow of one multi-word subtraction;
//   - sort_local: a block of 256 threads holds 4,096 elements of every
//     operand in shared memory, and a thread block cluster of up to 8 such
//     blocks holds a tile of 32,768. Stages at distances below 4,096 stay
//     inside a block: passes on elements i0 + j * dl (distances 8 dl .. dl),
//     the last pass of a phase on 16 neighbours, one block barrier a pass.
//     Word i of a block's part sits at i ^ ((i >> 5) & 31), so both 16
//     consecutive words and strided words spread over the banks. Stages at
//     distances of 4,096 .. 16,384 cross the blocks of a cluster: the blocks
//     put their parts into the scratch rows, meet at a cluster barrier, run
//     one pass on those rows in L2, meet again and take their parts back
//     (the other blocks' shared memory, read in 4-byte words, moved a
//     quarter of what L2 moves). One launch runs every stage below the
//     tile's length of the phases it is given;
//   - sort_global: one pass (up to four stages at distances of at least the
//     tile) straight on device memory, neighbouring threads on neighbouring
//     words; the kernel boundary orders the passes.
// The host function queues the launches on the caller's stream: all phases
// up to the tile in the first, then per larger phase its global passes and
// one sort_local for the rest: 7 launches for a row of 2^18. The first
// launch reads the caller's operands (or the int64 codes, as (high, low,
// index)), the last writes the first n slots of the results (or the sorted
// codes and the int64 order); in between the rows live in scratch the
// wrapper allocates.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_OPS = 3;
constexpr int GROUP = 16;          // elements a thread holds in a pass
constexpr int LOG_GROUP = 4;       // stages a pass can run
constexpr int BLOCK_TILE = 4096;  // elements of one operand in a block's shared memory
constexpr int CLUSTER = 8;        // blocks of a cluster: a tile of 32,768
constexpr int LOCAL_THREADS = BLOCK_TILE / GROUP;
constexpr int GLOBAL_THREADS = 256;
constexpr uint32_t PAD_KEY = 0xFFFFFFFFu;

struct Io {
  uint32_t* work[MAX_OPS];      // scratch rows [B, np2]
  const uint32_t* in[MAX_OPS];  // the caller's operands [B, n] (null with codes)
  uint32_t* out[MAX_OPS];       // the results [B, n] (null with codes)
  const long long* code;        // int64 codes [B, n], or null
  long long* values;            // sorted codes [B, n]
  long long* order;             // their int64 order [B, n]
  int n;                        // slots of a row that are not padding
  int np2;                      // padded row length
};

// 0xFFFFFFFF where the key tuple a is below b (most significant key first),
// else 0: the borrow of the multi-word difference a - b, one subtract a key
template <int NUM_KEYS>
__device__ __forceinline__ uint32_t below(const uint32_t (&a)[NUM_KEYS],
                                          const uint32_t (&b)[NUM_KEYS]) {
  uint32_t r;
  if constexpr (NUM_KEYS == 1) {
    asm("{\n .reg .u32 t;\n sub.cc.u32 t, %1, %2;\n subc.u32 %0, 0, 0;\n}"
        : "=r"(r) : "r"(a[0]), "r"(b[0]));
  } else if constexpr (NUM_KEYS == 2) {
    asm("{\n .reg .u32 t;\n sub.cc.u32 t, %1, %2;\n subc.cc.u32 t, %3, %4;\n"
        " subc.u32 %0, 0, 0;\n}"
        : "=r"(r) : "r"(a[1]), "r"(b[1]), "r"(a[0]), "r"(b[0]));
  } else {
    static_assert(NUM_KEYS == 3, "one to three keys");
    asm("{\n .reg .u32 t;\n sub.cc.u32 t, %1, %2;\n subc.cc.u32 t, %3, %4;\n"
        " subc.cc.u32 t, %5, %6;\n subc.u32 %0, 0, 0;\n}"
        : "=r"(r) : "r"(a[2]), "r"(b[2]), "r"(a[1]), "r"(b[1]), "r"(a[0]), "r"(b[0]));
  }
  return r;
}

// Stages s_hi..s_lo (register distance 1 << s) on the 16 elements of one
// thread. The run that element 0 lies in ascends where (idx0 & m) == 0;
// j_mask is the bit of the register number j that stands for bit m of an
// element's index, 0 when all 16 lie in one run.
template <int NUM_OPS, int NUM_KEYS>
__device__ __forceinline__ void run_stages(uint32_t (&v)[NUM_OPS][GROUP], int idx0, int m,
                                           int j_mask, int s_hi, int s_lo) {
  const uint32_t up0 = (idx0 & m) ? 0u : ~0u;  // all ones where the run ascends
#pragma unroll
  for (int s = LOG_GROUP - 1; s >= 0; --s) {
    if (s > s_hi || s < s_lo) continue;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) {
      if (j & (1 << s)) continue;
      const int q = j | (1 << s);
      const uint32_t up = (j & j_mask) ? ~up0 : up0;
      uint32_t a[NUM_KEYS], b[NUM_KEYS];
#pragma unroll
      for (int k = 0; k < NUM_KEYS; ++k) {
        a[k] = v[k][j];
        b[k] = v[k][q];
      }
      // exchange when strictly out of order. With every operand a key, equal
      // tuples are the same words, so exchanging them changes nothing and one
      // comparison does
      uint32_t sw;
      if constexpr (NUM_KEYS == NUM_OPS) {
        sw = below<NUM_KEYS>(a, b) ^ up;
      } else {
        sw = (below<NUM_KEYS>(b, a) & up) | (below<NUM_KEYS>(a, b) & ~up);
      }
      const bool swap = sw != 0;
#pragma unroll
      for (int o = 0; o < NUM_OPS; ++o) {
        const uint32_t x = v[o][j], y = v[o][q];
        v[o][j] = swap ? y : x;
        v[o][q] = swap ? x : y;
      }
    }
  }
}

// first index of group g at element distance dl: g with four zero bits put in at dl
__device__ __forceinline__ int group_start(int g, int dl) {
  return ((g & ~(dl - 1)) << LOG_GROUP) | (g & (dl - 1));
}

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> 5) & 31); }

// A block's part between shared memory and the scratch rows in L2: thread t
// moves words t, t + threads, ... (16 of each operand: a block has a thread
// for every 16 elements), all loads issued before the first is used.
template <int NUM_OPS>
__device__ __forceinline__ void part_to_scratch(const Io& io, size_t at, const uint32_t* smem,
                                                int tile) {
#pragma unroll
  for (int it = 0; it < GROUP; ++it) {
    const int j = threadIdx.x + it * blockDim.x;
#pragma unroll
    for (int o = 0; o < NUM_OPS; ++o) __stcg(&io.work[o][at + j], smem[o * tile + swz(j)]);
  }
}

template <int NUM_OPS>
__device__ __forceinline__ void part_from_scratch(const Io& io, size_t at, uint32_t* smem,
                                                  int tile) {
  uint32_t x[NUM_OPS][GROUP];
#pragma unroll
  for (int it = 0; it < GROUP; ++it)
#pragma unroll
    for (int o = 0; o < NUM_OPS; ++o)
      x[o][it] = __ldcg(&io.work[o][at + threadIdx.x + it * blockDim.x]);
#pragma unroll
  for (int it = 0; it < GROUP; ++it)
#pragma unroll
    for (int o = 0; o < NUM_OPS; ++o)
      smem[o * tile + swz(threadIdx.x + it * blockDim.x)] = x[o][it];
}

// A cluster sorts its tile (cluster size x `tile` elements, `tile` a block
// of tile / 16 threads) through phases m_lo..m_hi: all their stages at
// distances below the cluster's tile. first: read the caller's input, else
// scratch; last: write the results, else scratch. TILE: the block's part
// when it is known at compile time (BLOCK_TILE), else 0 and `tile_arg` says
// (rows shorter than BLOCK_TILE).
template <int NUM_OPS, int NUM_KEYS, int TILE>
__global__ void __launch_bounds__(LOCAL_THREADS, 2)
sort_local(Io io, int tile_arg, int m_lo, int m_hi, int first, int last) {
  extern __shared__ uint32_t smem[];  // [NUM_OPS][tile], swizzled
  const int tile = TILE ? TILE : tile_arg;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), blocks = (int)cluster.num_blocks();
  const int base = blockIdx.x * tile;           // of this block's part
  const int cluster_base = base - rank * tile;  // of the cluster's tile
  const int cluster_tile = tile * blocks;
  const size_t row_in = (size_t)blockIdx.y * io.n, row = (size_t)blockIdx.y * io.np2;

  // a launch that starts with a pass over the cluster finds the rows in
  // scratch, where the launch before left them, and loads its part after it
  const bool starts_in_scratch = !first && min(m_lo, cluster_tile) >> 1 >= tile;
  if (starts_in_scratch) {
  } else if (!first) {
    part_from_scratch<NUM_OPS>(io, row + base, smem, tile);
  } else {
    uint32_t x[NUM_OPS][GROUP];
#pragma unroll
    for (int it = 0; it < GROUP; ++it) {
      const int i = base + threadIdx.x + it * blockDim.x;
      const bool real = i < io.n;
      if (io.code) {  // three operands: high half, low half, index
        const unsigned long long c =
            real ? (unsigned long long)io.code[row_in + i] : ~0ull;
        x[0][it] = (uint32_t)(c >> 32);
        x[1 % NUM_OPS][it] = (uint32_t)c;
        x[2 % NUM_OPS][it] = real ? (uint32_t)i : PAD_KEY;
      } else {
#pragma unroll
        for (int o = 0; o < NUM_OPS; ++o)
          x[o][it] = real ? io.in[o][row_in + i] : (o < NUM_KEYS ? PAD_KEY : 0u);
      }
    }
#pragma unroll
    for (int it = 0; it < GROUP; ++it)
#pragma unroll
      for (int o = 0; o < NUM_OPS; ++o)
        smem[o * tile + swz(threadIdx.x + it * blockDim.x)] = x[o][it];
  }
  __syncthreads();

  int m = m_lo;
  if (m_lo == 2) {  // phases 2 .. 16 lie inside a thread's 16 neighbours: one pass
    const int j0 = threadIdx.x << LOG_GROUP;
    uint32_t v[NUM_OPS][GROUP];
#pragma unroll
    for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
      for (int j = 0; j < GROUP; ++j) v[o][j] = smem[o * tile + swz(j0 + j)];
#pragma unroll
    for (int s = 0; s < LOG_GROUP; ++s)
      run_stages<NUM_OPS, NUM_KEYS>(v, base + j0, 2 << s, 2 << s, s, 0);
#pragma unroll
    for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
      for (int j = 0; j < GROUP; ++j) smem[o * tile + swz(j0 + j)] = v[o][j];
    __syncthreads();
    m = 2 * GROUP;
  }
  for (; m <= m_hi; m <<= 1) {
    int d = min(m >> 1, cluster_tile >> 1);  // the largest distance inside the tile
    if (d >= tile) {
      // distances of a block's part and more: one pass over the cluster's
      // tile through the scratch rows (L2; the other blocks' shared memory,
      // read in 4-byte words, moved a quarter of what L2 moves), between two
      // cluster barriers, as sort_global makes it between two launches
      const int stages = 32 - __clz(d / tile);
      if (!(starts_in_scratch && m == m_lo)) {
        part_to_scratch<NUM_OPS>(io, row + base, smem, tile);
        __threadfence();
        cluster.sync();
      }
      {
        const int dl = d >> (LOG_GROUP - 1);
        const int idx0 =
            cluster_base + group_start(rank * (int)blockDim.x + (int)threadIdx.x, dl);
        const size_t i0 = row + idx0;
        uint32_t v[NUM_OPS][GROUP];
#pragma unroll
        for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
          for (int j = 0; j < GROUP; ++j) v[o][j] = __ldcg(&io.work[o][i0 + j * dl]);
        run_stages<NUM_OPS, NUM_KEYS>(v, idx0, m, 0, LOG_GROUP - 1, LOG_GROUP - stages);
#pragma unroll
        for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
          for (int j = 0; j < GROUP; ++j) __stcg(&io.work[o][i0 + j * dl], v[o][j]);
      }
      __threadfence();
      cluster.sync();
      part_from_scratch<NUM_OPS>(io, row + base, smem, tile);
      __syncthreads();
      d = tile >> 1;
    }
    while (d >= 1) {
      // distances of 16 and more: up to four stages from d down, on elements
      // d / 8 apart; below 16: the stages that are left, on 16 neighbours
      int dl, s_hi, s_lo;
      if (d >= GROUP) {
        int stages = 0;  // stages from d down to 16, at most four
        for (int t = d; t >= GROUP && stages < LOG_GROUP; t >>= 1) ++stages;
        dl = d >> (LOG_GROUP - 1);
        s_hi = LOG_GROUP - 1;
        s_lo = LOG_GROUP - stages;
        d >>= stages;
      } else {
        dl = 1;
        s_hi = 31 - __clz(d);
        s_lo = 0;
        d = 0;
      }
      const int j0 = group_start(threadIdx.x, dl);
      uint32_t v[NUM_OPS][GROUP];
      int at[GROUP];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) at[j] = swz(j0 + j * dl);
#pragma unroll
      for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
        for (int j = 0; j < GROUP; ++j) v[o][j] = smem[o * tile + at[j]];
      // a phase's first distance is m / 2 <= 8 dl: bit m lies above the
      // group unless dl == 1 and m < 16
      run_stages<NUM_OPS, NUM_KEYS>(v, base + j0, m, dl == 1 ? m : 0, s_hi, s_lo);
#pragma unroll
      for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
        for (int j = 0; j < GROUP; ++j) smem[o * tile + at[j]] = v[o][j];
      __syncthreads();
    }
  }

  if (!last) {
    part_to_scratch<NUM_OPS>(io, row + base, smem, tile);
    return;
  }
#pragma unroll
  for (int it = 0; it < GROUP; ++it) {
    const int j = threadIdx.x + it * blockDim.x, i = base + j;
    if (i >= io.n) continue;
    if (io.code) {
      io.values[row_in + i] = (long long)(((unsigned long long)smem[swz(j)] << 32) |
                                          smem[(1 % NUM_OPS) * tile + swz(j)]);
      io.order[row_in + i] = (long long)smem[(2 % NUM_OPS) * tile + swz(j)];
    } else {
#pragma unroll
      for (int o = 0; o < NUM_OPS; ++o) io.out[o][row_in + i] = smem[o * tile + swz(j)];
    }
  }
}

// Stages at distances d_hi, d_hi / 2, ... (`stages` of them, at most four) of
// phase m on the scratch rows, one group of 16 elements d_hi / 8 apart a thread.
template <int NUM_OPS, int NUM_KEYS>
__global__ void __launch_bounds__(GLOBAL_THREADS)
sort_global(Io io, int m, int d_hi, int stages) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (io.np2 >> LOG_GROUP)) return;
  const size_t row = (size_t)blockIdx.y * io.np2;
  const int dl = d_hi >> (LOG_GROUP - 1);
  const int i0 = group_start(g, dl);
  uint32_t v[NUM_OPS][GROUP];
#pragma unroll
  for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
    for (int j = 0; j < GROUP; ++j) v[o][j] = io.work[o][row + i0 + j * dl];
  run_stages<NUM_OPS, NUM_KEYS>(v, i0, m, 0, LOG_GROUP - 1, LOG_GROUP - stages);
#pragma unroll
  for (int o = 0; o < NUM_OPS; ++o)
#pragma unroll
    for (int j = 0; j < GROUP; ++j) io.work[o][row + i0 + j * dl] = v[o][j];
}

template <int NUM_OPS, int NUM_KEYS>
int run(const Io& io, int batch, int* launches, cudaStream_t stream) {
  const int np2 = io.np2;
  const int part = np2 < BLOCK_TILE ? np2 : BLOCK_TILE;              // a block's elements
  const int blocks = np2 / part < CLUSTER ? np2 / part : CLUSTER;  // of a cluster
  const int tile = part * blocks;
  const size_t smem = NUM_OPS * part * sizeof(uint32_t);
  void (*const kernel)(Io, int, int, int, int, int) =
      part == BLOCK_TILE ? sort_local<NUM_OPS, NUM_KEYS, BLOCK_TILE>
                         : sort_local<NUM_OPS, NUM_KEYS, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int count = 0;
  auto local = [&](int m_lo, int m_hi) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(np2 / part, batch);
    config.blockDim = dim3(part >> LOG_GROUP);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = blocks;
    cluster.val.clusterDim.y = cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&config, kernel, io, part,
                                             m_lo, m_hi, (int)(count == 0), (int)(m_hi == np2));
    ++count;
    return e != cudaSuccess ? e : cudaGetLastError();
  };

  if ((err = local(2, tile)) != cudaSuccess) return (int)err;
  const dim3 global_grid(((np2 >> LOG_GROUP) + GLOBAL_THREADS - 1) / GLOBAL_THREADS, batch);
  for (long long m = 2LL * tile; m <= np2; m <<= 1) {
    int d = (int)(m >> 1);
    while (d >= tile) {
      int stages = 0;  // stages from d down to the tile, at most four
      for (int t = d; t >= tile && stages < LOG_GROUP; t >>= 1) ++stages;
      sort_global<NUM_OPS, NUM_KEYS><<<global_grid, GLOBAL_THREADS, 0, stream>>>(io, (int)m, d,
                                                                               stages);
      ++count;
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      d >>= stages;
    }
    if ((err = local((int)m, (int)m)) != cudaSuccess) return (int)err;
  }
  if (launches) *launches = count;
  return 0;
}

bool bad_shape(int batch, int n, int np2) {
  return n < 1 || np2 < 1024 || (np2 & (np2 - 1)) != 0 || np2 > (1 << 24) || n > np2 ||
         batch < 1 || batch > 65535;
}

}  // namespace

// Sorts the `batch` rows of length n of num_ops operands (uint32 bit
// patterns, row-major [batch, n]) in0.. by their first num_keys operands
// into out0.. (the inputs are left as they are). work0.. are scratch rows
// [batch, np2], np2 a power of two with 1024 <= np2, n <= np2. Writes the
// number of kernel launches to *launches. Returns 0, a CUDA error code, or -1
// for arguments it does not take (it is instantiated for 2 and 3 operands).
extern "C" int bitonic_sort_rows(const void* in0, const void* in1, const void* in2, void* out0,
                                 void* out1, void* out2, void* work0, void* work1, void* work2,
                                 int num_ops, int num_keys, int batch, int n, int np2,
                                 int* launches, void* stream) {
  if (num_ops < 2 || num_ops > MAX_OPS || num_keys < 1 || num_keys > num_ops) return -1;
  if (bad_shape(batch, n, np2)) return -1;
  const void* ins[MAX_OPS] = {in0, in1, in2};
  void* outs[MAX_OPS] = {out0, out1, out2};
  void* works[MAX_OPS] = {work0, work1, work2};
  Io io = {};
  for (int o = 0; o < num_ops; ++o) {
    if (!ins[o] || !outs[o] || !works[o]) return -1;
    io.in[o] = static_cast<const uint32_t*>(ins[o]);
    io.out[o] = static_cast<uint32_t*>(outs[o]);
    io.work[o] = static_cast<uint32_t*>(works[o]);
  }
  io.n = n;
  io.np2 = np2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SORT_CASE(OPS, KEYS) \
  if (num_ops == OPS && num_keys == KEYS) return run<OPS, KEYS>(io, batch, launches, s);
  SORT_CASE(2, 1) SORT_CASE(2, 2)
  SORT_CASE(3, 1) SORT_CASE(3, 2) SORT_CASE(3, 3)
#undef SORT_CASE
  return -1;
}

// What the sort sites call: the stable ascending sort of the rows of
// non-negative int64 codes [batch, n] into values [batch, n] and their int64
// order [batch, n]. A code travels as (high half, low half, index), three
// keys, so every tuple is distinct and the network's order is the stable
// one. work is scratch of 3 * batch * np2 32-bit words.
extern "C" int bitonic_sort_codes(const void* code, void* values, void* order, void* work,
                                  int batch, int n, int np2, int* launches, void* stream) {
  if (!code || !values || !order || !work || bad_shape(batch, n, np2)) return -1;
  Io io = {};
  for (int o = 0; o < MAX_OPS; ++o)
    io.work[o] = static_cast<uint32_t*>(work) + (size_t)o * batch * np2;
  io.code = static_cast<const long long*>(code);
  io.values = static_cast<long long*>(values);
  io.order = static_cast<long long*>(order);
  io.n = n;
  io.np2 = np2;
  return run<3, 3>(io, batch, launches, static_cast<cudaStream_t>(stream));
}
