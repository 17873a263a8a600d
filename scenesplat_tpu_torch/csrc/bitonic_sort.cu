// K3: bitonic sort of the rows of [B, n] 32-bit operands, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel scenesplat_tpu/ops/pallas_sort.py:_sort_kernel
// (entered through _sort_rows). It computes the same network on the same
// padded rows: n is a power of two, phase m = 2, 4, ..., n merges runs of
// length m with compare-exchange stages at distance d = m/2, ..., 1 between
// element i and its partner i ^ d, ascending where (i & m) == 0. Rows are
// ordered lexicographically over the first num_keys operands compared as
// unsigned 32-bit values, the other operands ride along as payload, and a
// pair is exchanged only when the keys are strictly out of order (ties keep
// their places), so the result equals the TPU kernel's element for element.
//
// The work is bound by bytes: every operand read and written once is the
// least, while the network makes log2(n) (log2(n) + 1) / 2 passes. The TPU
// kernel keeps a whole row as a [R, 128] tile in VMEM and exchanges by
// rolls, one grid step per row. A Hopper block has at most 227 KB of shared
// memory and a batch has few rows, so the network is split by distance
// instead:
//   - sort_local: a block keeps a tile of TILE elements of every operand in
//     shared memory and runs every stage with d < TILE of the phases it is
//     given (all phases with m <= TILE in the first launch, then the tail of
//     one larger phase per launch), with a block barrier between stages;
//   - sort_global: one stage with d >= TILE straight on device memory, one
//     thread per pair; the kernel boundary orders the stages.
// The host function loops over the phases on the caller's stream; a row of
// 2^18 takes 28 launches. Shared-memory bank conflicts at small d and the
// launch count are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;     // elements of one operand per block
constexpr int THREADS = 1024;  // each thread handles TILE / 2 / THREADS pairs a stage
constexpr int MAX_OPS = 4;

struct Rows {
  uint32_t* p[MAX_OPS];
};

template <int NUM_KEYS>
__device__ __forceinline__ bool lex_less(const uint32_t* a, const uint32_t* b) {
#pragma unroll
  for (int k = 0; k < NUM_KEYS; ++k) {
    if (a[k] != b[k]) return a[k] < b[k];
  }
  return false;
}

// The lower index of pair p at distance d: p with a zero bit inserted at d.
__device__ __forceinline__ int pair_low(int p, int d) { return 2 * p - (p & (d - 1)); }

template <int NUM_OPS, int NUM_KEYS>
__global__ void __launch_bounds__(THREADS)
sort_local(Rows rows, int n, int tile, int m_lo, int m_hi) {
  extern __shared__ uint32_t smem[];  // [NUM_OPS][tile]
  const size_t row = (size_t)blockIdx.y * (size_t)n;
  const int base = blockIdx.x * tile;
#pragma unroll
  for (int o = 0; o < NUM_OPS; ++o)
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      smem[o * tile + j] = rows.p[o][row + base + j];
  __syncthreads();

  const int half = tile >> 1;
  for (int m = m_lo; m <= m_hi; m <<= 1) {
    for (int d = min(m >> 1, half); d >= 1; d >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int j = pair_low(p, d);
        const int q = j + d;
        const bool up = ((base + j) & m) == 0;
        uint32_t a[NUM_KEYS], b[NUM_KEYS];
#pragma unroll
        for (int k = 0; k < NUM_KEYS; ++k) {
          a[k] = smem[k * tile + j];
          b[k] = smem[k * tile + q];
        }
        const bool swap = up ? lex_less<NUM_KEYS>(b, a) : lex_less<NUM_KEYS>(a, b);
        if (swap) {
#pragma unroll
          for (int k = 0; k < NUM_KEYS; ++k) {
            smem[k * tile + j] = b[k];
            smem[k * tile + q] = a[k];
          }
#pragma unroll
          for (int o = NUM_KEYS; o < NUM_OPS; ++o) {
            const uint32_t t = smem[o * tile + j];
            smem[o * tile + j] = smem[o * tile + q];
            smem[o * tile + q] = t;
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int o = 0; o < NUM_OPS; ++o)
    for (int j = threadIdx.x; j < tile; j += blockDim.x)
      rows.p[o][row + base + j] = smem[o * tile + j];
}

template <int NUM_OPS, int NUM_KEYS>
__global__ void sort_global(Rows rows, int n, int m, int d) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;  // pair within the row
  if (p >= (n >> 1)) return;
  const size_t row = (size_t)blockIdx.y * (size_t)n;
  const int i = pair_low(p, d);
  const bool up = (i & m) == 0;
  const size_t lo = row + i, hi = lo + d;
  uint32_t a[NUM_KEYS], b[NUM_KEYS];
#pragma unroll
  for (int k = 0; k < NUM_KEYS; ++k) {
    a[k] = rows.p[k][lo];
    b[k] = rows.p[k][hi];
  }
  const bool swap = up ? lex_less<NUM_KEYS>(b, a) : lex_less<NUM_KEYS>(a, b);
  if (!swap) return;
#pragma unroll
  for (int k = 0; k < NUM_KEYS; ++k) {
    rows.p[k][lo] = b[k];
    rows.p[k][hi] = a[k];
  }
#pragma unroll
  for (int o = NUM_KEYS; o < NUM_OPS; ++o) {
    const uint32_t t = rows.p[o][lo];
    rows.p[o][lo] = rows.p[o][hi];
    rows.p[o][hi] = t;
  }
}

template <int NUM_OPS, int NUM_KEYS>
int run(Rows rows, int batch, int n, int* launches, cudaStream_t stream) {
  const int tile = n < TILE ? n : TILE;
  const int threads = (tile >> 1) < THREADS ? (tile >> 1) : THREADS;
  const size_t smem = (size_t)NUM_OPS * tile * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(sort_local<NUM_OPS, NUM_KEYS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 local_grid(n / tile, batch);
  const int pairs = n >> 1;
  const dim3 global_grid((pairs + 255) / 256, batch);
  int count = 0;

  sort_local<NUM_OPS, NUM_KEYS><<<local_grid, threads, smem, stream>>>(rows, n, tile, 2, tile);
  ++count;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (long long m = 2LL * tile; m <= n; m <<= 1) {
    for (int d = (int)(m >> 1); d >= tile; d >>= 1) {
      sort_global<NUM_OPS, NUM_KEYS><<<global_grid, 256, 0, stream>>>(rows, n, (int)m, d);
      ++count;
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sort_local<NUM_OPS, NUM_KEYS><<<local_grid, threads, smem, stream>>>(rows, n, tile, (int)m,
                                                                      (int)m);
    ++count;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (launches) *launches = count;
  return 0;
}

}  // namespace

// Sorts, in place, the `batch` rows of length n (a power of two >= 2) of
// num_ops operands (uint32 bit patterns, row-major [batch, n]) by their
// first num_keys operands. Writes the number of kernel launches to
// *launches. Returns 0, a CUDA error code, or -1 for arguments it does not
// take (it is instantiated for 2 and 3 operands).
extern "C" int bitonic_sort_rows(void* p0, void* p1, void* p2, void* p3, int num_ops,
                                 int num_keys, int batch, int n, int* launches,
                                 void* stream) {
  if (num_ops < 1 || num_ops > MAX_OPS || num_keys < 1 || num_keys > num_ops) return -1;
  if (n < 2 || (n & (n - 1)) != 0 || n > (1 << 24) || batch < 1 || batch > 65535) return -1;
  Rows rows;
  void* ptrs[MAX_OPS] = {p0, p1, p2, p3};
  for (int o = 0; o < MAX_OPS; ++o) rows.p[o] = static_cast<uint32_t*>(ptrs[o]);
  for (int o = 0; o < num_ops; ++o)
    if (rows.p[o] == nullptr) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SORT_CASE(OPS, KEYS) \
  if (num_ops == OPS && num_keys == KEYS) return run<OPS, KEYS>(rows, batch, n, launches, s);
  // (3, 3) is what the sort sites use (a code's two halves and the index);
  // the others are the 2- and 3-operand forms the checks cover
  SORT_CASE(2, 1) SORT_CASE(2, 2)
  SORT_CASE(3, 1) SORT_CASE(3, 2) SORT_CASE(3, 3)
#undef SORT_CASE
  return -1;
}
