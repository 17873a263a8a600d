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
// the row once (about 16 bytes and 9 fp32 operations a point) and ends in a
// row-wide argmax that the next step waits for, so the time is M times the
// latency of one pass plus one reduction, far above both the bytes and the
// operations bound. The design keeps that step short:
//   - a row is a thread block cluster of 8 blocks of 1024 threads, each
//     block a contiguous eighth of the row, its points (x, y, z, least d2)
//     as one float4 each in shared memory (up to 12,992 a block: rows of
//     103,936; points past that stay in a scratch row in device memory, read
//     through L2);
//   - a step: each thread scans its points, a warp shuffle and one pass
//     over the block's 32 warp results give the block's best, the blocks
//     meet at one cluster barrier, and warp 0 of every block reads the 8
//     blocks' results from their shared memory (double-buffered by the
//     step's parity, so one cluster barrier a step suffices) and takes the
//     argmax, then the coordinate of the point taken.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;      // blocks of a row
constexpr int THREADS = 1024;   // threads of a block
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SHARED_POINTS = 12992;  // float4 points of a block in shared memory
constexpr float BIG = 1e10f;
constexpr unsigned FULL = 0xffffffffu;

// (v, i) is better than (bv, bi): larger, or equal at a lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, bv, off);
    const int oi = __shfl_down_sync(FULL, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    fps_rows(const float* __restrict__ coord, const uint8_t* __restrict__ mask,
             const long long* __restrict__ first, long long* __restrict__ out,
             float4* __restrict__ spill, int n, int m, int part, int cap) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / CLUSTER;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  extern __shared__ float4 pts[];
  __shared__ float warp_v[WARPS];
  __shared__ int warp_i[WARPS];
  __shared__ float slot_v[2];
  __shared__ int slot_i[2];
  __shared__ float last_xyz[3];

  const float* c = coord + (size_t)row * n * 3;
  const uint8_t* mk = mask + (size_t)row * n;
  float4* sp = spill + (size_t)row * n;
  const int lo = rank * part;
  const int len = max(0, min(n, lo + part) - lo);
  for (int j = threadIdx.x; j < len; j += THREADS) {
    const int i = lo + j;
    const float4 p = make_float4(c[3 * i], c[3 * i + 1], c[3 * i + 2], mk[i] ? BIG : -BIG);
    if (j < cap) pts[j] = p; else sp[i] = p;
  }
  if (threadIdx.x == 0) {
    const long long f = first[row];
    last_xyz[0] = c[3 * f];
    last_xyz[1] = c[3 * f + 1];
    last_xyz[2] = c[3 * f + 2];
    if (rank == 0) out[(size_t)row * m] = f;
  }
  __syncthreads();

  for (int step = 1; step < m; ++step) {
    const float lx = last_xyz[0], ly = last_xyz[1], lz = last_xyz[2];
    float bv = __int_as_float(0xff800000);  // -inf
    int bi = 0x7fffffff;
    for (int j = threadIdx.x; j < len; j += THREADS) {
      float4 p = j < cap ? pts[j] : sp[lo + j];
      if (p.w >= 0.f) {  // a valid point: its least distance is never negative
        const float dx = __fsub_rn(p.x, lx), dy = __fsub_rn(p.y, ly), dz = __fsub_rn(p.z, lz);
        const float d2 =
            __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
        if (d2 < p.w) {
          p.w = d2;
          if (j < cap) pts[j].w = d2; else sp[lo + j].w = d2;
        }
      }
      if (p.w > bv) {  // ascending j: a tie keeps the lower index
        bv = p.w;
        bi = lo + j;
      }
    }
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    const int parity = step & 1;
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_best(bv, bi);
      if (lane == 0) {
        slot_v[parity] = bv;
        slot_i[parity] = bi;
      }
    }
    cluster.sync();
    if (warp == 0) {
      bv = __int_as_float(0xff800000);
      bi = 0x7fffffff;
      if (lane < CLUSTER) {
        bv = *cluster.map_shared_rank(&slot_v[parity], lane);
        bi = *cluster.map_shared_rank(&slot_i[parity], lane);
      }
      warp_best(bv, bi);
      if (lane == 0) {
        last_xyz[0] = c[3 * (size_t)bi];
        last_xyz[1] = c[3 * (size_t)bi + 1];
        last_xyz[2] = c[3 * (size_t)bi + 2];
        if (rank == 0) out[(size_t)row * m + step] = bi;
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// Farthest point sampling of `batch` rows of n points: coord [batch, n, 3]
// fp32, mask [batch, n] bytes (0 or 1), first [batch] int64 (each row's
// first valid index, n - 1 for a row without one) -> out [batch, m] int64.
// spill is scratch of batch * n float4. Returns 0, a CUDA error code, or -1
// for arguments it does not take.
extern "C" int farthest_point_sampling(const void* coord, const void* mask, const void* first,
                                       void* out, void* spill, int batch, int n, int m,
                                       void* stream) {
  if (!coord || !mask || !first || !out || !spill || batch < 1 || n < 1 || m < 1) return -1;
  const int part = (n + CLUSTER - 1) / CLUSTER;
  const int cap = part < MAX_SHARED_POINTS ? part : MAX_SHARED_POINTS;
  const size_t smem = (size_t)cap * sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(fps_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)(MAX_SHARED_POINTS * sizeof(float4)));
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * CLUSTER);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  config.attrs = &attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, fps_rows, static_cast<const float*>(coord),
                           static_cast<const uint8_t*>(mask),
                           static_cast<const long long*>(first), static_cast<long long*>(out),
                           static_cast<float4*>(spill), n, m, part, cap);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
