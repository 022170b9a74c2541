// Exact k-nearest-neighbour search over a support of up to 12288 points, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/knn.py:_knn_kernel_resident
// (reached through _knn_scan from knn_point).
//
// Contract: support (B, N, 3), query (B, M, 3) float32, contiguous ->
// dist2 (B, M, k) float32 ascending and clamped at >= 0, idx (B, M, k) int32.
// Distances are direct differences, (dx*dx + dy*dy) + dz*dz, each step
// rounded on its own. Equal distances go to the lower support index, so a
// query that lies in the support is its own first neighbour. When k > N the
// last valid neighbour fills the remaining slots (ops/geometry.py:167-170).
//
// What bounds it on the card: the pairs. Every query tests every support
// point (8 rounded adds and multiplies and a compare), 419 M pairs at the
// seg stem (B4, 10240 x 10240), while device memory is read once and each
// query writes k * 8 bytes. Selecting the k least costs a query about
// k * (1 + ln(N / k)) insertions when the support comes in no spatial order.
//
// What the design does about it: selection in registers
// (csrc/knn_select.cuh), so a query's selection costs a ballot per 32
// candidates and its insertions. A warp takes G
// queries (4, or 1 when the search has too few queries to fill the card: the
// wrapper's choice), held in registers with their lists; each lane
// loads one candidate from shared memory and tests it against all G, so one
// load serves G pairs. The lists are the warp's (a query's top-k across the
// lanes) for k > 4; for k <= 4 (three_nn) each lane keeps its own and the
// warp merges them at the end, since there nearly every offer that passes is
// an insertion, and a warp-wide insertion costs the whole warp. A block of 8
// warps streams the cloud's support through shared memory in tiles of 1024
// points (12 KB), double-buffered with cp.async so that the next tile
// arrives while this one is tested. Shared memory does not grow with N; what
// limits the blocks an SM is the registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using namespace knn_select;

constexpr int kWarps = 8;
constexpr int kTile = 1024;  // support points a stage (x, y, z: 12 KB)
constexpr int kMaxN = 12288;  // the route's cap (knn.py:RESIDENT_MAX_N)
constexpr int kMaxK = 128;

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Start copying `count` floats from src to dst, in one cp.async group.
__device__ __forceinline__ void stage(float* dst, const float* src, int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) copy_async4(dst + j, src + j);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Sel: List<E>, the warp's lists, or LaneList<K> (k = K <= kLaneK), each
// lane's own, merged at the end.
template <class Sel, int G>
__global__ void __launch_bounds__(kWarps * 32) knn_kernel(
    const float* __restrict__ support, const float* __restrict__ query,
    float* __restrict__ dist_out, int32_t* __restrict__ idx_out, int n, int m, int k) {
  __shared__ __align__(16) float tile[2][kTile * 3];  // x, y, z a point, as in device memory
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * G;

  float qx[G], qy[G], qz[G];
  Sel list[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const bool active = q0 + g < m;
    const float* q = query + ((size_t)b * m + (active ? q0 + g : 0)) * 3;
    qx[g] = q[0];
    qy[g] = q[1];
    qz[g] = q[2];
    init(list[g], active);
  }

  const float* s = support + (size_t)b * n * 3;
  const int n_tiles = (n + kTile - 1) / kTile;
  stage(tile[0], s, min(kTile, n) * 3);
  for (int t = 0; t < n_tiles; ++t) {
    const int base = t * kTile;
    if (t + 1 < n_tiles) {
      stage(tile[(t + 1) & 1], s + (size_t)(base + kTile) * 3, min(kTile, n - base - kTile) * 3);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // tile t is in for every thread
    if (q0 < m) {
      const float* p = tile[t & 1];
      const int cnt = min(kTile, n - base);
      for (int j0 = 0; j0 < cnt; j0 += 32) {
        const int j = j0 + lane;
        const bool valid = j < cnt;
        const int jj = valid ? j : 0;
        const float px = p[3 * jj], py = p[3 * jj + 1], pz = p[3 * jj + 2];
#pragma unroll
        for (int g = 0; g < G; ++g)
          offer(list[g], sqdist(qx[g], qy[g], qz[g], px, py, pz), base + j, valid, k, lane);
      }
    }
    __syncthreads();  // every warp is done with tile t before it is restaged
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (q0 + g < m) {
      const size_t row = (size_t)b * m + q0 + g;
      store(list[g], dist_out + row * k, idx_out + row * k, k, n, lane);
    }
  }
}

template <class Sel>
cudaError_t launch(int group, dim3 grid, cudaStream_t stream, const float* support,
                   const float* query, float* dist, int32_t* idx, int n, int m, int k) {
  switch (group) {
    case 1: knn_kernel<Sel, 1><<<grid, kWarps * 32, 0, stream>>>(support, query, dist, idx, n, m, k); break;
    case 4: knn_kernel<Sel, 4><<<grid, kWarps * 32, 0, stream>>>(support, query, dist, idx, n, m, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N the kernel takes (knn.py:RESIDENT_MAX_N) and largest k.
int pasnl_knn_max_n() { return kMaxN; }
int pasnl_knn_max_k() { return kMaxK; }

// `group`: queries a warp, 1 or 4 (ops/cuda/knn.py:queries_a_warp).
int pasnl_knn(const void* support, const void* query, void* dist, void* idx, int b, int n,
              int m, int k, int group, void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || k > kMaxK || m < 1 || b < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int per_block = kWarps * group;
  const dim3 grid((m + per_block - 1) / per_block, b);
  const float* s = (const float*)support;
  const float* q = (const float*)query;
  cudaStream_t st = (cudaStream_t)stream;
  float* d = (float*)dist;
  int32_t* i = (int32_t*)idx;
  switch (k) {
    case 1: return (int)launch<LaneList<1>>(group, grid, st, s, q, d, i, n, m, k);
    case 2: return (int)launch<LaneList<2>>(group, grid, st, s, q, d, i, n, m, k);
    case 3: return (int)launch<LaneList<3>>(group, grid, st, s, q, d, i, n, m, k);
    case 4: return (int)launch<LaneList<4>>(group, grid, st, s, q, d, i, n, m, k);
  }
  switch (entries_for(k)) {
    case 1: return (int)launch<List<1>>(group, grid, st, s, q, d, i, n, m, k);
    case 2: return (int)launch<List<2>>(group, grid, st, s, q, d, i, n, m, k);
    default: return (int)launch<List<4>>(group, grid, st, s, q, d, i, n, m, k);
  }
}

}  // extern "C"
