// Fixed-radius ball query for Hopper (sm_90a).
//
// Replaces the TPU kernel pointasnl_tpu/ops/pallas/ball_query.py:_ball_kernel
// (wrapper query_ball_point).
//
// Contract: xyz (B, N, 3), new_xyz (B, M, 3) float32, contiguous ->
// idx (B, M, nsample) int32, cnt (B, M) int32. A support point is in the
// ball iff (dx*dx + dy*dy) + dz*dz < r2, strict, each step rounded on its
// own. idx holds the first nsample in-ball points in index order; the slots
// past the last hit repeat the first hit; an empty ball gives 0 everywhere.
// cnt is the number of in-ball points, capped at nsample.
//
// What bounds it on the card: the walk's instructions and their latency, not
// device memory. A query tests the support in index order until its nsample-th
// hit, 8 flops and one compare a point; at the repulsion loss's shapes (1280
// queries over 1280 points, r 0.07, ~15 points a ball) most balls hold fewer
// than nsample points, so most queries test every point, while the bytes that
// must move are the inputs once and nsample + 1 ints a query out.
//
// What the design does about it: a block stages its cloud's points in shared
// memory with cp.async, a float4 a point (a tile of up to kTile points; past
// that the block's warps walk the support tile by tile together), and its 8
// warps take a query each: the walk is latency-bound, so one query a warp,
// the most warps, beats a block that serves more queries and stages less
// (scripts/torch_kernel_turns.py --ball-plans). A warp walks the staged
// points 32 * kPerLane at a round: each lane loads and tests kPerLane points
// with independent loads from shared memory, then one ballot a 32 points, in
// index order, gives the hits; __popc of the hits below a lane gives that
// lane's slot, so the hits land in index order with no sort. The walk ends at
// the first round that fills nsample slots: only the first nsample hits are
// kept and the count is capped there anyway. The TPU kernel's nsample rounds
// of masked min over a (128, N) block exist because Mosaic has no ballot or
// prefix count; they have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 3072;   // points a block stages at once: 48 KB as float4
constexpr int kPerLane = 8;   // points a lane tests a round

__device__ __forceinline__ void copy_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Copy `count` points (3 floats each) from src into the block's tile, one
// float4 a point, and wait for this thread's copies; the caller's barrier
// publishes them.
__device__ __forceinline__ void stage(float4* tile, const float* src, int count) {
  float* dst = reinterpret_cast<float*>(tile);
  for (int e = threadIdx.x; e < 3 * count; e += kThreads) {
    const int point = e / 3;
    copy_async4(dst + 4 * point + (e - 3 * point), src + e);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One round of a query's walk: each lane tests PER_LANE points, 32 apart,
// from staged point t on (bounds checked where kTail), then a ballot a 32
// points, in index order, places the hits.
template <int PER_LANE, bool kTail>
__device__ __forceinline__ void walk_round(const float4* tile, int count, int t, int base,
                                           float qx, float qy, float qz, float r2, int nsample,
                                           int32_t* out, int& found, int& first) {
  const int lane = threadIdx.x & 31;
  bool hit[PER_LANE];
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int i = t + 32 * j + lane;
    hit[j] = false;
    if (!kTail || i < count) {
      const float4 p = tile[i];
      const float dx = qx - p.x, dy = qy - p.y, dz = qz - p.z;
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      hit[j] = d < r2;
    }
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const unsigned mask = __ballot_sync(0xffffffffu, hit[j]);
    if (mask == 0u) continue;
    const int i0 = base + t + 32 * j;
    if (found == 0) first = i0 + __ffs(mask) - 1;
    const int slot = found + __popc(mask & ((1u << lane) - 1u));
    if (hit[j] && slot < nsample) out[slot] = i0 + lane;
    found += __popc(mask);
  }
}

// One query's walk over `count` staged points whose first has index `base`:
// found counts the hits so far (the same in every lane), first is the first
// hit (0 while there is none), out the query's nsample slots. It ends at the
// first round that fills nsample slots.
template <int PER_LANE>
__device__ __forceinline__ void walk(const float4* tile, int count, int base, float qx, float qy,
                                     float qz, float r2, int nsample, int32_t* out, int& found,
                                     int& first) {
  int t = 0;
  for (; t + 32 * PER_LANE <= count && found < nsample; t += 32 * PER_LANE)
    walk_round<PER_LANE, false>(tile, count, t, base, qx, qy, qz, r2, nsample, out, found, first);
  if (t < count && found < nsample)
    walk_round<PER_LANE, true>(tile, count, t, base, qx, qy, qz, r2, nsample, out, found, first);
}

// Pad the slots past the last hit with the first and write the capped count.
__device__ __forceinline__ void finish(int32_t* out, int32_t* cnt, int nsample, int found,
                                       int first) {
  const int lane = threadIdx.x & 31;
  const int c = found < nsample ? found : nsample;
  for (int slot = c + lane; slot < nsample; slot += 32) out[slot] = first;
  if (lane == 0) *cnt = c;
}

template <int PER_LANE>
__global__ void __launch_bounds__(kThreads)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ new_xyz,
                  int32_t* __restrict__ idx_out, int32_t* __restrict__ cnt_out, int n, int m,
                  int nsample, float r2, int queries_a_block) {
  extern __shared__ float4 tile[];  // min(n, kTile) points, x y z and a pad
  const int warp = threadIdx.x >> 5;
  const int blocks_per_cloud = (m + queries_a_block - 1) / queries_a_block;
  const int b = blockIdx.x / blocks_per_cloud;
  const int q0 = (blockIdx.x % blocks_per_cloud) * queries_a_block;
  const int q_end = min(m, q0 + queries_a_block);
  const float* cloud = xyz + (size_t)b * n * 3;
  const size_t row0 = (size_t)b * m;

  if (n <= kTile) {  // the cloud stays in shared memory for all the block's queries
    stage(tile, cloud, n);
    __syncthreads();
    for (int q = q0 + warp; q < q_end; q += kWarps) {
      const float* qp = new_xyz + (row0 + q) * 3;
      int32_t* out = idx_out + (row0 + q) * nsample;
      int found = 0, first = 0;
      walk<PER_LANE>(tile, n, 0, qp[0], qp[1], qp[2], r2, nsample, out, found, first);
      finish(out, cnt_out + row0 + q, nsample, found, first);
    }
    return;
  }
  // Past one tile: the warps take a query each, and all of them walk each
  // staged tile until every query of the batch has its nsample hits.
  for (int qb = q0; qb < q_end; qb += kWarps) {
    const int q = qb + warp;
    const bool mine = q < q_end;
    float qx = 0.0f, qy = 0.0f, qz = 0.0f;
    if (mine) {
      const float* qp = new_xyz + (row0 + q) * 3;
      qx = qp[0], qy = qp[1], qz = qp[2];
    }
    int32_t* out = idx_out + (row0 + (mine ? q : 0)) * nsample;
    int found = 0, first = 0;
    for (int t0 = 0; t0 < n; t0 += kTile) {
      const int count = min(kTile, n - t0);
      stage(tile, cloud + (size_t)t0 * 3, count);  // the last barrier ended the reads
      __syncthreads();
      if (mine) walk<PER_LANE>(tile, count, t0, qx, qy, qz, r2, nsample, out, found, first);
      if (!__syncthreads_or(mine && found < nsample)) break;
    }
    if (mine) finish(out, cnt_out + row0 + q, nsample, found, first);
  }
}

// Launch with per_lane points a lane a round (kPerLane unless built with
// the sweep) and per_warp queries a warp.
int launch(const void* xyz, const void* new_xyz, void* idx, void* cnt, int b, int n, int m,
           int nsample, float r2, int per_lane, int per_warp, cudaStream_t stream) {
  const int queries_a_block = kWarps * per_warp;
  const long long blocks = (long long)b * ((m + queries_a_block - 1) / queries_a_block);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t shared = (size_t)(n < kTile ? n : kTile) * sizeof(float4);
  const dim3 grid((unsigned)blocks);
  const float* x = (const float*)xyz;
  const float* q = (const float*)new_xyz;
  int32_t *i = (int32_t*)idx, *c = (int32_t*)cnt;
  switch (per_lane) {
    case kPerLane:
      ball_query_kernel<kPerLane><<<grid, kThreads, shared, stream>>>(x, q, i, c, n, m, nsample,
                                                                      r2, queries_a_block);
      break;
#ifdef BALL_QUERY_SWEEP
    case 2:
      ball_query_kernel<2><<<grid, kThreads, shared, stream>>>(x, q, i, c, n, m, nsample, r2,
                                                               queries_a_block);
      break;
    case 4:
      ball_query_kernel<4><<<grid, kThreads, shared, stream>>>(x, q, i, c, n, m, nsample, r2,
                                                               queries_a_block);
      break;
#endif
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest N and nsample the kernel takes. B and M are free as long as the
// B * ceil(M / 8) blocks fit the grid's x dimension.
int pasnl_ball_query_max_n() { return 1 << 20; }
int pasnl_ball_query_max_nsample() { return 128; }

int pasnl_ball_query(const void* xyz, const void* new_xyz, void* idx, void* cnt,
                     int b, int n, int m, int nsample, float r2, void* stream) {
  if (b < 1 || n < 1 || m < 1 || nsample < 1) return (int)cudaErrorInvalidValue;
  // One query a warp: the walk is latency-bound, so the most warps win (the
  // plans side by side, scripts/torch_kernel_turns.py --ball-plans).
  return launch(xyz, new_xyz, idx, cnt, b, n, m, nsample, r2, kPerLane, 1,
                (cudaStream_t)stream);
}

#ifdef BALL_QUERY_SWEEP
// The kernel at a given plan, for scripts/torch_kernel_turns.py --plans:
// per_lane 2, 4 or 8 points a lane a round, per_warp queries a warp.
int pasnl_ball_query_planned(const void* xyz, const void* new_xyz, void* idx, void* cnt, int b,
                             int n, int m, int nsample, float r2, int per_lane, int per_warp,
                             void* stream) {
  if (b < 1 || n < 1 || m < 1 || nsample < 1 || per_warp < 1) return (int)cudaErrorInvalidValue;
  return launch(xyz, new_xyz, idx, cnt, b, n, m, nsample, r2, per_lane, per_warp,
                (cudaStream_t)stream);
}
#endif

}  // extern "C"
